"""The 24 kHz training split of the ``bigvgan_v2_24k`` configuration, made
from the seed: ``items`` sung clips of ``item_seconds`` (evenly spaced,
in the seed's order), each a wav of five harmonics on a sung melody plus
breath noise at 24 kHz, its 100-bin log-mel rows (hop 256) and its F0.
Every seed gets the same set of lengths; the seed draws the content and
the order."""

from __future__ import annotations

import os

import numpy as np

from .synth import smooth_mel

SR, HOP, N_MELS = 24000, 256, 100


def melody(rng: np.random.RandomState, n: int, fps: float = SR / HOP) -> np.ndarray:
    """A sung line of ``n`` frames in Hz: notes of 0.15-0.8 s between C3 and
    C5 with 5.5 Hz vibrato, and breaths (0 Hz) of 0.2-0.5 s every 2-5 s."""
    f0 = np.zeros(n)
    t = 0
    next_breath = int(rng.uniform(2, 5) * fps)
    while t < n:
        if t >= next_breath:
            t += int(rng.uniform(0.2, 0.5) * fps)
            next_breath = t + int(rng.uniform(2, 5) * fps)
            continue
        d = max(1, int(rng.uniform(0.15, 0.8) * fps))
        midi = rng.uniform(48, 72)
        k = np.arange(min(d, n - t))
        f0[t:t + len(k)] = 440 * 2 ** ((midi - 69 + 0.3 * np.sin(2 * np.pi * 5.5 * k / fps)) / 12)
        t += d
    return f0


def write_bigvgan_split(data_dir: str, traffic: dict, seed: int, prefix: str = "train") -> list:
    """``<data_dir>/<prefix>`` for ``VocoderDataset`` (keys ``wav``, ``mel``,
    ``f0``). Returns the items."""
    from neuralsvb_torch.data.indexed_dataset import IndexedDatasetBuilder
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed % 2 ** 32)
    secs = np.linspace(*traffic["item_seconds"], int(traffic["items"]))
    rng.shuffle(secs)
    builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    items = []
    for s in secs:
        t = max(1, int(round(s * SR / HOP)))
        f0 = melody(rng, t).astype(np.float32)
        f0_s = np.repeat(f0, HOP)
        phase = 2 * np.pi * np.cumsum(f0_s) / SR
        wav = sum(np.sin(h * phase) / h for h in range(1, 6)) * 0.1 * (f0_s > 0)
        wav = (wav + 0.01 * rng.standard_normal(t * HOP)).astype(np.float32)
        items.append({"wav": wav, "mel": smooth_mel(rng, t, N_MELS), "f0": f0})
        builder.add_item(items[-1])
    builder.finalize()
    return items
