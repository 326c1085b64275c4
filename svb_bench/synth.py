"""Inputs made from the seed: a2p requests (takes and phrases) and the
vocoder's training split. Every seed gets the same set of lengths, drawn
in its own order; the seed draws the content (melody, mels, alignment,
speaker embedding) and the order."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

SR, HOP = 22050, 128
F0_BIN, F0_MAX, F0_MIN = 256, 1100.0, 50.0
F0_MEL_MIN = 1127 * math.log(1 + F0_MIN / 700)
F0_MEL_MAX = 1127 * math.log(1 + F0_MAX / 700)


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Hz -> pitch bins 1..255 (0 Hz is bin 1), the binarizer's quantisation."""
    f0_mel = 1127 * np.log(1 + f0 / 700)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = np.clip(f0_mel, 1.0, F0_BIN - 1)
    return np.rint(f0_mel).astype(np.int64)


def frames(seconds: float, multiple: int = 4) -> int:
    return max(multiple, int(round(seconds * SR / HOP / multiple)) * multiple)


def stratified_log_uniform(lo: float, hi: float, n: int) -> np.ndarray:
    """The ``n`` quantiles (i + 1/2) / n of the log-uniform law on [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    return lo * (hi / lo) ** u


def melody(rng: np.random.RandomState, n: int) -> np.ndarray:
    """A sung line of ``n`` frames in Hz: notes of 0.15-0.8 s between C3 and
    C5 with 5.5 Hz vibrato, and breaths (0 Hz) of 0.2-0.5 s every 2-5 s."""
    f0 = np.zeros(n)
    t = 0
    fps = SR / HOP
    next_breath = int(rng.uniform(2, 5) * fps)
    while t < n:
        if t >= next_breath:
            t += int(rng.uniform(0.2, 0.5) * fps)
            next_breath = t + int(rng.uniform(2, 5) * fps)
            continue
        d = int(rng.uniform(0.15, 0.8) * fps)
        midi = rng.uniform(48, 72)
        k = np.arange(min(d, n - t))
        f0[t:t + len(k)] = 440 * 2 ** ((midi - 69 + 0.3 * np.sin(2 * np.pi * 5.5 * k / fps)) / 12)
        t += d
    return f0


def smooth_mel(rng: np.random.RandomState, n: int, num_mels: int = 80) -> np.ndarray:
    """A log10-mel [n, num_mels] in the recipes' range (-6 .. 1.5): a
    spectral tilt with slow random movement."""
    knots = rng.standard_normal((n // 16 + 2, num_mels)).astype(np.float32)
    x = np.arange(n) / 16.0
    i = np.floor(x).astype(int)
    w = (x - i)[:, None].astype(np.float32)
    walk = knots[i] * (1 - w) + knots[i + 1] * w
    tilt = np.linspace(-1.0, -4.5, num_mels, dtype=np.float32)[None]
    return np.clip(tilt + 0.8 * walk, -6.0, 1.5).astype(np.float32)


def alignment(rng: np.random.RandomState, t_p: int, t_a: int) -> np.ndarray:
    """A monotone map of the ``t_p`` professional frames onto amateur frames
    0..t_a-1, with slow tempo changes."""
    rate = np.exp(0.2 * np.cumsum(rng.standard_normal(t_p)) / math.sqrt(t_p))
    pos = np.cumsum(rate)
    pos = (pos - pos[0]) / max(pos[-1] - pos[0], 1e-9) * (t_a - 1)
    return np.clip(np.rint(pos), 0, t_a - 1).astype(np.int64)


def a2p_deck(traffic: dict, seed: int) -> List[Dict]:
    """The traffic's deck of requests: ``deck`` professional lengths at the
    stratified quantiles of the log-uniform law over ``prof_seconds``, each
    paired with one of ``deck`` stratified amateur factors over
    ``amateur_factor`` (the pairing drawn from the seed), the amateur side
    capped at ``max_frames``. Lengths are multiples of 4 frames (the
    FVAE's latent stride)."""
    rng = np.random.RandomState(seed % 2 ** 32)
    n = int(traffic["deck"])
    secs = stratified_log_uniform(*traffic["prof_seconds"], n)
    lo, hi = traffic["amateur_factor"]
    factors = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    rng.shuffle(factors)
    deck = []
    for i in range(n):
        t_p = frames(secs[i])
        t_a = min(frames(secs[i] * factors[i]), int(traffic["max_frames"]) // 4 * 4)
        f0_p = melody(rng, t_p)
        align = alignment(rng, t_p, t_a)
        f0_a = np.zeros(t_a)
        f0_a[align] = f0_p * 2 ** (rng.uniform(-0.5, 0.5) / 12)
        emb = rng.standard_normal(256).astype(np.float32)
        deck.append({
            "mels": smooth_mel(rng, t_a)[None],
            "prof_mels": smooth_mel(rng, t_p)[None],
            "pitch": f0_to_coarse(f0_a)[None],
            "prof_pitch": f0_to_coarse(f0_p)[None],
            "a2p_f0_alignment": align[None],
            "multi_spk_emb": (emb / np.linalg.norm(emb))[None, None],
            "prof_f0": f0_p.astype(np.float32),
            "t_a": t_a, "t_p": t_p,
        })
    return deck


def write_vocoder_split(data_dir: str, traffic: dict, seed: int, prefix: str = "train") -> list:
    """``<data_dir>/<prefix>`` for ``VocoderDataset``: ``items`` sung clips
    of ``item_seconds`` (stratified), each a wav of harmonics on its
    melody plus breath noise, its log-mel and F0. Returns the items."""
    from neuralsvb_torch.data.indexed_dataset import IndexedDatasetBuilder
    import os
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed % 2 ** 32)
    n = int(traffic["items"])
    secs = np.linspace(*traffic["item_seconds"], n)
    rng.shuffle(secs)
    builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    items = []
    for s in secs:
        t = frames(s, 1)
        f0 = melody(rng, t).astype(np.float32)
        f0_s = np.repeat(f0, HOP)
        phase = 2 * np.pi * np.cumsum(f0_s) / SR
        wav = sum(np.sin(h * phase) / h for h in range(1, 6)) * 0.1 * (f0_s > 0)
        wav = (wav + 0.01 * rng.standard_normal(t * HOP)).astype(np.float32)
        items.append({"wav": wav, "mel": smooth_mel(rng, t), "f0": f0})
        builder.add_item(items[-1])
    builder.finalize()
    return items


def write_svb_split(data_dir: str, traffic: dict, seed: int, prefix: str = "train") -> list:
    """``<data_dir>/<prefix>`` for ``MultiSpkEmbDataset``: a deck of paired
    takes (``a2p_deck`` of the traffic's parameters) with their F0, pitch,
    alignment and four speaker-embedding columns, the lengths file and the
    F0 statistics. Returns the items."""
    from neuralsvb_torch.data.indexed_dataset import IndexedDatasetBuilder
    import os
    os.makedirs(data_dir, exist_ok=True)
    deck = a2p_deck(traffic, seed)
    rng = np.random.RandomState((seed + 1) % 2 ** 32)
    builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    items, voiced = [], []
    for i, r in enumerate(deck):
        f0_p = r["prof_f0"].astype(np.float64)
        f0_a = np.zeros(r["t_a"])
        f0_a[r["a2p_f0_alignment"][0]] = f0_p
        emb = rng.standard_normal((4, 256)).astype(np.float32)
        item = {"item_name": f"Bench#singing#take{i}_Amateur_{i}",
                "mel": r["mels"][0], "f0": f0_a, "pitch": r["pitch"][0],
                "prof_mel": r["prof_mels"][0], "prof_f0": f0_p, "prof_pitch": r["prof_pitch"][0],
                "a2p_f0_alignment": r["a2p_f0_alignment"][0],
                "multi_spk_emb": emb / np.linalg.norm(emb, axis=1, keepdims=True)}
        builder.add_item(item)
        items.append(item)
        voiced += [f0_a[f0_a > 0], f0_p[f0_p > 0]]
    builder.finalize()
    np.save(f"{data_dir}/{prefix}_lengths.npy", np.asarray([len(it["mel"]) for it in items]))
    v = np.concatenate(voiced)
    np.save(f"{data_dir}/train_f0s_mean_std.npy", np.asarray([v.mean(), v.std()]))
    return items
