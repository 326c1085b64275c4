"""A synthetic packed test split in the reference format, for smoke runs
and tests of the inference path where no binarized PopBuTFy data exists.

Each item is an amateur/professional pair with the keys
``MultiSpkEmbDataset`` reads: log-mel-like spectrograms, f0 (Hz, with an
unvoiced stretch) and its coarse pitch, a monotonic professional->amateur
frame alignment and a table of speaker embeddings. Everything comes from
``numpy.random.RandomState(seed)``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..ops.pitch_utils import f0_to_coarse
from .indexed_dataset import IndexedDatasetBuilder


def _side(rng, T: int, num_mels: int):
    t = np.arange(T)
    f0 = 220.0 * 2 ** (rng.uniform(-0.5, 0.5)) * (1 + 0.02 * np.sin(2 * np.pi * t / 40))
    gap = rng.randint(T // 4, T // 2)
    f0[gap: gap + T // 10] = 0.0
    bins = np.arange(num_mels)[None, :]
    mel = (-4.0 + 1.5 * np.cos(bins / 6.0 + t[:, None] / 25.0)
           + 0.3 * rng.randn(T, num_mels))
    return mel.astype(np.float32), f0


def write_synthetic_split(data_dir: str, frames: Sequence[int], prefix: str = "test",
                          seed: int = 1234, num_mels: int = 80,
                          n_spk_emb: int = 4, spk_emb_dim: int = 256) -> None:
    """Write ``<data_dir>/<prefix>.{data,idx}``, ``<prefix>_lengths.npy`` and
    ``train_f0s_mean_std.npy``; item i has ``frames[i]`` amateur frames and a
    professional side about 10% longer."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    lengths, voiced = [], []
    for i, T_a in enumerate(frames):
        T_p = int(T_a * rng.uniform(1.05, 1.15))
        mel, f0 = _side(rng, T_a, num_mels)
        prof_mel, prof_f0 = _side(rng, T_p, num_mels)
        align = np.round(np.linspace(0, T_a - 1, T_p)).astype(np.int64)
        builder.add_item({
            "item_name": f"Synth#singing#song{i}_Amateur_{i}",
            "mel": mel, "f0": f0, "pitch": f0_to_coarse(f0),
            "prof_mel": prof_mel, "prof_f0": prof_f0,
            "prof_pitch": f0_to_coarse(prof_f0),
            "a2p_f0_alignment": align,
            "multi_spk_emb": rng.randn(n_spk_emb, spk_emb_dim).astype(np.float32),
        })
        lengths.append(T_a)
        voiced += [f0[f0 > 0], prof_f0[prof_f0 > 0]]
    builder.finalize()
    np.save(f"{data_dir}/{prefix}_lengths.npy", np.asarray(lengths))
    v = np.concatenate(voiced)
    np.save(f"{data_dir}/train_f0s_mean_std.npy", np.asarray([v.mean(), v.std()]))
