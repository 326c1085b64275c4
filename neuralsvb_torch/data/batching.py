"""Index ordering and padded collation for the test split; port of the
parts of ``neuralsvb_tpu/data/batching.py`` that inference uses.

The collater pads each batch's time axis up to a multiple of
``bucket_quant`` frames, as the JAX package does, so a batch of the port
and of the reference carry the same padding.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def ordered_indices(sizes, shuffle: bool, sort_by_len: bool = True,
                    rng: np.random.RandomState | None = None) -> np.ndarray:
    """reference: tasks/base_task.py:83-92."""
    rng = rng or np.random
    if shuffle:
        indices = rng.permutation(len(sizes))
        if sort_by_len:
            indices = indices[np.argsort(np.array(sizes)[indices], kind="mergesort")]
    else:
        indices = np.arange(len(sizes))
    return indices


def round_up(x: int, quant: int) -> int:
    return ((x + quant - 1) // quant) * quant


def collate_1d(values: Sequence[np.ndarray], pad_value=0,
               bucket_quant: int = 1) -> np.ndarray:
    size = round_up(max(len(v) for v in values), bucket_quant)
    out = np.full((len(values), size), pad_value, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        out[i, : len(v)] = v
    return out


def collate_2d(values: Sequence[np.ndarray], pad_value=0.0,
               bucket_quant: int = 1) -> np.ndarray:
    size = round_up(max(len(v) for v in values), bucket_quant)
    first = np.asarray(values[0])
    out = np.full((len(values), size, first.shape[1]), pad_value, dtype=first.dtype)
    for i, v in enumerate(values):
        out[i, : len(v)] = v
    return out
