"""Token-budget batching, index ordering and padded collation; port of
``neuralsvb_tpu/data/batching.py`` (reference: utils/__init__.py:152-217).

``batch_by_size`` fills a batch over the size-sorted indices until
``max_tokens`` (batch size x longest item) or ``max_sentences``. The
collater pads each batch's time axis up to a multiple of ``bucket_quant``
frames, as the JAX package does, so a batch of the port and of the
reference carry the same padding.
"""

from __future__ import annotations

import sys
from typing import List, Sequence

import numpy as np


def batch_by_size(indices, num_tokens_fn, max_tokens=None, max_sentences=None,
                  required_batch_size_multiple: int = 1) -> List[List[int]]:
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize
    mult = required_batch_size_multiple
    sample_len, sample_lens, batch, batches = 0, [], [], []
    for idx in indices:
        idx = int(idx)
        n = num_tokens_fn(idx)
        sample_lens.append(n)
        sample_len = max(sample_len, n)
        if sample_len > max_tokens:
            raise ValueError(f"sample at {idx} of size {sample_len} > max_tokens "
                             f"{max_tokens}")
        num_tokens = (len(batch) + 1) * sample_len
        if batch and (len(batch) == max_sentences or num_tokens > max_tokens):
            mod_len = max(mult * (len(batch) // mult), len(batch) % mult)
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_lens = sample_lens[mod_len:]
            sample_len = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


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
