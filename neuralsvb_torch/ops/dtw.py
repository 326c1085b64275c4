"""The shape-aware DTW aligners of the binarizer; port of the SADTW/EHSADTW
path of ``neuralsvb_tpu/ops/dtw.py`` (reference:
modules/voice_conversion/dtw/shape_aware_dtw.py:18-115,
enhance_sadtw.py:18-114, align.py:8-37).

- ``f0_shape_histogram``: per-frame histogram of local f0 slopes (numpy,
  host; vectorized over time as in the JAX package).
- the chi-square cost between two histogram sequences runs on the
  aligner's ``device`` through ``ops/chi2.py`` (the CUDA kernel on the card),
  computed as ``chi2_dist(target, source)``: directly the ``[T, S]`` matrix
  the DP reads. The function is symmetric term by term, so this is the
  ``[S, T]`` cost transposed bit for bit, with no transpose on the device;
- ``align_from_distances``: the DTW DP and backtrace in the host C++ kernel
  (``native.py``). A cost on the card reaches the host through pinned
  memory.

The Naive/ZMNaive/NNaive/LoN aligners and ``NInterpo`` are not on the
binarizer's path and are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import dtw_align_native
from .chi2 import chi2_dist

_TAN30 = 0.57735
_TAN60 = 1.73205

_SADTW_WINDOWS = {
    128: [[-128, -64], [-64, -32], [-32, -16], [-16, -8], [-8, 0],
          [0, 8], [8, 16], [16, 32], [32, 64], [64, 128]],
    64: [[-64, -32], [-32, -16], [-16, -8], [-8, 0],
         [0, 8], [8, 16], [16, 32], [32, 64]],
    32: [[-32, -16], [-16, -8], [-8, 0], [0, 8], [8, 16], [16, 32]],
}
_EHSADTW_WINDOWS = {
    128: _SADTW_WINDOWS[128],
    64: [[-64, -48], [-48, -32], [-32, -16], [-16, 0],
         [0, 16], [16, 32], [32, 48], [48, 64]],
    32: _SADTW_WINDOWS[32],
}
# EHSADTW down-weights slopes from far windows (enhance_sadtw.py:49-54)
_EH_WEIGHTS = {0: 0.5, 7: 0.5, 1: 0.75, 6: 0.75, 2: 0.9, 5: 0.9}

N_REGIONS = 6


def align_from_distances(distance_matrix) -> np.ndarray:
    """For each row of ``distance_matrix`` (array or tensor) return the
    matched column index under the monotonic DTW path
    (reference: dtw/align.py:19-37)."""
    return dtw_align_native(_to_host(distance_matrix))[0].astype(np.int64)


def _to_host(x) -> np.ndarray:
    """``x`` as a float32 numpy array for the host DP. A CUDA tensor is
    copied into pinned memory (PyTorch's caching host allocator reuses the
    buffer across pairs) without blocking, then its stream is synchronized
    before the DP reads it; anything else takes the plain path."""
    t = torch.as_tensor(x, dtype=torch.float32)
    if t.device.type != "cuda":
        return t.cpu().numpy()
    host = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def f0_shape_histogram(f0: np.ndarray, max_window: int = 64, scale_factor: float = 1.0,
                       enhanced: bool = False, normalize: bool = True) -> np.ndarray:
    """Per-frame histogram of local f0 slopes -> [T, n_windows * 6] float64."""
    f0 = np.asarray(f0, dtype=np.float64).reshape(-1)
    T = len(f0)
    windows = (_EHSADTW_WINDOWS if enhanced else _SADTW_WINDOWS)[max_window]
    hist = np.zeros((T, len(windows) * N_REGIONS), dtype=np.float64)

    for w_idx, (wl, wr) in enumerate(windows):
        li = int(wl * scale_factor)
        ri = int(wr * scale_factor)
        if li == 0:
            li = 1
        weight = _EH_WEIGHTS.get(w_idx, 1.0) if enhanced else 1.0
        for d in range(li, ri):
            if d == 0:
                continue
            ts = np.arange(0, T - d) if d > 0 else np.arange(-d, T)
            if len(ts) == 0:
                continue
            diff = f0[ts + d] - f0[ts]
            tan = np.abs(diff / d) * weight
            pos = diff >= 0
            region = np.where(tan < _TAN30, np.where(pos, 2, 3),
                              np.where(tan < _TAN60, np.where(pos, 1, 4),
                                       np.where(pos, 0, 5)))
            np.add.at(hist, (ts, w_idx * N_REGIONS + region), 1.0)

    if normalize:
        totals = hist.sum(1, keepdims=True)
        hist = np.divide(hist, totals, out=np.zeros_like(hist), where=totals > 0)
    return hist


def _dtw_from_cost(cost_ts: torch.Tensor, inputs):
    """cost_ts: [T, S]. Returns (inputs gathered to the T timeline, alignment)."""
    alignment = align_from_distances(cost_ts)
    return np.asarray(inputs)[alignment], alignment


def _chi2_cost(sh: np.ndarray, th: np.ndarray, device: torch.device) -> torch.Tensor:
    """The [T, S] cost of source histograms ``sh`` [S, M] and target
    histograms ``th`` [T, M]: ``chi2_dist(sh, th).T`` bit for bit, with no
    transpose. Histograms go to ``device`` as float32 (the precision of the
    JAX package's cost); the cost stays there."""
    return chi2_dist(torch.as_tensor(th, dtype=torch.float32, device=device),
                     torch.as_tensor(sh, dtype=torch.float32, device=device))


def SADTW(src, tgt, inputs, device: torch.device):
    """Shape-aware DTW (reference: shape_aware_dtw.py:108-115)."""
    sh = f0_shape_histogram(src, normalize=True)
    th = f0_shape_histogram(tgt, normalize=True, scale_factor=len(tgt) / len(src))
    return _dtw_from_cost(_chi2_cost(sh, th, device), inputs)


def EHSADTW(src, tgt, inputs, device: torch.device):
    """Enhanced shape-aware DTW, the binarizer's default aligner
    (reference: enhance_sadtw.py:107-114, binarize_para.py:168)."""
    sh = f0_shape_histogram(src, normalize=True, enhanced=True)
    th = f0_shape_histogram(tgt, normalize=True, enhanced=True,
                            scale_factor=len(tgt) / len(src))
    return _dtw_from_cost(_chi2_cost(sh, th, device), inputs)


ALIGN_FUNCS = {"SADTW": SADTW, "EHSADTW": EHSADTW}
