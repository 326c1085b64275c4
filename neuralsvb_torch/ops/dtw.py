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

The Euclidean aligners of the pitch-alignment harness (``NaiveDTW``,
``ZMNaiveDTW``, ``NNaiveDTW``, ``LoNDTW``; reference: naive_dtw.py,
local_norm_dtw.py) build their cost in host float64 numpy, as the JAX
package does, and take the same ``device`` argument as the shape-aware ones
only to share ``ALIGN_FUNCS``' signature. ``NInterpo`` (reference:
naive_interpo.py) has another signature and stays outside ``ALIGN_FUNCS``.
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


def _dtw_from_cost(cost_ts, inputs):
    """cost_ts: [T, S] (a tensor, or the Euclidean aligners' host float64
    array). Returns (inputs gathered to the T timeline, alignment)."""
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


def _euclid_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Euclidean distances of the rows of ``a`` [S(, H)] and ``b``
    [T(, H)] -> [S, T] float64."""
    a = np.atleast_2d(np.asarray(a, np.float64).T).T
    b = np.atleast_2d(np.asarray(b, np.float64).T).T
    if a.ndim == 1:
        a, b = a[:, None], b[:, None]
    d2 = (a ** 2).sum(-1)[:, None] + (b ** 2).sum(-1)[None, :] - 2 * a @ b.T
    return np.sqrt(np.maximum(d2, 0))


def NaiveDTW(src, tgt, inputs, device=None):
    return _dtw_from_cost(_euclid_dist(src, tgt).T, inputs)


def ZMNaiveDTW(src, tgt, inputs, device=None):
    """Zero-mean contours."""
    src, tgt = np.asarray(src, np.float64), np.asarray(tgt, np.float64)
    return _dtw_from_cost(_euclid_dist(src - src.mean(), tgt - tgt.mean()).T, inputs)


def NNaiveDTW(src, tgt, inputs, device=None):
    """Standardized contours."""
    src, tgt = np.asarray(src, np.float64), np.asarray(tgt, np.float64)
    src = (src - src.mean()) / (src.std() + 1e-8)
    tgt = (tgt - tgt.mean()) / (tgt.std() + 1e-8)
    return _dtw_from_cost(_euclid_dist(src, tgt).T, inputs)


def get_local_context(f0: np.ndarray, max_window: int = 32) -> np.ndarray:
    """[T] -> [T, 2 * max_window] zero-padded sliding windows
    (reference: local_norm_dtw.py:17-31)."""
    f0 = np.asarray(f0, np.float64).reshape(-1)
    T = len(f0)
    out = np.zeros((T, 2 * max_window))
    for k, d in enumerate(range(-max_window, max_window)):
        lo, hi = max(0, -d), min(T, T - d)
        out[lo:hi, k] = f0[lo + d:hi + d]
    return out


def LoNDTW(src, tgt, inputs, device=None):
    """Locally normalized DTW: windows of the contour, each minus its mean."""
    ls, lt = get_local_context(src), get_local_context(tgt)
    ls = ls - ls.mean(-1, keepdims=True)
    lt = lt - lt.mean(-1, keepdims=True)
    return _dtw_from_cost(_euclid_dist(ls, lt).T, inputs)


def NInterpo(src, tgt, inputs, amateur_mel2ph=None, amateur_mel=None):
    """Nearest-neighbour time interpolation baseline (reference:
    naive_interpo.py:17-26) -> (inputs, mel2ph, mel) on the target timeline
    (None where not given)."""
    S, T = len(src), len(tgt)
    idx = np.minimum(np.arange(T) * S // T, S - 1)
    output = np.asarray(inputs)[idx]
    aligned_mel2ph = np.asarray(amateur_mel2ph)[idx] if amateur_mel2ph is not None else None
    aligned_mel = np.asarray(amateur_mel)[idx] if amateur_mel is not None else None
    return output, aligned_mel2ph, aligned_mel


ALIGN_FUNCS = {"SADTW": SADTW, "EHSADTW": EHSADTW, "NaiveDTW": NaiveDTW,
               "ZMNaiveDTW": ZMNaiveDTW, "NNaiveDTW": NNaiveDTW, "LoNDTW": LoNDTW}
