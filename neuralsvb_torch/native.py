"""The host C++ DTW and pitch-Viterbi kernels; port of the loader in
``neuralsvb_tpu/native/__init__.py``.

The port builds its own source, ``neuralsvb_torch/csrc/dtw.cpp`` (the same
code as the JAX package's ``native/dtw.cpp``), with g++ and the same flags.
The dynamic programs are sequential, so they stay on the host; the cost
matrix that feeds the DTW comes from the device (``ops/chi2.py``). Unlike
the JAX loader, a failed build raises: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .ops.shared_lib import GXX, GXX_FLAGS, PACKAGE, SharedLibrary

SOURCE = PACKAGE / "csrc" / "dtw.cpp"


def _bind(lib) -> None:
    f32p, i32p, i64 = (ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_int32), ctypes.c_int64)
    lib.dtw_align.restype = ctypes.c_double
    lib.dtw_align.argtypes = [f32p, i64, i64, i32p]
    lib.pitch_viterbi.restype = None
    lib.pitch_viterbi.argtypes = [f32p, f32p, i64, i64, ctypes.c_double,
                                  ctypes.c_double, i32p]


LIBRARY = SharedLibrary("nsvb_native", SOURCE, GXX, GXX_FLAGS, _bind)


def _f32(a: np.ndarray, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.ndim != 2 or 0 in a.shape:
        raise ValueError(f"{name}: need a non-empty 2-D array, got {a.shape}")
    return a


def dtw_align_native(cost: np.ndarray):
    """DTW DP + backtrace over ``cost`` ``[rows, cols]``. Returns (path
    ``[rows]`` int32: the matched column of each row, total path cost)."""
    cost = _f32(cost, "cost")
    rows, cols = cost.shape
    path = np.zeros(rows, dtype=np.int32)
    total = LIBRARY.get().dtw_align(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
        path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return path, float(total)


def pitch_viterbi_native(freqs: np.ndarray, strengths: np.ndarray,
                         octave_jump_cost: float, vuv_cost: float) -> np.ndarray:
    """Viterbi path ``[T]`` int32 over the pitch candidates ``[T, K]``."""
    freqs, strengths = _f32(freqs, "freqs"), _f32(strengths, "strengths")
    if freqs.shape != strengths.shape:
        raise ValueError(f"freqs {freqs.shape} != strengths {strengths.shape}")
    T, K = freqs.shape
    path = np.zeros(T, dtype=np.int32)
    LIBRARY.get().pitch_viterbi(
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        strengths.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, K,
        float(octave_jump_cost), float(vuv_cost),
        path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return path
