"""The SADTW/EHSADTW chi-square cost matrix: the CUDA kernel's wrapper and
its plain twin.

Counterpart of ``chi2_dist_pallas`` in ``neuralsvb_tpu/ops/pallas_kernels.py``
(a Pallas TPU kernel) and of the numpy ``chi2_dist`` in
``neuralsvb_tpu/ops/dtw.py``::

    dist[s, t] = sum_m 0.5 * (b[t, m] - a[s, m])^2 / (a[s, m] + b[t, m] + 1e-8)

- ``chi2_dist_plain`` is the same function in plain PyTorch (a broadcast
  chunked over rows of ``a``). The CPU tests hold it against JAX;
  ``chip_smoke.py`` holds the kernel against it on the card.
- ``chi2_dist`` is the entry point the aligners call. A CPU tensor takes the
  plain version; a CUDA tensor launches ``csrc/chi2_dist.cu`` once (counted
  in ``chi2_dist.launches``) or raises. There is no fallback from the kernel
  to the plain version, and no gradient (the TPU kernel has none either).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .shared_lib import NVCC, NVCC_FLAGS, SharedLibrary

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "chi2_dist.cu"


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nsvb_chi2_dist.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.nsvb_chi2_dist.restype = ci


LIBRARY = SharedLibrary("nsvb_chi2_dist", SOURCE, NVCC, NVCC_FLAGS, _bind)
_COUNT_LOCK = threading.Lock()  # the pitch-alignment harness launches from threads


def chi2_dist_plain(a: torch.Tensor, b: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """a [S, M], b [T, M] -> [S, T] float32, in plain torch ops. Chunked
    over rows of ``a`` to bound the [chunk, T, M] intermediate."""
    a, b = a.float(), b.float()
    out = a.new_empty(a.shape[0], b.shape[0])
    for s0 in range(0, a.shape[0], chunk):
        aa = a[s0:s0 + chunk, None, :]
        d = 0.5 * (b[None] - aa) ** 2 / (b[None] + aa + 1e-8)
        out[s0:s0 + chunk] = d.sum(-1)
    return out


def _chi2_dist_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (S, M), (T, Mb) = a.shape, b.shape
    if M != Mb or min(S, T, M) == 0:
        raise ValueError(f"chi2_dist: need non-empty [S, M] and [T, M], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"chi2_dist: a on {a.device}, b on {b.device}")
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    out = torch.empty(S, T, dtype=torch.float32, device=a.device)
    lib = LIBRARY.get()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.nsvb_chi2_dist(ctypes.c_void_p(a.data_ptr()),
                                 ctypes.c_void_p(b.data_ptr()),
                                 ctypes.c_void_p(out.data_ptr()), S, T, M,
                                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"chi2_dist launch failed: CUDA error {err} "
                           f"(S={S} T={T} M={M})")
    count_launch()
    return out


def count_launch() -> None:
    """One more launch in ``chi2_dist.launches``; a lock makes the
    read-modify-write whole under the harness's threads."""
    with _COUNT_LOCK:
        chi2_dist.launches += 1


def chi2_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [S, M], b [T, M] histograms -> [S, T] float32 chi-square costs.

    CPU tensors run ``chi2_dist_plain``; CUDA tensors run the kernel or
    raise."""
    if a.device.type == "cuda":
        return _chi2_dist_cuda(a, b)
    if a.device.type == "cpu":
        return chi2_dist_plain(a, b)
    raise ValueError(f"chi2_dist: no kernel for {a.device}")


chi2_dist.launches = 0
