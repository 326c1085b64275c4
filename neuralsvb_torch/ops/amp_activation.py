"""BigVGAN's anti-aliased SnakeBeta activation (``Activation1d``): the CUDA
kernels' wrappers, their plain twins and the autograd function.

Per channel of x [B, C, T] with logscale parameters ``alpha``, ``beta``
[C] (BigVGAN's ``alias_free_activation/torch/act.py`` with
``SnakeBeta(alpha_logscale=True)``; no TPU counterpart)::

    u = upsample_2x(x)          replicate-pad 5, 2 x depthwise transposed
                                conv (stride 2, ``FILTER``), crop 15 a side
    s = u + sin(u e^alpha)^2 / (e^beta + 1e-9)
    y = downsample_2x(s)        replicate-pad (5, 6), depthwise conv stride 2

``FILTER`` is ``kaiser_sinc_filter1d(0.25, 0.3, 12)``, the published
filter of both resamplings.

- ``activation1d_plain`` is the same function in plain PyTorch, and
  ``activation1d_backward_plain`` its gradient (dx, dalpha, dbeta) written
  out in the kernels' decomposition. The CPU tests hold them against
  autograd and against the plain reference
  ``svb_bench/reference/bigvgan.py``;
  ``chip_smoke.py`` holds the kernels against them on the card.
- ``amp_activation`` is the entry point the generator calls. A CPU tensor
  runs the plain twins (forward without a graph, the written-out
  backward); a CUDA tensor launches ``csrc/amp_activation.cu`` (one
  forward kernel; a backward kernel and a fixed-order reduction of the
  parameters' gradients) or raises. The backward saves x, alpha and beta
  only and recomputes the upsampled signal. There is no fallback from a
  kernel to the plain twin.
- ``amp_forward_cuda.launches`` and ``amp_backward_cuda.launches`` count the
  kernel launches (listed in ``ops/counters.py``, reported by the
  trainer's summary).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

from .shared_lib import NVCC, NVCC_FLAGS, SharedLibrary

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "amp_activation.cu"
KERNEL_SIZE = 12


def kaiser_sinc_filter1d(cutoff: float = 0.25, half_width: float = 0.3,
                         kernel_size: int = KERNEL_SIZE) -> torch.Tensor:
    """The published low-pass filter [kernel_size] (float32): a Kaiser
    window, its beta from the attenuation A = 2.285 (half - 1) pi 4
    half_width + 7.95, times 2 cutoff sinc(2 cutoff t) at t = -half + 0.5
    ... half - 0.5 (an even kernel), normalised to sum 1."""
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    # on the CPU whatever the default device (a module built on meta imports this)
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False, device="cpu")
    t = (torch.arange(-half, half, device="cpu") + 0.5) if even else \
        (torch.arange(kernel_size, device="cpu") - half)
    x = 2 * cutoff * t
    sinc = torch.where(x == 0, torch.ones_like(x), torch.sin(math.pi * x) / (math.pi * x))
    f = 2 * cutoff * window * sinc
    return f / f.sum()


FILTER = kaiser_sinc_filter1d()


@functools.lru_cache(maxsize=8)
def _filter_on(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return FILTER.to(device, dtype)


def _upsample(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    C = x.shape[1]
    u = F.pad(x, (5, 5), mode="replicate")
    return (2 * F.conv_transpose1d(u, f.expand(C, 1, -1), stride=2, groups=C))[..., 15:-15]


def _snake_consts(alpha, beta):
    a = torch.exp(alpha)[None, :, None]
    eb = torch.exp(beta)[None, :, None]
    return a, eb, 1.0 / (eb + 1e-9)


def activation1d_plain(x: torch.Tensor, alpha: torch.Tensor,
                       beta: torch.Tensor) -> torch.Tensor:
    """x [B, C, T] -> y [B, C, T] in plain PyTorch (differentiable)."""
    C = x.shape[1]
    f = _filter_on(x.device, x.dtype)
    u = _upsample(x, f)
    a, _, inv = _snake_consts(alpha, beta)
    s = u + inv * torch.pow(torch.sin(u * a), 2)
    s = F.pad(s, (5, 6), mode="replicate")
    return F.conv1d(s, f.expand(C, 1, -1), stride=2, groups=C)


def _fold_pad(g: torch.Tensor, left: int, n: int) -> torch.Tensor:
    """The gradient at a replicate-padded signal [.., left + n + right] ->
    the gradient at the n samples: the padding's entries add onto the
    edges."""
    out = g[..., left:left + n].clone()
    out[..., 0] += g[..., :left].sum(-1)
    out[..., -1] += g[..., left + n:].sum(-1)
    return out


def activation1d_backward_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                                g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """(dx [B, C, T], dalpha [C], dbeta [C]) of ``activation1d_plain`` at
    (x, alpha, beta) for the output gradient ``g``, recomputing u; the
    kernels' decomposition in plain PyTorch."""
    C, T = x.shape[1], x.shape[2]
    f = _filter_on(x.device, x.dtype)
    u = _upsample(x, f)
    f = f.expand(C, 1, -1)
    a, eb, inv = _snake_consts(alpha, beta)
    # the strided conv's transpose, onto the (5, 6)-padded s
    ds = _fold_pad(F.conv_transpose1d(g, f, stride=2, groups=C, output_padding=1), 5, 2 * T)
    v = u * a
    sn = torch.sin(v)
    s2 = torch.sin(2 * v)
    du = ds * (1 + a * s2 * inv)
    dalpha = (ds * a * u * s2 * inv).sum((0, 2))
    dbeta = (ds * -(sn * sn) * eb * inv * inv).sum((0, 2))
    # the transposed conv's transpose, onto the 5-padded x
    dxp = F.conv1d(2 * F.pad(du, (15, 15)), f, stride=2, groups=C)
    return _fold_pad(dxp, 5, T), dalpha, dbeta


# -- the kernels -------------------------------------------------------------

def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    taps = ctypes.POINTER(ctypes.c_float)
    lib.nsvb_amp_tile.argtypes = []
    lib.nsvb_amp_tile.restype = ci
    lib.nsvb_amp_forward.argtypes = [vp, vp, vp, vp, ci, ci, ci, taps, vp]
    lib.nsvb_amp_forward.restype = ci
    lib.nsvb_amp_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, taps, vp]
    lib.nsvb_amp_backward.restype = ci


LIBRARY = SharedLibrary("nsvb_amp_activation", SOURCE, NVCC, NVCC_FLAGS, _bind)
_TAPS = (ctypes.c_float * KERNEL_SIZE)(*FILTER.tolist())


def _checked(x, alpha, beta):
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"amp_activation takes f32 [B, C, T], got {x.dtype} {tuple(x.shape)}")
    C = x.shape[1]
    for name, t in (("alpha", alpha), ("beta", beta)):
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"amp_activation: {name} must be f32 [{C}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return x.contiguous(), alpha.contiguous(), beta.contiguous()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def amp_forward_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """y = Activation1d(x) in one launch of ``amp_activation_fwd_kernel``."""
    x, alpha, beta = _checked(x, alpha, beta)
    B, C, T = x.shape
    y = torch.empty_like(x)
    lib = LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.nsvb_amp_forward(_ptr(x), _ptr(alpha), _ptr(beta), _ptr(y), B, C, T, _TAPS,
                                   _stream(x.device))
    if err != 0:
        raise RuntimeError(f"amp_activation forward failed: CUDA error {err} (B={B} C={C} T={T})")
    amp_forward_cuda.launches += 1
    return y


def amp_backward_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                      g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dalpha, dbeta) in two launches: ``amp_activation_bwd_kernel``
    (dx and per-block partials) and ``amp_activation_reduce_kernel``."""
    x, alpha, beta = _checked(x, alpha, beta)
    B, C, T = x.shape
    g = g.to(torch.float32).contiguous()
    lib = LIBRARY.get()
    tiles = -(-T // lib.nsvb_amp_tile())
    dx = torch.empty_like(x)
    partial = torch.empty(2, B * C * tiles, dtype=torch.float32, device=x.device)
    dalpha, dbeta = torch.empty_like(alpha), torch.empty_like(beta)
    with torch.cuda.device(x.device):
        err = lib.nsvb_amp_backward(_ptr(x), _ptr(alpha), _ptr(beta), _ptr(g), _ptr(dx),
                                    _ptr(partial), _ptr(dalpha), _ptr(dbeta), B, C, T, _TAPS,
                                    _stream(x.device))
    if err != 0:
        raise RuntimeError(f"amp_activation backward failed: CUDA error {err} "
                           f"(B={B} C={C} T={T})")
    amp_backward_cuda.launches += 2
    return dx, dalpha, dbeta


amp_forward_cuda.launches = 0
amp_backward_cuda.launches = 0


class _AMP(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain twin (CPU); the
    backward recomputes from the saved x, alpha and beta."""

    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        if x.device.type == "cuda":
            return amp_forward_cuda(x, alpha, beta)
        if x.device.type == "cpu":
            return activation1d_plain(x, alpha, beta)
        raise ValueError(f"amp_activation: no kernel for {x.device}")

    @staticmethod
    def backward(ctx, g):
        x, alpha, beta = ctx.saved_tensors
        grad = amp_backward_cuda if x.device.type == "cuda" else activation1d_backward_plain
        return grad(x, alpha, beta, g)


def amp_activation(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x [B, C, T] f32 -> Activation1d(SnakeBeta) [B, C, T], differentiable
    in x, alpha and beta."""
    return _AMP.apply(x, alpha, beta)
