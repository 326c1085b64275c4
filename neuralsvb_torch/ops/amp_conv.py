"""The convolutions of BigVGAN's AMP towers (``AMPBlock1``): a forward in
cuDNN and a backward in the hand-written kernels of
``csrc/amp_conv_backward.cu``.

For a stride-1 convolution with K taps at dilation d, zero-padded to keep
its length (``padding (K - 1) / 2 * d``), weight W [Co, Ci, K] and output
gradient g [B, Co, T]::

    dx = conv_{K,d}(g) with W's channels swapped and its taps flipped
    dW[o, i, j] = sum_{b,t} g[b, o, t] x[b, i, t + (j - (K-1)/2) d]
    db[o] = sum_{b,t} g[b, o, t]

- ``amp_conv1d`` is the entry point ``AMPBlock1`` calls. Its forward is
  ``F.conv1d`` as ``nn.Conv1d`` calls it, so the forward's numbers are
  cuDNN's. Its backward runs ``amp_conv_backward_cuda`` on a CUDA tensor
  and ``amp_conv_backward_plain`` on a CPU tensor, and raises on any
  other; there is no fallback from a kernel to the plain twin.
- ``amp_conv_backward_plain`` is the kernels' decomposition in
  ``F.conv1d``: the CPU tests hold it against autograd, ``chip_smoke.py``
  holds the kernels against it on the card.
- ``amp_conv_backward_cuda`` launches the dgrad on the current stream and
  the wgrad with its fixed-order reduction on a second stream, and makes
  the current stream wait for the second before it returns. It takes f32
  tensors and K in ``KERNEL_SIZES``.
- ``amp_conv_backward_cuda.launches`` counts the convolution backwards run
  through the kernels (each one dgrad, one wgrad and one reduction
  launch); the trainer's summary reports it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .fused_resblock import _side_stream  # the device's second stream, made at first use
from .shared_lib import NVCC, NVCC_FLAGS, SharedLibrary

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "amp_conv_backward.cu"
KERNEL_SIZES = (3, 7, 11)  # the AMP towers' kernel sizes, the ones the kernels are built for
WGRAD_BLOCKS = 1056        # about eight wgrad blocks per SM over a launch
WGRAD_ITEM = 64            # lattice positions per work item of the wgrad kernel


def _pad(k: int, d: int) -> int:
    return (k - 1) // 2 * d


def amp_conv_backward_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                            d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx [B, Ci, T], dW [Co, Ci, K], db [Co]) of ``F.conv1d(x, w, b,
    padding=(K - 1) / 2 * d, dilation=d)`` for the output gradient ``g``:
    dx as a convolution of ``g`` with the channels swapped and the taps
    flipped, dW as one ``F.conv1d`` with batch and channels swapped
    (stride d walks the taps)."""
    k = w.shape[-1]
    p = _pad(k, d)
    dx = F.conv1d(g, w.transpose(0, 1).flip(-1), padding=p, dilation=d)
    dw = F.conv1d(F.pad(x, (p, p)).transpose(0, 1), g.transpose(0, 1), stride=d)
    return dx, dw.transpose(0, 1), g.sum((0, 2))


# -- the kernels -------------------------------------------------------------

def _bind(lib) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nsvb_tower_dgrad.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
    lib.nsvb_tower_wgrad.argtypes = [vp, vp, vp] + [ci] * 8 + [vp]
    lib.nsvb_tower_reduce.argtypes = [vp, vp, vp, cll, cll, ci, ci, vp]
    for fn in (lib.nsvb_tower_dgrad, lib.nsvb_tower_wgrad, lib.nsvb_tower_reduce):
        fn.restype = ci


LIBRARY = SharedLibrary("nsvb_amp_conv_backward", SOURCE, NVCC, NVCC_FLAGS, _bind)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(s: "torch.cuda.Stream") -> ctypes.c_void_p:
    return ctypes.c_void_p(s.cuda_stream)


def _tile(c: int) -> int:
    """The widest channel tile of 64, 32, 16, 8 that divides ``c`` (8 when
    none does: the kernels mask the rest)."""
    t = 64
    while t > 8 and c % t:
        t //= 2
    return t


def wgrad_slices(co: int, ci: int, k: int, B: int, T: int) -> int:
    """Slices of the wgrad kernel's sum over positions: about
    ``WGRAD_BLOCKS`` blocks, and no more slices than the undilated conv has
    work items (B x ceil(T / 64))."""
    col = _tile(co) // 8
    tiles = -(-co // (8 * col)) * -(-ci // (32 if k <= 5 else 16))
    return max(1, min(-(-WGRAD_BLOCKS // tiles), B * -(-T // WGRAD_ITEM)))


def _checked(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, d: int):
    if x.dim() != 3 or w.dim() != 3 or g.dim() != 3:
        raise ValueError(f"amp_conv_backward_cuda takes x [B, Ci, T], w [Co, Ci, K], g [B, Co, T];"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(g.shape)}")
    B, ci, T = x.shape
    co, _, k = w.shape
    for name, t, shape in (("x", x, (B, ci, T)), ("w", w, (co, ci, k)), ("g", g, (B, co, T))):
        if t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"amp_conv_backward_cuda: {name} must be f32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if k not in KERNEL_SIZES or int(d) < 1 or B > 65535:
        raise ValueError(f"amp_conv_backward_cuda takes K in {KERNEL_SIZES}, d >= 1 and "
                         f"B <= 65535; got K={k} d={d} B={B}")
    if x.device.type != "cuda":
        raise ValueError(f"amp_conv_backward_cuda launches CUDA kernels; got x on {x.device}")
    return x.contiguous(), w.contiguous(), g.contiguous()


def _launched(name: str, err: int, **shape) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({shape})")


def amp_conv_backward_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                           d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``amp_conv_backward_plain`` in the kernels: (dx, dW, db). The dgrad
    runs on the current stream; the wgrad and its reduction on the
    device's second stream, concurrently with it. The current stream waits
    for the second before this returns, so the tensors the second reads or
    writes (x, g, dW, db, the workspace made on it) need no
    ``record_stream``."""
    x, w, g = _checked(x, w, g, d)
    B, ci, T = x.shape
    co, _, k = w.shape
    lib = LIBRARY.get()
    dev = x.device
    main, side = torch.cuda.current_stream(dev), _side_stream(dev)
    with torch.cuda.device(dev):
        side.wait_stream(main)  # x and g are written
        n = co * ci * k + co
        ns = wgrad_slices(co, ci, k, B, T)
        dw = torch.empty(co, ci, k, device=dev)
        db = torch.empty(co, device=dev)
        with torch.cuda.stream(side):
            parts = torch.empty(ns, n, device=dev)
            err = lib.nsvb_tower_wgrad(_ptr(g), _ptr(x), _ptr(parts), B, co, ci, T, k, int(d),
                                       ns, _tile(co) // 8, _stream(side))
            _launched("tower_conv_wgrad", err, B=B, Co=co, Ci=ci, T=T, k=k, d=d)
            err = lib.nsvb_tower_reduce(_ptr(parts), _ptr(dw), _ptr(db), co * ci * k, n, ns,
                                        8 if ns >= 32 else 1, _stream(side))
            _launched("tower_conv_reduce", err, slices=ns, n=n)
        dx = torch.empty_like(x)
        err = lib.nsvb_tower_dgrad(_ptr(g), _ptr(w), _ptr(dx), B, co, ci, T, k, int(d),
                                   _tile(ci), _stream(main))
        _launched("tower_conv_dgrad", err, B=B, Co=co, Ci=ci, T=T, k=k, d=d)
        main.wait_stream(side)
    amp_conv_backward_cuda.launches += 1
    return dx, dw, db


amp_conv_backward_cuda.launches = 0
# the launch counters the trainer's summary reports
AMP_CONV_COUNTERS = (amp_conv_backward_cuda,)


class _AMPConv(torch.autograd.Function):
    """cuDNN's forward; the backward in the kernels (CUDA) or the plain
    twin (CPU), from the saved input and weight."""

    @staticmethod
    def forward(ctx, x, weight, bias, dilation):
        ctx.save_for_backward(x, weight)
        ctx.dilation = dilation
        k = weight.shape[-1]
        return F.conv1d(x, weight, bias, 1, _pad(k, dilation), dilation, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.device.type == "cuda":
            grads = amp_conv_backward_cuda(x, w, g, ctx.dilation)
        elif x.device.type == "cpu":
            grads = amp_conv_backward_plain(x, w, g, ctx.dilation)
        else:
            raise ValueError(f"amp_conv1d: no backward for {x.device}")
        # every gradient is computed; autograd takes those its inputs need
        return tuple(t if need else None
                     for t, need in zip(grads, ctx.needs_input_grad)) + (None,)


def amp_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               dilation: int = 1) -> torch.Tensor:
    """``nn.Conv1d``'s output for x [B, Ci, T], weight [Co, Ci, K] (K odd),
    stride 1, dilation ``dilation`` and zero padding (K - 1) / 2 x dilation
    ([B, Co, T]); differentiable in x, weight and bias."""
    return _AMPConv.apply(x, weight, bias, int(dilation))
