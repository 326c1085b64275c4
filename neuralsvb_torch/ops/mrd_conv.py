"""The 2-D convolutions of BigVGAN's multi-resolution discriminator (MRD,
``DiscriminatorR`` in ``models/bigvgan.py``), each with the leaky-ReLU 0.1
that follows it: a forward in cuDNN and a backward in the hand-written
kernels of ``csrc/mrd_conv_backward.cu``.

A layer is ``y = act(b + conv2d(x, W))`` with W [Co, Ci, 3, KW], padding
(1, (KW - 1) / 2) and stride (1, SW); ``act`` is leaky-ReLU 0.1 (derivative
1 at exactly 0, as ``models/common.py``'s) or, for the last layer, none.
From the saved x, W and post-activation y, and the gradient dy of y::

    g  = dy * act'(y)         (act'(y) is 1 for y >= 0, else 0.1)
    dx = conv_transpose2d(g, W) at the forward's stride and padding
    dW[o, i, kh, kw] = sum_{b,h,v} g[b, o, h, v] x[b, i, h + kh - 1, SW v + kw - P]
    db[o] = sum_{b,h,v} g[b, o, h, v]

- ``mrd_conv2d`` is the entry point ``DiscriminatorR`` calls. Its forward
  is ``F.conv2d`` then the activation, so the forward's numbers are
  cuDNN's. Its backward computes dx only when the input needs it and dW, db
  only when the weight or the bias does: the discriminators' update takes
  dW, db and dx below the first layer, the generator's update dx alone
  (the discriminators take no gradient there). On a CUDA tensor both run
  ``mrd_conv_backward_cuda``, on a CPU tensor ``mrd_conv_backward_plain``;
  any other device raises. There is no fallback from a kernel to the
  plain twin.
- ``mrd_conv_backward_plain`` is the kernels' decomposition in
  ``F.conv_transpose2d`` and ``F.conv2d``: the CPU tests hold it against
  autograd, ``chip_smoke.py`` holds the kernels against it on the card.
- ``mrd_conv_backward_cuda`` launches, where asked, the wgrad with its
  fixed-order reduction (``dilated_conv.reduce``) on the device's second
  stream (``dilated_conv.side_stream``) and the dgrad on the current
  stream, and makes the current stream wait for the second before it
  returns. It takes the MRD's four
  geometries (``GEOMETRIES``) in f32; the activation is leaky-ReLU for
  every one but the one-channel output layer's.
- ``mrd_conv_backward_cuda.launches`` counts the convolution backwards run
  through the kernels; the trainer's summary reports it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import dilated_conv as dc
from .shared_lib import NVCC, NVCC_FLAGS, SharedLibrary

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "mrd_conv_backward.cu"
LRELU_SLOPE = 0.1  # the kernels' SLOPE
KH = 3
# (KW, stride along w, C_in, C_out) of DiscriminatorR's six convolutions:
# the first, the three strided, the fifth and conv_post (no activation)
GEOMETRIES = ((9, 1, 1, 32), (9, 2, 32, 32), (3, 1, 32, 32), (3, 1, 32, 1))
WGRAD_BLOCKS = 792     # wgrad blocks a launch: two waves at three blocks an SM
WGRAD_MIN_ITEMS = 16   # work items a slice at least (32 output columns of a row each)
WGRAD_ITEM = 32


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nsvb_mrd_dgrad.argtypes = [vp] * 4 + [ci] * 8 + [vp]
    lib.nsvb_mrd_wgrad.argtypes = [vp] * 4 + [ci] * 9 + [vp]
    for fn in (lib.nsvb_mrd_dgrad, lib.nsvb_mrd_wgrad):
        fn.restype = ci


LIBRARY = SharedLibrary("nsvb_mrd_conv_backward", SOURCE, NVCC, NVCC_FLAGS, _bind)


def _padding(w: torch.Tensor) -> Tuple[int, int]:
    return w.shape[2] // 2, w.shape[3] // 2


def _act_grad(dy: torch.Tensor, y: torch.Tensor, lrelu: bool) -> torch.Tensor:
    return torch.where(y >= 0, dy, dy * LRELU_SLOPE) if lrelu else dy


def mrd_conv_backward_plain(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                            dy: torch.Tensor, stride_w: int, lrelu: bool,
                            need_dx: bool = True, need_dw: bool = True
                            ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx [B, Ci, H, Wi], dW [Co, Ci, 3, KW], db [Co]) of
    ``act(F.conv2d(x, w, b, (1, stride_w), padding))`` from its output
    ``y`` and the output gradient ``dy`` (leaky-ReLU 0.1 where ``lrelu``):
    dx as the transposed convolution of g, dW as one ``F.conv2d`` with
    batch and channels swapped (the stride dilates the gradient, which
    walks the taps). None for what is not asked for."""
    g = _act_grad(dy, y, lrelu)
    ph, pw = _padding(w)
    dx = dw = db = None
    if need_dx:
        wi = x.shape[-1]
        extra = wi - ((g.shape[-1] - 1) * stride_w - 2 * pw + w.shape[-1])
        dx = F.conv_transpose2d(g, w, stride=(1, stride_w), padding=(ph, pw),
                                output_padding=(0, extra))
    if need_dw:
        xp = F.pad(x, (pw, pw, ph, ph)).transpose(0, 1)
        dw = F.conv2d(xp, g.transpose(0, 1), dilation=(1, stride_w))
        dw = dw[..., :w.shape[-1]].transpose(0, 1)
        db = g.sum((0, 2, 3))
    return dx, dw, db


def wgrad_slices(kw: int, ci: int, co: int, B: int, H: int, Wo: int) -> int:
    """Slices of the wgrad kernel's sum over work items (b, h, 32 output
    columns): about ``WGRAD_BLOCKS`` blocks (one a slice, or three, one a
    kernel row, for the layers whose thread holds 8 x 9 taps of one row),
    and at least ``WGRAD_MIN_ITEMS`` items a slice."""
    one_channel = ci == 1 or co == 1
    rows_a_block = KH if (1 if one_channel else 8) * KH * kw <= 72 else 1
    items = B * H * -(-Wo // WGRAD_ITEM)
    return max(1, min(WGRAD_BLOCKS // (KH // rows_a_block), items // WGRAD_MIN_ITEMS))


def mrd_conv_backward_cuda(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                           dy: torch.Tensor, stride_w: int, lrelu: bool, need_dx: bool = True,
                           need_dw: bool = True) -> Tuple[Optional[torch.Tensor], ...]:
    """``mrd_conv_backward_plain`` in the kernels: (dx, dW, db), None for
    what is not asked for (dx contiguous whatever x's strides). The wgrad
    and its reduction run on the device's second stream, concurrently with
    the dgrad on the current stream. The current stream waits for the
    second before this returns, so the tensors the second reads or writes
    (x, y, dy, dW, db, the workspace made on it) need no
    ``record_stream``."""
    name = "mrd_conv_backward_cuda"
    if x.dim() != 4 or w.dim() != 4 or y.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"{name} takes x [B, Ci, H, Wi], w [Co, Ci, 3, KW], y and dy "
                         f"[B, Co, H, Wo]; got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(y.shape)}, {tuple(dy.shape)}")
    B, ci, H, wi = x.shape
    co, _, kh, kw = w.shape
    if kh != KH or (kw, stride_w, ci, co) not in GEOMETRIES or lrelu != (co != 1):
        raise ValueError(f"{name} takes the MRD's geometries (KW, stride, C_in, C_out) in "
                         f"{GEOMETRIES}, kernel height 3, leaky-ReLU but for C_out 1; got "
                         f"{tuple(w.shape)} stride {stride_w} lrelu {lrelu}")
    if not (need_dx or need_dw):
        raise ValueError(f"{name}: nothing asked for")
    wo = (wi + 2 * (kw // 2) - kw) // stride_w + 1
    # the spectrogram (the first layer's x) comes from the STFT with its
    # frequency axis innermost
    x, y, dy = x.contiguous(), y.contiguous(), dy.contiguous()
    dev = dc.check_f32(name, (("x", x, (B, ci, H, wi)), ("w", w, (co, ci, KH, kw)),
                              ("y", y, (B, co, H, wo)), ("dy", dy, (B, co, H, wo))))
    dc.check_cuda(name, dev)
    args = (B, ci, co, H, wi, wo, kw, stride_w)
    yp = y.data_ptr() if lrelu else None
    main = torch.cuda.current_stream(dev)
    dx = dw = db = None
    if need_dw:
        side = dc.side_stream(dev)
        nw = co * ci * KH * kw
        ns = wgrad_slices(kw, ci, co, B, H, wo)
        flat = torch.empty(nw + co, device=dev)
        side.wait_stream(main)  # x, y and dy are written
        with torch.cuda.stream(side):
            parts = torch.empty(ns, nw + co, device=dev)
            dc.checked_launch(LIBRARY, "nsvb_mrd_wgrad", dev,
                              [dy.data_ptr(), yp, x.data_ptr(), parts.data_ptr(), *args, ns],
                              lambda: f"{name} wgrad {args} slices={ns}")
            dc.reduce(parts, flat)
        dw, db = flat.narrow(0, 0, nw).view(co, ci, KH, kw), flat.narrow(0, nw, co)
    if need_dx:
        # the dgrad reads W [Co, Ci, 3, KW] as [Co, 3, KW, Ci], 16 bytes a copy
        wt = w.permute(0, 2, 3, 1).contiguous()
        dx = torch.empty_like(x)
        dc.checked_launch(LIBRARY, "nsvb_mrd_dgrad", dev,
                          [dy.data_ptr(), yp, wt.data_ptr(), dx.data_ptr(), *args],
                          lambda: f"{name} dgrad {args}")
    if need_dw:
        main.wait_stream(side)
    mrd_conv_backward_cuda.launches += 1
    return dx, dw, db


mrd_conv_backward_cuda.launches = 0


class _MRDConv(torch.autograd.Function):
    """cuDNN's forward and the activation; the backward from the saved
    input, weight and output: in the kernels (CUDA) or the plain twin
    (CPU)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride_w, lrelu):
        y = F.conv2d(x, weight, bias, (1, stride_w), _padding(weight))
        if lrelu:
            y = torch.where(y >= 0, y, y * LRELU_SLOPE)
        ctx.save_for_backward(x, weight, y)
        ctx.stride_w, ctx.lrelu = stride_w, lrelu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        need_dx, need_w, need_b = ctx.needs_input_grad[:3]
        sw, lrelu = ctx.stride_w, ctx.lrelu
        if x.device.type == "cuda":
            backward = mrd_conv_backward_cuda
        elif x.device.type == "cpu":
            backward = mrd_conv_backward_plain
        else:
            raise ValueError(f"mrd_conv2d: no backward for {x.device}")
        dx, dw, db = backward(x, w, y, dy, sw, lrelu, need_dx=need_dx, need_dw=need_w or need_b)
        return dx, dw if need_w else None, db if need_b else None, None, None


def mrd_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               stride_w: int, lrelu: bool) -> torch.Tensor:
    """``act(F.conv2d(x, weight, bias, (1, stride_w), (KH // 2, KW // 2)))``
    for x [B, Ci, H, Wi] and weight [Co, Ci, KH, KW] (KH and KW odd), act
    leaky-ReLU 0.1 where ``lrelu`` (derivative 1 at exactly 0), else none;
    differentiable in x, weight and bias."""
    return _MRDConv.apply(x, weight, bias, int(stride_w), bool(lrelu))
