"""HiFiGAN ResBlock1 cluster: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``neuralsvb_tpu/ops/fused_resblock.py`` (a Pallas TPU
kernel). Per upsample stage the vocoder averages three ResBlock1 towers
(kernel sizes 3/7/11, dilations 1/3/5); every tower step is

    y   = conv1_{k,d}(lrelu(cur)) + b1
    cur = cur + conv2_{k,1}(lrelu(y)) + b2

with exact zero padding at the sequence edges (reference:
modules/hifigan/hifigan.py:144-169).

- ``resblock_cluster_plain`` is the same function in plain PyTorch
  (``F.conv1d``). The CPU tests hold it against JAX; ``chip_smoke.py`` holds
  the kernel against it on the card.
- ``fused_resblock_cluster`` is the entry point the generator calls. A CPU
  tensor takes the plain version; a CUDA tensor launches the hand-written
  kernel ``csrc/fused_resblock.cu`` 18 times per stage (once per conv) or
  raises. There is no fallback from the kernel to the plain version.
- The kernel library is built with ``nvcc`` from the package's source at
  first use, into ``build/kernels/`` of the checkout, and loaded with
  ``ctypes`` (``shared_lib.SharedLibrary``).

Weights are packed once per generator to ``[C_out, k, C_in]`` per conv
(``pack_tower``), the layout the kernel walks.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .shared_lib import NVCC, NVCC_FLAGS, SharedLibrary

LRELU_SLOPE = 0.1

# (kernel_size, dilations) per tower, mirroring ResBlock1.
ClusterSpec = Tuple[Tuple[int, Tuple[int, ...]], ...]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_resblock.cu"


def make_spec(kernel_sizes: Sequence[int],
              dilation_sizes: Sequence[Sequence[int]]) -> ClusterSpec:
    return tuple((int(k), tuple(int(d) for d in dils))
                 for k, dils in zip(kernel_sizes, dilation_sizes))


def pack_conv(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv1d weight [C_out, C_in, k] -> kernel layout [C_out, k, C_in]."""
    return weight.permute(0, 2, 1).contiguous()


def pack_tower(convs1, convs2) -> List[torch.Tensor]:
    """One ResBlock1's convs -> [wa [n, C, k, C], ba [n, C], wb, bb]
    (cf. ``_pack_tower`` in the JAX module). Differentiable: gradients of
    the packed tensors flow back to the conv parameters."""
    return [torch.stack([pack_conv(c.weight) for c in convs1]),
            torch.stack([c.bias for c in convs1]),
            torch.stack([pack_conv(c.weight) for c in convs2]),
            torch.stack([c.bias for c in convs2])]


def _lrelu(x):
    return F.leaky_relu(x, LRELU_SLOPE)


def resblock_cluster_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           spec: ClusterSpec) -> torch.Tensor:
    """x [B, C, T] -> mean of the ResBlock1 towers, [B, C, T], in F.conv1d.

    ``weights``: flat [wa, ba, wb, bb] per tower (see ``pack_tower``)."""
    outs = []
    for r, (k, dils) in enumerate(spec):
        wa, ba, wb, bb = weights[4 * r: 4 * r + 4]
        cur = x
        for j, d in enumerate(dils):
            y = F.conv1d(_lrelu(cur), wa[j].permute(0, 2, 1), ba[j],
                         padding=(k - 1) // 2 * d, dilation=d)
            cur = cur + F.conv1d(_lrelu(y), wb[j].permute(0, 2, 1), bb[j],
                                 padding=(k - 1) // 2)
        outs.append(cur)
    return sum(outs) / len(outs)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    fn = lib.nsvb_resblock_conv1d
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ctypes.c_float,
                   ci, ci, ci, ci, ci, vp]
    fn.restype = ci


LIBRARY = SharedLibrary("nsvb_fused_resblock", SOURCE, NVCC, NVCC_FLAGS, _bind)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: need contiguous float32 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def resblock_conv1d(inp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    k: int, d: int, *, res: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None,
                    acc: Optional[torch.Tensor] = None,
                    acc_accumulate: bool = False,
                    acc_scale: float = 1.0) -> None:
    """One launch of the CUDA kernel on PyTorch's current stream:
    ``v = bias + conv_{k,d}(lrelu(inp)) (+ res)``, then ``out = v`` and/or
    ``acc = ((acc if acc_accumulate else 0) + v) * acc_scale``.

    All tensors are contiguous f32 on one CUDA device; ``w`` is packed
    ``[C, k, C]``. ``out`` may alias ``res`` (an in-place residual add)."""
    if inp.device.type != "cuda":
        raise ValueError(f"resblock_conv1d launches a CUDA kernel; got a "
                         f"tensor on {inp.device}")
    B, C, T = inp.shape
    dev = inp.device
    _check(inp, "inp", (B, C, T), dev)
    _check(w, "w", (C, k, C), dev)
    _check(bias, "bias", (C,), dev)
    for name, t in (("res", res), ("out", out), ("acc", acc)):
        if t is not None:
            _check(t, name, (B, C, T), dev)
    if out is None and acc is None:
        raise ValueError("resblock_conv1d needs out or acc")
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nsvb_resblock_conv1d(
            _ptr(inp), _ptr(w), _ptr(bias), _ptr(res), _ptr(out), _ptr(acc),
            int(acc_accumulate), float(acc_scale), B, C, T, int(k), int(d),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"resblock_conv1d launch failed: CUDA error {err} "
                           f"(B={B} C={C} T={T} k={k} d={d})")
    resblock_conv1d.launches += 1


resblock_conv1d.launches = 0


def resblock_cluster_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          spec: ClusterSpec) -> torch.Tensor:
    """The cluster as 18 kernel launches (one per conv); returns a new
    [B, C, T] tensor. ``y`` and ``cur`` are scratch buffers that round-trip
    device memory between launches."""
    x = x.contiguous()
    y = torch.empty_like(x)
    cur = torch.empty_like(x)
    mean = torch.empty_like(x)
    n = len(spec)
    for r, (k, dils) in enumerate(spec):
        wa, ba, wb, bb = (t.contiguous() for t in weights[4 * r: 4 * r + 4])
        src = x
        for j, d in enumerate(dils):
            resblock_conv1d(src, wa[j], ba[j], k, d, out=y)
            if j + 1 < len(dils):
                resblock_conv1d(y, wb[j], bb[j], k, 1, res=src, out=cur)
                src = cur
            else:  # tower done: fold into the running mean
                resblock_conv1d(y, wb[j], bb[j], k, 1, res=src, acc=mean,
                                acc_accumulate=r > 0,
                                acc_scale=1.0 / n if r == n - 1 else 1.0)
    return mean


class _Cluster(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain version (CPU);
    backward recomputes through the plain version, as the JAX ``custom_vjp``
    does (the TPU kernel has no backward kernel either)."""

    @staticmethod
    def forward(ctx, x, spec, *weights):
        ctx.spec = spec
        ctx.save_for_backward(x, *weights)
        if x.device.type == "cuda":
            return resblock_cluster_cuda(x, weights, spec)
        if x.device.type == "cpu":
            return resblock_cluster_plain(x, weights, spec)
        raise ValueError(f"fused_resblock_cluster: no kernel for {x.device}")

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        with torch.enable_grad():
            xs = x.detach().requires_grad_(ctx.needs_input_grad[0])
            ws = [w.detach().requires_grad_(ctx.needs_input_grad[2 + i])
                  for i, w in enumerate(weights)]
            y = resblock_cluster_plain(xs, ws, ctx.spec)
            wanted = [t for t in (xs, *ws) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        gx = next(grads) if xs.requires_grad else None
        gw = [next(grads) if w.requires_grad else None for w in ws]
        return (gx, None, *gw)


def fused_resblock_cluster(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           spec: ClusterSpec) -> torch.Tensor:
    """x [B, C, T] f32 -> mean of the ResBlock1 towers [B, C, T] f32.

    CPU tensors run ``resblock_cluster_plain``; CUDA tensors run the kernel
    or raise. Differentiable in ``x`` and ``weights``."""
    if x.dtype != torch.float32:
        raise ValueError(f"fused_resblock_cluster is f32 only, got {x.dtype}")
    return _Cluster.apply(x, spec, *weights)
