"""HiFiGAN ResBlock1 cluster: the CUDA kernels' wrappers and their plain twin.

Counterpart of ``neuralsvb_tpu/ops/fused_resblock.py`` (a Pallas TPU
kernel). Per upsample stage the vocoder averages three ResBlock1 towers
(kernel sizes 3/7/11, dilations 1/3/5); every tower step is

    y   = conv1_{k,d}(lrelu(cur)) + b1
    cur = cur + conv2_{k,1}(lrelu(y)) + b2

with exact zero padding at the sequence edges (reference:
modules/hifigan/hifigan.py:144-169).

- ``mm_dtype`` is the JAX op's argument: the dtype of every conv's matmul
  operands (its input after leaky-ReLU, and its weights). With bf16 each
  operand is rounded to bf16 while sums, biases, the residual chain and the
  tower mean stay f32, which is the TPU kernel's arithmetic. ``None`` picks
  by device (``resolve_mm_dtype``): bf16 on CUDA, as the JAX generator
  picks bf16 on the accelerator; f32 on the CPU, as JAX does off the TPU.
- ``resblock_cluster_plain`` is the same function in plain PyTorch
  (``F.conv1d``) in either ``mm_dtype``. The CPU tests hold it against JAX;
  ``chip_smoke.py`` holds the kernels against it on the card.
- ``fused_resblock_cluster`` is the entry point the generator calls. A CPU
  tensor takes the plain version. A CUDA tensor launches the hand-written
  kernel of its ``mm_dtype`` or raises: bf16 runs ``csrc/resblock_bf16.cu``
  (tensor cores; one operand pre-pass plus 18 convs per stage), f32 runs
  ``csrc/fused_resblock.cu`` (f32 FFMA; 18 convs per stage). There is no
  fallback from a kernel to the plain version.
- The backward (``_Cluster``) recomputes the cluster in f32 and takes its
  gradients, as the JAX ``custom_vjp`` does, in the decomposition of
  ``resblock_cluster_backward_plain``: on the CPU that function itself
  (F.conv1d), on CUDA ``resblock_cluster_backward_cuda``, a schedule of
  the f32 FFMA kernels of ``ops/dilated_conv.py`` (recompute, dgrad and
  wgrad, 18 launches per tower of three steps). Neither calls the plain
  forward or cuDNN.
- The kernel libraries are built with ``nvcc`` from the package's sources
  at first use, into ``build/kernels/`` of the checkout, and loaded with
  ``ctypes`` (``shared_lib.SharedLibrary``).

Weights are packed once per generator and mm dtype to ``[C_out, k, C_in]``
per conv (``pack_tower``), the layout both kernels walk.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import dilated_conv as dc
from .shared_lib import NVCC, NVCC_FLAGS, SharedLibrary

LRELU_SLOPE = 0.1

# (kernel_size, dilations) per tower, mirroring ResBlock1.
ClusterSpec = Tuple[Tuple[int, Tuple[int, ...]], ...]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "fused_resblock.cu"
SOURCE_BF16 = CSRC / "resblock_bf16.cu"
MM_DTYPES = (torch.float32, torch.bfloat16)


def make_spec(kernel_sizes: Sequence[int],
              dilation_sizes: Sequence[Sequence[int]]) -> ClusterSpec:
    return tuple((int(k), tuple(int(d) for d in dils))
                 for k, dils in zip(kernel_sizes, dilation_sizes))


def pack_conv(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv1d weight [C_out, C_in, k] -> kernel layout [C_out, k, C_in]."""
    return weight.permute(0, 2, 1).contiguous()


def pack_tower(convs1, convs2,
               mm_dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """One ResBlock1's convs -> [wa [n, C, k, C], ba [n, C], wb, bb], the
    weights in ``mm_dtype`` and the biases f32 (cf. ``_pack_tower`` in the
    JAX module). Differentiable: gradients of the packed tensors flow back
    to the conv parameters."""
    return [torch.stack([pack_conv(c.weight) for c in convs1]).to(mm_dtype),
            torch.stack([c.bias for c in convs1]),
            torch.stack([pack_conv(c.weight) for c in convs2]).to(mm_dtype),
            torch.stack([c.bias for c in convs2])]


def resolve_mm_dtype(mm_dtype: Optional[torch.dtype],
                     device: torch.device) -> torch.dtype:
    """``None`` -> bf16 on CUDA, f32 elsewhere; f32 and bf16 as given."""
    if mm_dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be float32 or bfloat16, got {mm_dtype}")
    return mm_dtype


def _lrelu(x):
    # derivative 1 at exactly 0, as jax.nn.leaky_relu's (torch's is the
    # slope): the backward recomputes through this function, and a
    # zero-padded crop keeps whole stretches of the cluster at exactly 0
    return torch.where(x >= 0, x, x * LRELU_SLOPE)


def resblock_cluster_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           spec: ClusterSpec,
                           mm_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [B, C, T] -> mean of the ResBlock1 towers, [B, C, T], in F.conv1d
    in ``x.dtype``. With ``mm_dtype`` bf16 each conv's operand (after
    leaky-ReLU) and weight is rounded to bf16 first: the products of bf16
    values are exact in f32, so only the order of the sums differs from the
    TPU kernel.

    ``weights``: flat [wa, ba, wb, bb] per tower (see ``pack_tower``)."""
    if resolve_mm_dtype(mm_dtype, x.device) == torch.bfloat16:
        def q(t):
            return t.to(torch.bfloat16).to(x.dtype)
    else:
        def q(t):
            return t.to(x.dtype)
    outs = []
    for r, (k, dils) in enumerate(spec):
        wa, ba, wb, bb = weights[4 * r: 4 * r + 4]
        cur = x
        for j, d in enumerate(dils):
            y = F.conv1d(q(_lrelu(cur)), q(wa[j]).permute(0, 2, 1),
                         ba[j].to(x.dtype), padding=(k - 1) // 2 * d, dilation=d)
            cur = cur + F.conv1d(q(_lrelu(y)), q(wb[j]).permute(0, 2, 1),
                                 bb[j].to(x.dtype), padding=(k - 1) // 2)
        outs.append(cur)
    return sum(outs) / len(outs)


def _lrelu_back(g, v):
    # g * lrelu'(v): 1 for v >= 0 (at exactly 0 too, as _lrelu), else the slope
    return torch.where(v >= 0, g, g * LRELU_SLOPE)


def _conv_wgrad(g: torch.Tensor, a: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """Packed [C_out, k, C_in] weight gradient of a zero-padded conv_{k,d}
    with output gradient ``g`` [B, C_out, T] and operand ``a`` [B, C_in, T]:
    ``dW[o, j, i] = sum_{b,t} g[b, o, t] a[b, i, t + (j - (k-1)/2) d]``, as one
    F.conv1d with batch and channels swapped (stride d walks the taps)."""
    half = (k - 1) // 2 * d
    out = F.conv1d(F.pad(a, (half, half)).transpose(0, 1), g.transpose(0, 1), stride=d)
    return out.permute(1, 2, 0)


def resblock_cluster_backward_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                                    spec: ClusterSpec, g: torch.Tensor,
                                    need_dx: bool = True):
    """The cluster's gradients in ``x.dtype`` (f32 operands, as the
    backward always recomputes): ``(dL/dx or None, [dwa, dba, dwb, dbb per
    tower])`` for the output gradient ``g``, written out in the
    decomposition of the CUDA kernels (``resblock_cluster_backward_cuda``).

    Per tower the recompute keeps each step's input ``cur`` and
    pre-activation ``y``; then from the top step down, with ``g`` the
    gradient of the step's output (the tower's top: ``g / n_towers``):
    ``g_y = dgrad_{k,1}(g) * lrelu'(y)``, ``g_cur = g + dgrad_{k,d}(g_y) *
    lrelu'(cur)``, ``dW2 = corr(g, lrelu(y))``, ``dW1 = corr(g_y,
    lrelu(cur))``, the biases' gradients the sums of ``g`` and ``g_y``. The
    stage input's gradient adds the towers' in tower order. ``need_dx``
    False skips each tower's last dgrad."""
    dt = x.dtype
    n = len(spec)
    gx, grads = None, []
    for r, (k, dils) in enumerate(spec):
        wa, ba, wb, bb = (t.detach().to(dt) for t in weights[4 * r: 4 * r + 4])
        curs, ys = [x], []
        for j, d in enumerate(dils):
            ys.append(F.conv1d(_lrelu(curs[j]), wa[j].permute(0, 2, 1), ba[j],
                               padding=(k - 1) // 2 * d, dilation=d))
            if j + 1 < len(dils):
                curs.append(curs[j] + F.conv1d(_lrelu(ys[j]), wb[j].permute(0, 2, 1), bb[j],
                                               padding=(k - 1) // 2))
        dwa, dba, dwb, dbb = (torch.empty_like(t) for t in (wa, ba, wb, bb))
        gc = g.to(dt) / n
        for j in reversed(range(len(dils))):
            d = dils[j]
            gy = _lrelu_back(F.conv_transpose1d(gc, wb[j].permute(0, 2, 1),
                                                padding=(k - 1) // 2), ys[j])
            dwb[j], dbb[j] = _conv_wgrad(gc, _lrelu(ys[j]), k, 1), gc.sum((0, 2))
            dwa[j], dba[j] = _conv_wgrad(gy, _lrelu(curs[j]), k, d), gy.sum((0, 2))
            if j > 0 or need_dx:
                gc = gc + _lrelu_back(F.conv_transpose1d(
                    gy, wa[j].permute(0, 2, 1), padding=(k - 1) // 2 * d, dilation=d), curs[j])
        if need_dx:
            gx = gc if gx is None else gx + gc
        grads += [dwa, dba, dwb, dbb]
    return gx, grads


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    fn = lib.nsvb_resblock_conv1d
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ctypes.c_float,
                   ci, ci, ci, ci, ci, vp]
    fn.restype = ci


def _bind_bf16(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.nsvb_resblock_conv1d_bf16
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ctypes.c_float,
                   ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    lib.nsvb_lrelu_bf16.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.nsvb_lrelu_bf16.restype = ci


LIBRARY = SharedLibrary("nsvb_fused_resblock", SOURCE, NVCC, NVCC_FLAGS, _bind)
LIBRARY_BF16 = SharedLibrary("nsvb_resblock_bf16", SOURCE_BF16, NVCC, NVCC_FLAGS,
                             _bind_bf16)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(t: torch.Tensor, name: str, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: need contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _need_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got a tensor on {t.device}")


def resblock_conv1d(inp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    k: int, d: int, *, res: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None,
                    acc: Optional[torch.Tensor] = None,
                    acc_accumulate: bool = False,
                    acc_scale: float = 1.0) -> None:
    """One launch of the f32 kernel on PyTorch's current stream:
    ``v = bias + conv_{k,d}(lrelu(inp)) (+ res)``, then ``out = v`` and/or
    ``acc = ((acc if acc_accumulate else 0) + v) * acc_scale``.

    All tensors are contiguous f32 on one CUDA device; ``w`` is packed
    ``[C, k, C]``. ``out`` may alias ``res`` (an in-place residual add)."""
    _need_cuda("resblock_conv1d", inp)
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
        err = lib.nsvb_resblock_conv1d(
            _ptr(inp), _ptr(w), _ptr(bias), _ptr(res), _ptr(out), _ptr(acc),
            int(acc_accumulate), float(acc_scale), B, C, T, int(k), int(d),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"resblock_conv1d launch failed: CUDA error {err} "
                           f"(B={B} C={C} T={T} k={k} d={d})")
    resblock_conv1d.launches += 1


resblock_conv1d.launches = 0


def lrelu_bf16(x: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the operand pre-pass: ``out [B, T, C] =
    bf16(leaky_relu(x))`` of ``x [B, C, T]`` f32 (contiguous, on a CUDA
    device, C even): the tensor-core kernel's channels-last operand."""
    _need_cuda("lrelu_bf16", x)
    B, C, T = x.shape
    _check(x, "x", (B, C, T), x.device)
    _check(out, "out", (B, T, C), x.device, torch.bfloat16)
    if C % 2:
        raise ValueError(f"lrelu_bf16 needs an even C, got {C}")
    lib = LIBRARY_BF16.get()
    with torch.cuda.device(x.device):
        err = lib.nsvb_lrelu_bf16(_ptr(x), _ptr(out), B, C, T, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"lrelu_bf16 launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)})")
    lrelu_bf16.launches += 1


lrelu_bf16.launches = 0


def resblock_conv1d_bf16(op: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         k: int, d: int, *, res: Optional[torch.Tensor] = None,
                         cur_out: Optional[torch.Tensor] = None,
                         op_out: Optional[torch.Tensor] = None,
                         mean: Optional[torch.Tensor] = None,
                         mean_accumulate: bool = False,
                         mean_scale: float = 1.0) -> None:
    """One launch of the tensor-core kernel on PyTorch's current stream:
    ``v = bias + conv_{k,d}(op) (+ res)`` with bf16 ``op`` (already
    ``bf16(lrelu(.))``, channels-last [B, T, C]) and bf16 ``w`` [C, k, C],
    f32 sums; then ``cur_out = v`` (f32 [B, C, T]), ``op_out =
    bf16(lrelu(v))`` (bf16 [B, T, C]) and/or ``mean = ((mean if
    mean_accumulate else 0) + v) * mean_scale`` (f32 [B, C, T]).

    ``cur_out`` may alias ``res``. C and T must be multiples of 8 (TMA's
    16-byte strides)."""
    _need_cuda("resblock_conv1d_bf16", op)
    B, T, C = op.shape
    dev = op.device
    _check(op, "op", (B, T, C), dev, torch.bfloat16)
    _check(w, "w", (C, k, C), dev, torch.bfloat16)
    _check(bias, "bias", (C,), dev)
    for name, t, shape, dt in (("res", res, (B, C, T), torch.float32),
                               ("cur_out", cur_out, (B, C, T), torch.float32),
                               ("op_out", op_out, (B, T, C), torch.bfloat16),
                               ("mean", mean, (B, C, T), torch.float32)):
        if t is not None:
            _check(t, name, shape, dev, dt)
    if cur_out is None and op_out is None and mean is None:
        raise ValueError("resblock_conv1d_bf16 needs cur_out, op_out or mean")
    if C % 8 or T % 8:
        raise ValueError(f"resblock_conv1d_bf16 needs C and T multiples of 8, "
                         f"got C={C} T={T}")
    lib = LIBRARY_BF16.get()
    with torch.cuda.device(dev):
        err = lib.nsvb_resblock_conv1d_bf16(
            _ptr(op), _ptr(w), _ptr(bias), _ptr(res), _ptr(cur_out), _ptr(op_out),
            _ptr(mean), int(mean_accumulate), float(mean_scale), B, C, T, int(k),
            int(d), _stream(dev))
    if err != 0:
        raise RuntimeError(f"resblock_conv1d_bf16 launch failed: CUDA error {err} "
                           f"(B={B} C={C} T={T} k={k} d={d})")
    resblock_conv1d_bf16.launches += 1


resblock_conv1d_bf16.launches = 0


def _rows4(w: torch.Tensor) -> torch.Tensor:
    # w in contiguous rows of a multiple of 4 floats (16 bytes), zero-padded
    # past the last dim where it is not one
    pad = -w.shape[-1] % 4
    return F.pad(w, (0, pad))[..., :w.shape[-1]] if pad else w.contiguous()


def resblock_cluster_backward_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                                   spec: ClusterSpec, g: torch.Tensor,
                                   need_dx: bool = True):
    """``resblock_cluster_backward_plain`` in the lrelu instances of
    ``ops/dilated_conv.py``, tower by tower: the recompute (2n - 1 launches
    for n steps), per step from the top a dgrad of the second conv
    (``g_y``), a wgrad of it, a dgrad of the first (the next ``g``, or the
    stage input's gradient, which the towers add into in tower order), a
    wgrad of it, then one reduction of the tower's slices: 6n launches per
    tower (one less without ``need_dx``). Returns f32 gradients.

    The recompute and the dgrad chain run on the current stream; the wgrads
    and the reductions, which nothing in the chain waits for, on the
    device's second stream, so that they fill the chain's partial last
    waves. The current stream waits for the second before the function
    returns. Kernel sizes: ``dilated_conv.LRELU_KS``."""
    _need_cuda("resblock_cluster_backward_cuda", x)
    x = x.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    B, C, T = x.shape
    n = len(spec)
    gx = torch.empty_like(x) if need_dx else None
    grads: List[torch.Tensor] = []
    main = torch.cuda.current_stream(x.device)
    side = dc.side_stream(x.device)
    side.wait_stream(main)
    first = dc.launches
    for r, (k, dils) in enumerate(spec):
        wa, ba, wb, bb = (t.detach().to(torch.float32).contiguous()
                          for t in weights[4 * r: 4 * r + 4])
        steps = len(dils)
        # the kernels read [C_r, k, C_out] weights in 16-byte rows: the
        # dgrad the packed [n, C_out, k, C_in] as it is, the recompute a
        # transposed copy [n, C_in, k, C_out]
        wa_f, wb_f = (_rows4(w.permute(0, 3, 2, 1)) for w in (wa, wb))
        wa_d, wb_d = _rows4(wa), _rows4(wb)
        curs = [x] + [torch.empty_like(x) for _ in range(steps - 1)]
        ys = [torch.empty_like(x) for _ in range(steps)]
        for j, d in enumerate(dils):
            dc.conv(curs[j], wa_f[j], d, ys[j], lrelu=True, dgrad=False, bias=ba[j])
            if j + 1 < steps:
                dc.conv(ys[j], wb_f[j], 1, curs[j + 1], lrelu=True, dgrad=False, bias=bb[j],
                        res=curs[j])
        sizes = [t.numel() for t in (wa, ba, wb, bb)]
        offs = [sum(sizes[:i]) for i in range(4)]
        per = C * k * C
        ns = dc.wgrad_slices(C, C, k, B, T, lrelu=True)
        parts = torch.empty(ns, sum(sizes), device=x.device)
        flat = torch.empty(sum(sizes), device=x.device)

        # the slices of step j's gradients in tensor i (one view each, as the
        # launches take them): dW packed [C_out, k, C_in] as [C_out, C_in, k]
        def dw(i, j):
            return parts.as_strided((ns, C, C, k), (parts.stride(0), k * C, 1, C),
                                    offs[i] + j * per)

        def db(i, j):
            return parts.as_strided((ns, C), (parts.stride(0), 1), offs[i] + j * C)

        gys = [torch.empty_like(x) for _ in range(steps)]
        gcs = [torch.empty_like(x) for _ in range(steps - 1)]
        gc, scale = g, 1.0 / n
        for j in reversed(range(steps)):
            d = dils[j]
            dc.conv(gc, wb_d[j], 1, gys[j], lrelu=True, dgrad=True, mask=ys[j], in_scale=scale)
            side.wait_stream(main)  # g, the step's y, cur and g_y are written
            with torch.cuda.stream(side):
                dc.wgrad(gc, ys[j], 1, dw(2, j), db(3, j), lrelu=True, g_scale=scale)
                dc.wgrad(gys[j], curs[j], d, dw(0, j), db(1, j), lrelu=True)
            nxt = None
            if j > 0 or need_dx:
                nxt = gx if j == 0 else gcs[j - 1]
                dc.conv(gys[j], wa_d[j], d, nxt, lrelu=True, dgrad=True, mask=curs[j], res=gc,
                        res_scale=scale, accumulate=j == 0 and r > 0)
            gc, scale = nxt, 1.0
        with torch.cuda.stream(side):
            dc.reduce(parts, flat)
        for t in (g, *curs, *ys, *gys, *gcs, parts, flat):
            t.record_stream(side)  # not reused before the side stream is done with it
        grads += [flat[o: o + s].view_as(t) for o, s, t in zip(offs, sizes, (wa, ba, wb, bb))]
    main.wait_stream(side)
    resblock_cluster_backward_cuda.launches += dc.launches - first
    return gx, grads


resblock_cluster_backward_cuda.launches = 0


def backward_launches(spec: ClusterSpec, need_dx: bool = True) -> int:
    """Launches of ``resblock_cluster_backward_cuda`` for one stage."""
    return sum(6 * len(d) - (not need_dx) for _, d in spec)


# the launch counters of the cluster's kernels, which the task summaries report
KERNEL_COUNTERS = (resblock_conv1d, resblock_conv1d_bf16, lrelu_bf16,
                   resblock_cluster_backward_cuda)


def resblock_cluster_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          spec: ClusterSpec) -> torch.Tensor:
    """The cluster in f32 as 18 launches of the f32 kernel (one per conv);
    returns a new [B, C, T] tensor. ``y`` and ``cur`` are scratch buffers
    that round-trip device memory between launches."""
    x = x.contiguous()
    y = torch.empty_like(x)
    cur = torch.empty_like(x)
    mean = torch.empty_like(x)
    n = len(spec)
    for r, (k, dils) in enumerate(spec):
        wa, ba, wb, bb = (t.to(torch.float32).contiguous()
                          for t in weights[4 * r: 4 * r + 4])
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


def resblock_cluster_bf16_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                               spec: ClusterSpec) -> torch.Tensor:
    """The cluster with bf16 operands: one pre-pass launch (the stage
    input's operand, shared by the towers) and one tensor-core launch per
    conv. Only the bf16 operands (channels-last) and the f32 ``cur`` and
    mean cross device memory between launches."""
    x = x.contiguous()
    B, C, T = x.shape
    x_op = torch.empty(B, T, C, dtype=torch.bfloat16, device=x.device)
    y_op = torch.empty_like(x_op)
    cur_op = torch.empty_like(x_op)
    cur = torch.empty_like(x)
    mean = torch.empty_like(x)
    lrelu_bf16(x, x_op)
    n = len(spec)
    for r, (k, dils) in enumerate(spec):
        wa, wb = (t.to(torch.bfloat16).contiguous() for t in weights[4 * r: 4 * r + 4: 2])
        ba, bb = (t.to(torch.float32).contiguous() for t in weights[4 * r + 1: 4 * r + 4: 2])
        op, res = x_op, x
        for j, d in enumerate(dils):
            resblock_conv1d_bf16(op, wa[j], ba[j], k, d, op_out=y_op)
            if j + 1 < len(dils):
                resblock_conv1d_bf16(y_op, wb[j], bb[j], k, 1, res=res, cur_out=cur,
                                     op_out=cur_op)
                op, res = cur_op, cur
            else:  # tower done: fold into the running mean
                resblock_conv1d_bf16(y_op, wb[j], bb[j], k, 1, res=res, mean=mean,
                                     mean_accumulate=r > 0,
                                     mean_scale=1.0 / n if r == n - 1 else 1.0)
    return mean


class _Cluster(torch.autograd.Function):
    """Forward through the kernel of ``mm_dtype`` (CUDA) or the plain
    version (CPU); backward recomputes in f32 and takes the gradients, as
    the JAX ``custom_vjp`` does (the TPU kernel has no backward kernel):
    through the backward kernels on CUDA, through their plain twin
    ``resblock_cluster_backward_plain`` on the CPU."""

    @staticmethod
    def forward(ctx, x, spec, mm_dtype, *weights):
        ctx.spec = spec
        ctx.save_for_backward(x, *weights)
        if x.device.type == "cuda":
            if mm_dtype == torch.bfloat16:
                return resblock_cluster_bf16_cuda(x, weights, spec)
            return resblock_cluster_cuda(x, weights, spec)
        if x.device.type == "cpu":
            return resblock_cluster_plain(x, weights, spec, mm_dtype)
        raise ValueError(f"fused_resblock_cluster: no kernel for {x.device}")

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        grad = (resblock_cluster_backward_cuda if x.device.type == "cuda"
                else resblock_cluster_backward_plain)
        gx, gw = grad(x, weights, ctx.spec, g, ctx.needs_input_grad[0])
        gw = [t.to(w.dtype) if ctx.needs_input_grad[3 + i] else None
              for i, (t, w) in enumerate(zip(gw, weights))]
        return (gx, None, None, *gw)


def fused_resblock_cluster(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           spec: ClusterSpec,
                           mm_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, C, T] f32 or bf16 -> mean of the ResBlock1 towers [B, C, T] in
    ``x.dtype``.

    ``mm_dtype`` (f32, bf16 or ``None`` = by device, see
    ``resolve_mm_dtype``) is the matmul operands' dtype. CPU tensors run
    ``resblock_cluster_plain``; CUDA tensors run the kernel of ``mm_dtype``
    or raise. Differentiable in ``x`` and ``weights``.

    A bf16 ``x`` (a generator run in ``vocoder_compute_dtype: bfloat16``)
    takes the bf16 operands whatever ``mm_dtype`` says, as the JAX generator
    picks them for a bf16 activation: it runs the same bf16 kernel (one
    pre-pass and 18 convs per stage), whose residual chain and tower mean
    read ``x`` as f32 (exact) and whose result is rounded to bf16, the TPU
    kernel's arithmetic (``neuralsvb_tpu/ops/fused_resblock.py``: the input
    enters as float32 and the result is cast back to the input's dtype)."""
    if x.dtype == torch.bfloat16:
        if mm_dtype not in (None, torch.bfloat16):
            raise ValueError(f"a bf16 x takes bf16 operands, not mm_dtype {mm_dtype}")
        return _Cluster.apply(x.to(torch.float32), spec, torch.bfloat16,
                              *weights).to(torch.bfloat16)
    if x.dtype != torch.float32:
        raise ValueError(f"fused_resblock_cluster takes f32 or bf16, got {x.dtype}")
    return _Cluster.apply(x, spec, resolve_mm_dtype(mm_dtype, x.device), *weights)
