"""The float32 backward of a stride-1, zero-padded, dilated conv1d: the
hand-written kernels of ``csrc/dilated_conv_backward.cu``, their bindings
and their launch policy (tiles, wgrad slices, the reduction's lanes, the
device's second stream, argument checks).

Two schedules drive them, each in its own module with its plain twin:
``fused_resblock.resblock_cluster_backward_cuda`` (the HiFiGAN ResBlock
cluster, whose convolutions read their operand through leaky-ReLU: the
``lrelu`` instances, kernel sizes ``LRELU_KS``) and
``amp_conv.amp_conv_backward_cuda`` (BigVGAN's AMP towers: the plain
instances, ``PLAIN_KS``).

For ``y = conv_{K,d}(x)`` with zero padding (K - 1) / 2 * d a side (y as
long as x), W [Co, Ci, K] and g = dL/dy::

    dx[i, t]    = sum_o sum_j W[o, i, j] g[o, t - (j - (K-1)/2) d]
    dW[o, i, j] = sum_{b,t} g[b, o, t] x[b, i, t + (j - (K-1)/2) d]
    db[o]       = sum_{b,t} g[b, o, t]

- ``conv``: one launch of a forward convolution or, with flipped taps, a
  dgrad; the lrelu instances fuse the cluster's operand transform and
  epilogue (lrelu', bias, residual, accumulate), the plain ones store the
  sums. It reads the weight through its strides, so a caller passes a view: any
  view for the plain instances, one contiguous along the output channel
  for the lrelu ones, which copy it 16 bytes at a time.
- ``wgrad``: one launch that writes each slice's share of dW and db into a
  workspace, through the strides of views of it; ``reduce`` adds the
  slices in order. No atomics: two calls give bit-equal gradients.

Each launch runs on PyTorch's current stream. The library is built with
``nvcc`` at first use (``shared_lib.SharedLibrary``). ``launches`` counts
every launch, so that a schedule can count its own. The argument checks
(``check_f32``, ``check_cuda``), the checked launch (``checked_launch``)
and the second stream (``side_stream``) also serve the MRD's backward
(``ops/mrd_conv.py``), whose kernels live in a library of their own.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .shared_lib import NVCC, NVCC_FLAGS, SharedLibrary

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dilated_conv_backward.cu"
LRELU_KS = (3, 5, 7, 9, 11)  # HiFiGAN's ResBlock kernel sizes: the lrelu instances
PLAIN_KS = (3, 7, 11)        # the AMP towers' kernel sizes: the plain instances
WGRAD_BLOCKS = 1056          # about eight wgrad blocks per SM over a launch
WGRAD_ITEM = 64              # lattice positions per work item of the wgrad kernel


def _bind(lib) -> None:
    vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.nsvb_dconv.argtypes = [vp, vp, cll, cll, cll, vp, vp, vp, vp] + [ci] * 10 + [cf, cf, vp]
    lib.nsvb_dconv_wgrad.argtypes = ([vp, vp, vp] + [cll] * 4 + [vp, cll, cll] + [ci] * 9
                                     + [cf, vp])
    lib.nsvb_dconv_reduce.argtypes = [vp, vp, cll, ci, ci, vp]
    for fn in (lib.nsvb_dconv, lib.nsvb_dconv_wgrad, lib.nsvb_dconv_reduce):
        fn.restype = ci


LIBRARY = SharedLibrary("nsvb_dilated_conv_backward", SOURCE, NVCC, NVCC_FLAGS, _bind)
launches = 0  # kernel launches of this module in the process


def _tile(c: int, lrelu: bool) -> int:
    """Output channels a block computes: 64 for the lrelu instances; for the
    plain ones the widest of 64, 32, 16, 8 that divides ``c`` (8 when none
    does: the kernels mask the rest), so that no tile masks most of its
    lanes at the towers' 768 ... 24 channels."""
    t = 64
    while not lrelu and t > 8 and c % t:
        t //= 2
    return t


def wgrad_slices(co: int, ci: int, k: int, B: int, T: int, lrelu: bool) -> int:
    """Slices of the wgrad kernel's sum over positions, the same for every
    dilation: about ``WGRAD_BLOCKS`` blocks, and no more slices than the
    undilated conv has work items (B x ceil(T / 64))."""
    tiles = -(-co // _tile(co, lrelu)) * -(-ci // (32 if k <= 5 else 16))
    return max(1, min(-(-WGRAD_BLOCKS // tiles), B * -(-T // WGRAD_ITEM)))


_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's second stream, made at first use: the schedules run the
    wgrads and the reductions on it, concurrently with the dgrad chain."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=device)
    return _SIDE_STREAMS[index]


def check_f32(name: str, tensors, strided=()) -> torch.device:
    """The first tensor's device, after a ValueError unless every
    ``(label, tensor, shape)`` (tensor None: absent) is f32 of that shape
    on it, and contiguous unless its label is in ``strided``."""
    dev = tensors[0][1].device
    for label, t, shape in tensors:
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != shape or t.device != dev:
            raise ValueError(f"{name}: {label} must be f32 {tuple(shape)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if label not in strided and not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return dev


def check_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} launches CUDA kernels; got tensors on {dev}")


def check(name: str, k: int, d: int, lrelu: bool, *tensors, strided=()) -> torch.device:
    """The launches' argument check, for a schedule to run before it
    allocates: raises ValueError unless every ``(label, tensor, shape)``
    (tensor None: absent) is f32 of that shape on one device and
    contiguous (unless its label is in ``strided``), ``k`` is a kernel size
    built for the variant (``LRELU_KS`` or ``PLAIN_KS``) and ``d`` >= 1,
    then unless that device is CUDA. Returns the device."""
    dev = check_f32(name, tensors, strided)
    ks = LRELU_KS if lrelu else PLAIN_KS
    if k not in ks or int(d) < 1:
        raise ValueError(f"{name} takes K in {ks} and d >= 1; got K={k} d={d}")
    check_cuda(name, dev)
    return dev


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def checked_launch(library: SharedLibrary, entry: str, dev: torch.device, args,
                   shape) -> None:
    """One call of ``library``'s ``entry``, which launches on the device's
    current stream and returns a CUDA error code; a RuntimeError, naming the
    launch by ``shape()``, unless it is 0."""
    lib = library.get()
    index = dev.index  # an int: the cheaper lookups
    with torch.cuda.device(index):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({shape()})")


def _launch(entry: str, dev: torch.device, args, shape) -> None:
    """``checked_launch`` of this module's library, counted."""
    global launches
    checked_launch(LIBRARY, entry, dev, args, shape)
    launches += 1


def conv(inp: torch.Tensor, w: torch.Tensor, d: int, out: torch.Tensor, *, lrelu: bool,
         dgrad: bool, bias: Optional[torch.Tensor] = None,
         mask: Optional[torch.Tensor] = None, res: Optional[torch.Tensor] = None,
         accumulate: bool = False, in_scale: float = 1.0, res_scale: float = 1.0) -> None:
    """One launch: ``v = conv_{K,d}(op)`` of ``inp`` [B, C_r, T] with ``w``
    [C_r, K, C_out], any strides (element [c, j, o] the weight from
    channel c of ``inp`` to output o at tap j; ``dgrad`` reads the taps
    flipped), into ``out`` [B, C_out, T]. The plain instances store ``v``
    with op the identity. The lrelu instances (the cluster's fused
    convolutions) take op ``lrelu(inp)`` (not ``dgrad``) or ``inp *
    in_scale``, then ``v *= lrelu'(mask)``, ``v += bias + res *
    res_scale``, and ``out = v`` or (``accumulate``) ``out += v``; they copy
    ``w`` 16 bytes at a time: its C_out stride 1, its other strides
    multiples of 4, 16-byte aligned. All but ``w`` contiguous."""
    B, Cr, T = inp.shape
    k, Co = w.shape[1], w.shape[-1]
    name = "dilated_conv.conv"
    dev = check(name, k, d, lrelu, ("inp", inp, (B, Cr, T)), ("w", w, (Cr, k, Co)),
                ("out", out, (B, Co, T)), ("bias", bias, (Co,)), ("mask", mask, (B, Co, T)),
                ("res", res, (B, Co, T)), strided=("w",))
    if B > 65535:
        raise ValueError(f"{name} takes B <= 65535, got {B}")
    if not lrelu and (bias is not None or mask is not None or res is not None or accumulate
                      or in_scale != 1 or res_scale != 1):
        raise ValueError(f"{name}: the plain instances take no bias, mask, residual, "
                         "accumulation or scales")
    if lrelu and (w.stride(2) != 1 or w.stride(0) % 4 or w.stride(1) % 4 or w.data_ptr() % 16):
        raise ValueError(f"{name}: the lrelu instances take w with rows of 16-byte copies, "
                         f"got strides {w.stride()} at {w.data_ptr() % 16} past 16 bytes")
    _launch("nsvb_dconv", dev,
            [_ptr(inp), _ptr(w), *w.stride(), _ptr(bias), _ptr(mask), _ptr(res), _ptr(out),
             B, Cr, Co, T, k, int(d), _tile(Co, lrelu), int(lrelu), int(dgrad),
             int(accumulate), float(in_scale), float(res_scale)],
            lambda: f"B={B} Cr={Cr} Co={Co} T={T} k={k} d={d} dgrad={dgrad}")


def wgrad(g: torch.Tensor, a: torch.Tensor, d: int, dw: torch.Tensor,
          db: Optional[torch.Tensor], *, lrelu: bool, g_scale: float = 1.0) -> None:
    """One launch: slice s gets at ``dw[s]`` ([slices, C_out, C_in, K], any
    strides) its share of ``g_scale * corr(g, op(a))``, the dW of a
    conv_{K,d} with output gradient ``g`` [B, C_out, T] and operand ``a``
    [B, C_in, T] (op: leaky-ReLU for ``lrelu``), and at ``db[s]``
    ([slices, C_out], any strides; None: none) its share of the bias's
    ``g_scale * g.sum((0, 2))``. ``reduce`` adds the slices."""
    B, Co, T = g.shape
    ns, _, Ci, k = dw.shape
    name = "dilated_conv.wgrad"
    dev = check(name, k, d, lrelu, ("g", g, (B, Co, T)), ("a", a, (B, Ci, T)),
                ("dw", dw, (ns, Co, Ci, k)), ("db", db, (ns, Co)), strided=("dw", "db"))
    if ns > 65535:
        raise ValueError(f"{name} takes at most 65535 slices, got {ns}")
    _launch("nsvb_dconv_wgrad", dev,
            [_ptr(g), _ptr(a), _ptr(dw), *dw.stride(), _ptr(db),
             *(db.stride() if db is not None else (0, 0)), B, Co, Ci, T, k, int(d), ns,
             _tile(Co, lrelu), int(lrelu), float(g_scale)],
            lambda: f"B={B} Co={Co} Ci={Ci} T={T} k={k} d={d}")


def reduce(parts: torch.Tensor, out: torch.Tensor) -> None:
    """One launch: ``out = parts.sum(0)`` of the contiguous [slices, n]
    workspace, the slices added in a fixed order."""
    ns, n = parts.shape
    name = "dilated_conv.reduce"
    dev = check_f32(name, (("parts", parts, (ns, n)), ("out", out, (n,))))
    check_cuda(name, dev)
    lanes = 8 if ns >= 32 else 1  # threads that add one output's slices
    _launch("nsvb_dconv_reduce", dev, [_ptr(parts), _ptr(out), n, ns, lanes],
            lambda: f"slices={ns} n={n}")
