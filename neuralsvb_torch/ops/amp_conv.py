"""The convolutions of BigVGAN's AMP towers (``AMPBlock1``): a forward in
cuDNN and a backward in the hand-written kernels of ``ops/dilated_conv.py``.

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
  tensors and K in ``dilated_conv.PLAIN_KS``.
- ``amp_conv_backward_cuda.launches`` counts the convolution backwards run
  through the kernels (each one dgrad, one wgrad and one reduction
  launch); the trainer's summary reports it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import dilated_conv as dc


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


def amp_conv_backward_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                           d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``amp_conv_backward_plain`` in the plain instances of
    ``ops/dilated_conv.py``: (dx, dW, db). The wgrad and its reduction run
    on the device's second stream, concurrently with the dgrad on the
    current stream. The current stream waits for the second before this
    returns, so the tensors the second reads or writes (x, g, dW, db, the
    workspace made on it) need no ``record_stream``. Takes f32 tensors and
    K in ``dilated_conv.PLAIN_KS``."""
    name = "amp_conv_backward_cuda"
    if x.dim() != 3 or w.dim() != 3 or g.dim() != 3:
        raise ValueError(f"{name} takes x [B, Ci, T], w [Co, Ci, K], g [B, Co, T];"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(g.shape)}")
    B, ci, T = x.shape
    co, _, k = w.shape
    x, g = x.contiguous(), g.contiguous()
    dev = dc.check(name, k, d, False, ("x", x, (B, ci, T)), ("w", w, (co, ci, k)),
                   ("g", g, (B, co, T)), strided=("w",))
    main, side = torch.cuda.current_stream(dev), dc.side_stream(dev)
    nw = co * ci * k
    ns = dc.wgrad_slices(co, ci, k, B, T, lrelu=False)
    flat = torch.empty(nw + co, device=dev)
    side.wait_stream(main)  # x and g are written
    with torch.cuda.stream(side):
        parts = torch.empty(ns, nw + co, device=dev)
        dc.wgrad(g, x, d, parts.narrow(1, 0, nw).view(ns, co, ci, k), parts.narrow(1, nw, co),
                 lrelu=False)
        dc.reduce(parts, flat)
    dx = torch.empty_like(x)
    # the dgrad reads W [Co, Ci, K] as [Co, K, Ci]: its channels swapped
    dc.conv(g, w.permute(0, 2, 1), d, dx, lrelu=False, dgrad=True)
    main.wait_stream(side)
    amp_conv_backward_cuda.launches += 1
    return dx, flat.narrow(0, 0, nw).view(co, ci, k), flat.narrow(0, nw, co)


amp_conv_backward_cuda.launches = 0


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
