"""MelGAN generator and multi-scale discriminator; port of
``neuralsvb_tpu/models/melgan.py`` (reference:
modules/parallel_wavegan/models/melgan.py:18-427,
layers/residual_stack.py:13-75, layers/causal_conv.py:12-56).

The generator is the reference's flat ``melgan`` Sequential, so its
``state_dict`` is named ``melgan.{i}...`` and
``neuralsvb_tpu/convert/torch2jax.py`` ``convert_melgan_generator`` maps it:
a 7-tap conv, per upsample scale a leaky ReLU, a transposed conv
(``2s`` taps, stride ``s``) and ``stacks`` dilated residual stacks, then a
leaky ReLU, a 7-tap conv and tanh. ``pad_mode`` ``reflect`` (the default)
reflect-pads the unstrided convs, anything else zero-pads them.
``use_causal_conv`` pads on the left only and trims each transposed conv's
trailing stride, so an output sample depends on past frames alone
(``melgan_stream``). Leaky ReLUs take the JAX slope at exactly 0.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import LeakyReLU


class Pad1d(nn.Module):
    """Pad the time axis of [B, C, T] by (left, right), reflecting or with zeros."""

    def __init__(self, left: int, right: int, mode: str = "reflect"):
        super().__init__()
        self.left, self.right = left, right
        self.mode = "reflect" if mode == "reflect" else "constant"

    def forward(self, x):
        return F.pad(x, (self.left, self.right), mode=self.mode)


class CausalConv1d(nn.Module):
    """A conv padded by ``(k - 1) * dilation`` on the left only; the
    reference's parameters live under ``.conv``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, dilation: int = 1,
                 pad_mode: str = "reflect"):
        super().__init__()
        self.pad = Pad1d((kernel_size - 1) * dilation, 0, pad_mode)
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, dilation=dilation)

    def forward(self, x):
        return self.conv(self.pad(x))


class CausalConvTranspose1d(nn.Module):
    """A valid transposed conv whose trailing ``stride`` samples are cut:
    ``T`` frames give ``T * stride`` samples (parameters under ``.deconv``)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.deconv = nn.ConvTranspose1d(c_in, c_out, kernel_size, stride)

    def forward(self, x):
        return self.deconv(x)[:, :, : x.shape[2] * self.stride]


class ResidualStack(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 pad_mode: str = "reflect", use_causal_conv: bool = False):
        super().__init__()
        if use_causal_conv:
            self.stack = nn.Sequential(
                LeakyReLU(0.2),
                CausalConv1d(channels, channels, kernel_size, dilation, pad_mode),
                LeakyReLU(0.2), nn.Conv1d(channels, channels, 1))
        else:
            pad = (kernel_size - 1) // 2 * dilation
            self.stack = nn.Sequential(
                LeakyReLU(0.2), Pad1d(pad, pad, pad_mode),
                nn.Conv1d(channels, channels, kernel_size, dilation=dilation),
                LeakyReLU(0.2), nn.Conv1d(channels, channels, 1))
        self.skip_layer = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        return self.stack(x) + self.skip_layer(x)


class MelGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 80, out_channels: int = 1, channels: int = 512,
                 kernel_size: int = 7, upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 stack_kernel_size: int = 3, stacks: int = 3, pad_mode: str = "reflect",
                 use_causal_conv: bool = False):
        super().__init__()
        self.upsample_scales = tuple(upsample_scales)
        self.hop = math.prod(self.upsample_scales)
        self.use_causal_conv = use_causal_conv
        k = kernel_size
        layers: List[nn.Module] = []

        def conv(c_in, c_out):
            if use_causal_conv:
                return [CausalConv1d(c_in, c_out, k, pad_mode=pad_mode)]
            return [Pad1d((k - 1) // 2, (k - 1) // 2, pad_mode), nn.Conv1d(c_in, c_out, k)]

        layers += conv(in_channels, channels)
        ch = channels
        for s in self.upsample_scales:
            layers.append(LeakyReLU(0.2))
            if use_causal_conv:
                layers.append(CausalConvTranspose1d(ch, ch // 2, 2 * s, s))
            else:
                layers.append(nn.ConvTranspose1d(ch, ch // 2, 2 * s, s,
                                                 padding=s // 2 + s % 2, output_padding=s % 2))
            ch //= 2
            layers += [ResidualStack(ch, stack_kernel_size, stack_kernel_size ** j, pad_mode,
                                     use_causal_conv) for j in range(stacks)]
        layers.append(LeakyReLU(0.2))
        layers += conv(ch, out_channels)
        layers.append(nn.Tanh())
        self.melgan = nn.Sequential(*layers)

    def forward(self, c):
        """c [B, in, T] -> wav [B, T * prod(scales)]."""
        return self.melgan(c)[:, 0]


def melgan_stream(model: MelGANGenerator, mel: torch.Tensor, chunk: int = 32,
                  context: int = 64) -> torch.Tensor:
    """Chunked inference with a causal generator: each step runs the
    generator on up to ``context`` past frames plus ``chunk`` new ones and
    keeps the new samples. Equal to the whole-utterance output once
    ``context`` covers the receptive field. mel [B, in, T] -> wav [B, T * hop]."""
    if not model.use_causal_conv:
        raise ValueError("streaming needs use_causal_conv=True")
    outs = []
    for t0 in range(0, mel.shape[2], chunk):
        lo = max(0, t0 - context)
        y = model(mel[:, :, lo: t0 + chunk])
        outs.append(y[:, (t0 - lo) * model.hop:])
    return torch.cat(outs, dim=1)


class MelGANDiscriminatorScale(nn.Module):
    """reference: melgan.py:194-300. ``layers.0``: a reflect-padded 15-tap
    conv to 16 channels; ``layers.1-4``: grouped strided convs (41 taps,
    stride 4, zero padding 20) to 64, 256, 1024, 1024 channels;
    ``layers.5``: a 5-tap conv; each with a leaky ReLU; ``layers.6``: the
    3-tap output conv."""

    def __init__(self, pad_mode: str = "reflect"):
        super().__init__()
        self.layers = nn.ModuleList([nn.Sequential(
            Pad1d(7, 7, pad_mode), nn.Conv1d(1, 16, 15), LeakyReLU(0.2))])
        c_in = 16
        for c_out in (64, 256, 1024, 1024):
            self.layers.append(nn.Sequential(
                nn.Conv1d(c_in, c_out, 41, stride=4, padding=20, groups=c_in // 4),
                LeakyReLU(0.2)))
            c_in = c_out
        self.layers.append(nn.Sequential(nn.Conv1d(1024, 1024, 5, padding=2),
                                         LeakyReLU(0.2)))
        self.layers.append(nn.Conv1d(1024, 1, 3, padding=1))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, N] -> (scores [B, T'], the feature map of every layer)."""
        h = x[:, None]
        fmaps = []
        for layer in self.layers:
            h = layer(h)
            fmaps.append(h)
        return h[:, 0], fmaps


class MelGANMultiScaleDiscriminator(nn.Module):
    """reference: melgan.py:303-394. Scale i > 0 sees the waveform average
    pooled i times (window 4, stride 2, padding 1, the padding left out of
    each mean)."""

    def __init__(self, scales: int = 3, pad_mode: str = "reflect"):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [MelGANDiscriminatorScale(pad_mode) for _ in range(scales)])

    def forward(self, x):
        outs = []
        for i, d in enumerate(self.discriminators):
            if i > 0:
                x = F.avg_pool1d(x[:, None], 4, 2, 1, count_include_pad=False)[:, 0]
            outs.append(d(x))
        return outs
