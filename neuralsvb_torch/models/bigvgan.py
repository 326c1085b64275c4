"""BigVGAN-v2 generator (AMP blocks: anti-aliased SnakeBeta activations)
and the multi-resolution STFT discriminator (MRD) of its training
(arXiv:2206.04658; github.com/NVIDIA/BigVGAN ``bigvgan.py`` and
``discriminators.py``). No JAX counterpart: the plain reference is
the benchmark's ``svb_bench/reference/bigvgan.py``.

conv_pre -> N x (ConvTranspose up -> mean of the AMPBlock1 towers) ->
Activation1d -> conv_post (no bias) -> clamp to [-1, 1]. There is no
activation before an upsampling (unlike HiFiGAN) and no tanh at the end.
Each tower step is ``x = x + c2(A2(c1_d(A1(x))))``; every ``Activation1d``
runs ``ops.amp_activation.amp_activation``: the fused kernels on the card,
their plain twins on the CPU. The towers' convolutions run
``ops.amp_conv.amp_conv1d``: cuDNN's float32 forward, and a backward in the
hand-written kernels of ``ops/dilated_conv.py`` on the card (its
plain twin on the CPU). The other convolutions stay plain (cuDNN float32
on the card). There is no weight norm, as in the port's HiFiGAN. The mel enters as
``[B, T, num_mels]``, the layout of the vocoder dataset.

MRD: per resolution (n_fft, hop, win) the STFT magnitude of the
reflect-padded signal (rectangular window, as the published call passes
none), then 2-D convolutions over (frequency, time) with leaky-ReLU 0.1,
each through ``ops.mrd_conv.mrd_conv2d``: cuDNN's float32 forward; on the
card both updates (the discriminators' and the generator's) take its
gradients from the hand-written kernels of ``csrc/mrd_conv_backward.cu``,
on the CPU from the plain twin; parameter names are the published
``discriminators.{i}.convs.{j}`` and
``conv_post``. Under a ``torch.profiler`` session the generator records a
span ``bigvgan.stage`` around each upsampling stage with its towers, the
MRD a span ``mrd`` (``utils/profiling.py`` ``span``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.amp_activation import amp_activation
from ..ops.amp_conv import amp_conv1d
from ..ops.mrd_conv import mrd_conv2d
from ..utils.profiling import span
from .hifigan import get_padding

MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


class SnakeBeta(nn.Module):
    """The logscale parameters of SnakeBeta, initialised to 0 (e^0 = 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation1d(nn.Module):
    """Upsample 2x, SnakeBeta, downsample 2x (``ops/amp_activation.py``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return amp_activation(x, self.act.alpha, self.act.beta)


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size))
            for _ in dilation])
        self.activations = nn.ModuleList([Activation1d(channels)
                                          for _ in range(2 * len(dilation))])

    def forward(self, x):
        acts1, acts2 = self.activations[::2], self.activations[1::2]
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts1, acts2):
            h = amp_conv1d(a1(x), c1.weight, c1.bias, c1.dilation[0])
            x = amp_conv1d(a2(h), c2.weight, c2.bias) + x
        return x


class BigVGANGenerator(nn.Module):
    """Config keys follow BigVGAN's (``upsample_rates``, ...);
    ``num_mels`` is the recipe's ``audio_num_mel_bins``."""

    def __init__(self, num_mels: int = 100, upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4),
                 upsample_initial_channel: int = 1536,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3):
        super().__init__()
        ch0 = upsample_initial_channel
        self.hop = math.prod(int(u) for u in upsample_rates)
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(num_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c = ch0 // 2 ** (i + 1)
            self.ups.append(nn.ConvTranspose1d(ch0 // 2 ** i, c, k, u, padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(c, rk, tuple(rd)))
        self.activation_post = Activation1d(c)
        self.conv_post = nn.Conv1d(c, 1, 7, padding=3, bias=False)

    def forward(self, mel):
        """mel [B, T, num_mels] -> wav [B, T * hop] in [-1, 1]."""
        x = self.conv_pre(mel.transpose(1, 2))
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            with span("bigvgan.stage"):
                x = up(x)
                x = sum(rb(x) for rb in self.resblocks[i * n:(i + 1) * n]) / n
        x = self.conv_post(self.activation_post(x))
        return torch.clamp(x, min=-1.0, max=1.0)[:, 0]


class DiscriminatorR(nn.Module):
    """One resolution (n_fft, hop, win) of the MRD."""

    def __init__(self, resolution: Tuple[int, int, int], channels: int = 32):
        super().__init__()
        self.resolution = tuple(resolution)
        c = channels
        self.convs = nn.ModuleList([
            nn.Conv2d(1, c, (3, 9), padding=(1, 4)),
            nn.Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4)),
            nn.Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4)),
            nn.Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4)),
            nn.Conv2d(c, c, (3, 3), padding=(1, 1))])
        self.conv_post = nn.Conv2d(c, 1, (3, 3), padding=(1, 1))
        self.register_buffer("window", torch.ones(self.resolution[2]), persistent=False)

    def spectrogram(self, x):
        """x [B, N] -> |STFT| [B, n_fft / 2 + 1, frames] of the signal
        reflect-padded by (n_fft - hop) / 2 a side, uncentred frames."""
        n_fft, hop, win = self.resolution
        p = (n_fft - hop) // 2
        x = F.pad(x[:, None], (p, p), mode="reflect")[:, 0]
        return torch.stft(x, n_fft=n_fft, hop_length=hop, win_length=win,
                          window=self.window.to(x.dtype), center=False,
                          return_complex=True).abs()

    def forward(self, x):
        """x [B, N] -> (scores [B, n], feature maps [B, C, F', T'])."""
        h = self.spectrogram(x)[:, None]
        fmap = []
        for conv in self.convs:
            h = mrd_conv2d(h, conv.weight, conv.bias, conv.stride[1], lrelu=True)
            fmap.append(h)
        h = mrd_conv2d(h, self.conv_post.weight, self.conv_post.bias, 1, lrelu=False)
        fmap.append(h)
        return h.flatten(1), fmap


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions: Sequence[Tuple[int, int, int]] = MRD_RESOLUTIONS):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorR(r) for r in resolutions])

    @span("mrd")
    def forward(self, y):
        """One signal ``y`` [B, N] -> (scores, feature maps) per resolution."""
        outs = [d(y) for d in self.discriminators]
        return [o for o, _ in outs], [f for _, f in outs]
