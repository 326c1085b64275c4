"""HiFiGAN-NSF generator, the multi-period and multi-scale discriminators
and their GAN losses in plain PyTorch: the benchmark's frozen reference
(a copy of the port's ``models/hifigan.py`` with the ResBlock cluster as
plain convolutions, no kernel).

The cluster's arithmetic is the configuration's: each convolution's
operands (its input after leaky-ReLU, and its weights) are rounded to
``operand`` (bf16 by default), sums stay float32; the gradient is that of
the float32 cluster at the same input and weights (the program recomputes
its backward in float32). ``operand`` float8 is the precision control.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import leaky_relu
from .nsf import SourceModuleHnNSF

LRELU_SLOPE = 0.1
# the vocoder pads a mel's frames up to one of these before the generator
# (``spec2wav``); beyond the last, to a multiple of 1024
BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


def pick_bucket(t: int) -> int:
    for b in BUCKETS:
        if t <= b:
            return b
    return ((t + 1023) // 1024) * 1024


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size,
                      padding=get_padding(kernel_size)) for _ in dilation])

    def forward(self, x, operand: Optional[torch.dtype] = None):
        def conv(c, h):
            if operand is None:
                return c(h)
            return F.conv1d(rounded(h, operand), rounded(c.weight, operand), c.bias,
                            padding=c.padding, dilation=c.dilation)
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = conv(c1, leaky_relu(x, LRELU_SLOPE))
            x = conv(c2, leaky_relu(xt, LRELU_SLOPE)) + x
        return x


def rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back; float8 saturates at its largest
    finite value first (a cast out of range gives NaN)."""
    if dtype.itemsize == 1:
        t = t.clamp(-torch.finfo(dtype).max, torch.finfo(dtype).max)
    return t.to(dtype).to(t.dtype)


def cluster(x: torch.Tensor, blocks, operand: Optional[torch.dtype]) -> torch.Tensor:
    """Mean of the ResBlock1 towers: the value with ``operand``-rounded
    convolution operands, the gradient of the float32 towers."""
    def mean(op):
        return sum(rb(x, op) for rb in blocks) / len(blocks)
    if operand is None:
        return mean(None)
    if not torch.is_grad_enabled():
        return mean(operand)
    exact = mean(None)
    with torch.no_grad():
        value = mean(operand)
    return exact + (value - exact).detach()


class HifiGanGenerator(nn.Module):
    """Config keys follow the reference yaml (upsample_rates, ...).

    ``operand`` (attribute): the dtype the cluster's convolution operands
    are rounded to (``None``: float32, no rounding)."""

    operand: Optional[torch.dtype] = torch.bfloat16

    def __init__(self, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 use_pitch_embed: bool = True, audio_sample_rate: int = 22050,
                 num_mels: int = 80, harmonic_num: int = 8, c_out: int = 1):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.hop = int(np.prod(upsample_rates))
        self.num_mels = num_mels
        self.resblock = str(resblock)
        self.num_kernels = len(resblock_kernel_sizes)
        self.use_pitch_embed = use_pitch_embed
        ch0 = upsample_initial_channel
        if use_pitch_embed:
            self.m_source = SourceModuleHnNSF(audio_sample_rate, harmonic_num)
            self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(num_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        if self.resblock != "1":
            raise ValueError(f"resblock {resblock!r}: the reference has ResBlock1 only")
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c_cur = ch0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch0 // (2 ** i), c_cur, k, u,
                                               padding=(k - u) // 2))
            if use_pitch_embed:
                if i + 1 < len(upsample_rates):
                    s = int(np.prod(upsample_rates[i + 1:]))
                    self.noise_convs.append(nn.Conv1d(1, c_cur, 2 * s, stride=s,
                                                      padding=s // 2))
                else:
                    self.noise_convs.append(nn.Conv1d(1, c_cur, 1))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(c_cur, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(c_cur, c_out, 7, padding=3)

    # ----------------------------------------------------------------------
    def forward(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, rand_ini=None, noise=None):
        """mel [B, T, num_mels]; f0 [B, T] Hz (0 = unvoiced) -> wav [B, T*hop].
        ``generator`` / ``zero_noise`` / ``rand_ini`` / ``noise`` drive the
        NSF source's random draws (see ``SineGen``)."""
        har_source = None
        if self.use_pitch_embed and f0 is not None:
            # the phase cumsum runs over T*hop samples and stays float32
            f0_up = f0.to(torch.float32).repeat_interleave(self.hop, dim=1)[:, None]
            har_source, _, _ = self.m_source(f0_up, generator, zero_noise,
                                             rand_ini, noise)
            har_source = har_source.to(mel.dtype)  # [B, 1, L]
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x, LRELU_SLOPE))
            if har_source is not None:
                x = x + self.noise_convs[i](har_source)[:, :, : x.shape[-1]]
            blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            x = cluster(x, blocks, self.operand)
        x = self.conv_post(leaky_relu(x))
        return torch.tanh(x)[:, 0]


# ---------------------------------------------------------------------------
# discriminators and losses (vocoder training)
# ---------------------------------------------------------------------------

class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad to a multiple of the period, fold
    ``[B, T]`` into ``[B, 1, T / p, p]`` and run 2-D convs over the rows
    (reference: hifigan.py:182-224)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (get_padding(5, 1), 0)
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [nn.Conv2d(ci, co, (kernel_size, 1), (stride, 1), padding=pad)
             for ci, co in zip(chans[:-1], chans[1:])]
            + [nn.Conv2d(1024, 1024, (kernel_size, 1), 1, padding=(2, 0))])
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        """x [B, T] -> (scores [B, n], feature maps [B, C, H, p])."""
        B, T = x.shape
        n_pad = (self.period - T % self.period) % self.period
        if n_pad:
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
        x = x.reshape(B, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


DISC_S_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
                (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))  # (out, k, stride, groups)


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs (reference: hifigan.py:255-287)."""

    def __init__(self):
        super().__init__()
        chans = [1] + [c for c, *_ in DISC_S_SPECS]
        self.convs = nn.ModuleList(
            [nn.Conv1d(ci, co, k, s, groups=g, padding=k // 2)
             for ci, (co, k, s, g) in zip(chans, DISC_S_SPECS)])
        self.conv_post = nn.Conv1d(1024, 1, 3, 1, padding=1)

    def forward(self, x):
        """x [B, T] -> (scores [B, n], feature maps [B, C, T'])."""
        h = x[:, None]
        fmap = []
        for conv in self.convs:
            h = leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p) for p in periods])

    def forward(self, y):
        """One signal ``y`` [B, T] -> (scores, feature maps), a list of each
        per period. The reference's ``forward(y, y_hat)`` is two calls: a
        generator step scores only the generated signal."""
        outs = [d(y) for d in self.discriminators]
        return [o for o, _ in outs], [f for _, f in outs]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorS() for _ in range(3)])
        # flax avg_pool counts the zero pad, as torch does by default
        self.meanpool = nn.AvgPool1d(4, 2, padding=1)

    def forward(self, y):
        """One signal ``y`` [B, T] -> (scores, feature maps) per scale; each
        scale after the first halves the signal with a mean pool."""
        outs, fmaps = [], []
        for i, d in enumerate(self.discriminators):
            if i:
                y = self.meanpool(y[:, None])[:, 0]
            o, f = d(y)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


# the losses' means run over the global batch in a data-parallel step
def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    r_losses = sum(torch.mean((1 - dr) ** 2) for dr in disc_real_outputs)
    g_losses = sum(torch.mean(dg ** 2) for dg in disc_generated_outputs)
    n = len(disc_real_outputs)
    return r_losses / n, g_losses / n


def generator_loss(disc_outputs):
    return sum(torch.mean((1 - dg) ** 2) for dg in disc_outputs) / len(disc_outputs)
