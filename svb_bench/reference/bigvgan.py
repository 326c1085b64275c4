"""BigVGAN-v2 (24 kHz, 100 bands, 256x) in plain PyTorch float32: the
generator with its anti-aliased SnakeBeta activations (``Activation1d`` as
the published modules compute it: replicate pads, depthwise transposed and
strided convolutions with the Kaiser-sinc filter built from its formula,
about six elementwise operations in between), the multi-period and
multi-resolution discriminators and the losses, written from
arXiv:2206.04658 and github.com/NVIDIA/BigVGAN (``bigvgan.py``,
``alias_free_activation/torch/``, ``activations.py``,
``discriminators.py``, ``loss.py``). The benchmark's frozen reference of
the ``bigvgan_v2_24k`` configuration; no kernel, no program import.

Departures from the published code, the configuration's (its ``assumed``):
no weight norm (plain convolutions); the MRD of BigVGAN v1 where v2 trains
the CQT sub-band discriminator; the single-scale log-mel L1
(``mel.log_mel_batch``) where v2 uses a multi-scale mel loss; module names
as the program's (``ups.{i}``).

Precision: float32 with TF32 off (the harness turns it off). Under the
harness's control (TF32 on) the card runs the convolutions and the mel's
matmul in TF32; on the CPU, which has no TF32, the convolutions round
their operands to TF32's 10-bit mantissa instead.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1
MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
MPD_PERIODS = (2, 3, 5, 7, 11)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a convolution reads it: rounded to TF32 on the CPU while
    TF32 is on (the card does this itself; the gradient passes the rounding
    unchanged), else unchanged."""
    if t.device.type != "cpu" or not torch.backends.cudnn.allow_tf32 \
            or t.dtype != torch.float32:
        return t
    i = t.detach().contiguous().view(torch.int32)
    return t + (((i + 0x1000) & ~0x1FFF).view(torch.float32) - t).detach()


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(_operand(x), _operand(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(_operand(x), _operand(self.weight), self.bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    def forward(self, x):
        return F.conv_transpose1d(_operand(x), _operand(self.weight), self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


def kaiser_sinc_filter1d(cutoff: float = 0.25, half_width: float = 0.3,
                         kernel_size: int = 12) -> torch.Tensor:
    """The published low-pass filter [kernel_size]: a Kaiser window whose
    beta comes from the attenuation A = 2.285 (half - 1) pi 4 half_width +
    7.95, times 2 cutoff sinc(2 cutoff t) at the half-integer times of an
    even kernel, normalised to sum 1."""
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


def activation1d(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``Activation1d(SnakeBeta(alpha_logscale=True))``: upsample 2x,
    SnakeBeta, downsample 2x."""
    C = x.shape[1]
    f = FILTER.to(x)
    u = F.pad(x, (5, 5), mode="replicate")
    u = 2 * F.conv_transpose1d(u, f.expand(C, 1, -1), stride=2, groups=C)
    u = u[..., 15:-15]
    a = torch.exp(alpha)[None, :, None]
    b = torch.exp(beta)[None, :, None]
    s = u + (1.0 / (b + 1e-9)) * torch.pow(torch.sin(u * a), 2)
    s = F.pad(s, (5, 6), mode="replicate")
    return F.conv1d(s, f.expand(C, 1, -1), stride=2, groups=C)


class SnakeBeta(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation1d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return activation1d(x, self.act.alpha, self.act.beta)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d)) for d in dilation])
        self.convs2 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size))
            for _ in dilation])
        self.activations = nn.ModuleList([Activation1d(channels)
                                          for _ in range(2 * len(dilation))])

    def forward(self, x):
        acts1, acts2 = self.activations[::2], self.activations[1::2]
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts1, acts2):
            x = c2(a2(c1(a1(x)))) + x
        return x


class BigVGAN(nn.Module):
    """mel [B, T, num_mels] -> wav [B, T * prod(upsample_rates)] in [-1, 1]."""

    def __init__(self, num_mels: int = 100, upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4),
                 upsample_initial_channel: int = 1536,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3):
        super().__init__()
        ch0 = upsample_initial_channel
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(num_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c = ch0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d(ch0 // 2 ** i, c, k, u, padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(c, rk, tuple(rd)))
        self.activation_post = Activation1d(c)
        self.conv_post = Conv1d(c, 1, 7, padding=3, bias=False)

    def forward(self, mel):
        x = self.conv_pre(mel.transpose(1, 2))
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(x)
            x = sum(rb(x) for rb in self.resblocks[i * n:(i + 1) * n]) / n
        x = self.conv_post(self.activation_post(x))
        return torch.clamp(x, min=-1.0, max=1.0)[:, 0]


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [Conv2d(ci, co, (kernel_size, 1), (stride, 1), padding=(get_padding(5, 1), 0))
             for ci, co in zip(chans[:-1], chans[1:])]
            + [Conv2d(1024, 1024, (kernel_size, 1), 1, padding=(2, 0))])
        self.conv_post = Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        B, T = x.shape
        if T % self.period:
            x = F.pad(x[:, None], (0, self.period - T % self.period), "reflect")[:, 0]
        x = x.reshape(B, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = MPD_PERIODS):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p) for p in periods])

    def forward(self, y):
        outs = [d(y) for d in self.discriminators]
        return [o for o, _ in outs], [f for _, f in outs]


class DiscriminatorR(nn.Module):
    """One resolution (n_fft, hop, win): the STFT magnitude of the
    reflect-padded signal, rectangular window (the published call passes
    none), through 2-D convolutions over (frequency, time)."""

    def __init__(self, resolution: Tuple[int, int, int], channels: int = 32):
        super().__init__()
        self.resolution = tuple(resolution)
        c = channels
        self.convs = nn.ModuleList([
            Conv2d(1, c, (3, 9), padding=(1, 4)),
            Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4)),
            Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4)),
            Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4)),
            Conv2d(c, c, (3, 3), padding=(1, 1))])
        self.conv_post = Conv2d(c, 1, (3, 3), padding=(1, 1))

    def forward(self, x):
        n_fft, hop, win = self.resolution
        p = (n_fft - hop) // 2
        x = F.pad(x[:, None], (p, p), mode="reflect")[:, 0]
        spec = torch.stft(x, n_fft=n_fft, hop_length=hop, win_length=win,
                          window=torch.ones(win, dtype=x.dtype, device=x.device),
                          center=False, return_complex=True)
        h = torch.norm(torch.view_as_real(spec), p=2, dim=-1)[:, None]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.flatten(1), fmap


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions=MRD_RESOLUTIONS):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorR(r) for r in resolutions])

    def forward(self, y):
        outs = [d(y) for d in self.discriminators]
        return [o for o, _ in outs], [f for _, f in outs]


def feature_loss(fmap_r, fmap_g):
    return 2 * sum(torch.mean(torch.abs(rl - gl))
                   for dr, dg in zip(fmap_r, fmap_g) for rl, gl in zip(dr, dg))


def discriminator_loss(real, fake):
    """(real, generated) LSGAN losses summed over the sub-discriminators."""
    return (sum(torch.mean((1 - dr) ** 2) for dr in real),
            sum(torch.mean(dg ** 2) for dg in fake))


def generator_loss(fake):
    return sum(torch.mean((1 - dg) ** 2) for dg in fake)
