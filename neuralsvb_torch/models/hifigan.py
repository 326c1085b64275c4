"""HiFiGAN generator with NSF sine excitation, the multi-period and
multi-scale discriminators and the GAN losses of vocoder training; port of
``neuralsvb_tpu/models/hifigan.py`` (reference: modules/hifigan/hifigan.py).

conv_pre -> N x (leaky_relu -> ConvTranspose up -> + NSF source through a
strided noise_conv -> mean of the multi-kernel ResBlocks) -> leaky_relu ->
conv_post -> tanh. With ``resblock == "1"`` each stage's ResBlock cluster
runs through ``ops.fused_resblock.fused_resblock_cluster``: the CUDA kernel
on the card, its plain PyTorch twin on the CPU, in training too (its
backward recomputes the cluster in f32 and takes its gradients, as the JAX
``custom_vjp`` does: f32 FFMA kernels on the card, their plain twin on the
CPU). ``mm_dtype`` is that op's matmul operand dtype;
``None`` picks by device (bf16 on the card, f32 on the CPU), as the JAX
generator picks bf16 on the TPU. Weight norm is folded into plain convs
(the reference removes it at inference; the JAX package trains without it).
Every leaky-ReLU has derivative 1 at exactly 0, as ``jax.nn.leaky_relu``:
a zero-padded crop keeps long stretches of both networks at exactly 0.
The discriminators' parameter names are the reference's
(``discriminators.{i}.convs.{j}``, ``conv_post``). Under a
``torch.profiler`` session the generator records the spans
``hifigan.source`` (the NSF source) and ``hifigan.stage`` (each upsample
stage with its cluster), the discriminators ``mpd`` and ``msd``
(``utils/profiling.py`` ``span``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_resblock import (fused_resblock_cluster, make_spec, pack_tower,
                                  resolve_mm_dtype)
from ..parallel import ddp
from ..utils.profiling import span
from .common import leaky_relu
from .nsf import SourceModuleHnNSF

LRELU_SLOPE = 0.1


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

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(leaky_relu(x, LRELU_SLOPE))
            x = c2(leaky_relu(xt, LRELU_SLOPE)) + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation])

    def forward(self, x):
        for c in self.convs:
            x = c(leaky_relu(x, LRELU_SLOPE)) + x
        return x


class HifiGanGenerator(nn.Module):
    """Config keys follow the reference yaml (upsample_rates, ...).

    ``mm_dtype`` (attribute): the ResBlock cluster's matmul operand dtype,
    f32, bf16 or ``None`` (by device)."""

    mm_dtype: Optional[torch.dtype] = None

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
        self.spec = make_spec(resblock_kernel_sizes, resblock_dilation_sizes)
        ch0 = upsample_initial_channel
        if use_pitch_embed:
            self.m_source = SourceModuleHnNSF(audio_sample_rate, harmonic_num)
            self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(num_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        res_cls = ResBlock1 if self.resblock == "1" else ResBlock2
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
                self.resblocks.append(res_cls(c_cur, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(c_cur, c_out, 7, padding=3)
        # per mm dtype: the packed weights and the (storage, version) of
        # every ResBlock parameter they were packed from
        self._packed: Dict[torch.dtype, List[List[torch.Tensor]]] = {}
        self._packed_from: Dict[torch.dtype, list] = {}

    # -- packed cluster weights --------------------------------------------
    def _mm_dtype(self) -> torch.dtype:
        if self.conv_pre.weight.dtype == torch.bfloat16:
            return torch.bfloat16  # a bf16 generator's activations take bf16 operands
        return resolve_mm_dtype(self.mm_dtype, self.conv_pre.weight.device)

    def _pack(self, mm_dtype: torch.dtype) -> List[List[torch.Tensor]]:
        """Per stage: flat [wa, ba, wb, bb] per tower in the kernel layout."""
        out = []
        for i in range(len(self.ups)):
            ws: List[torch.Tensor] = []
            for j in range(self.num_kernels):
                rb = self.resblocks[i * self.num_kernels + j]
                ws += pack_tower(rb.convs1, rb.convs2, mm_dtype)
            out.append(ws)
        return out

    def _stage_weights(self, mm_dtype: torch.dtype) -> List[List[torch.Tensor]]:
        params = list(self.resblocks.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            # differentiable f32 packing for training; the op rounds operands
            return self._pack(torch.float32)
        # a pack is reused only while every parameter it came from is
        # unchanged: an optimizer step or load_state_dict writes in place
        # (bumping the version), .to() makes new storage
        stamp = [(p.data_ptr(), p._version) for p in params]
        if self._packed_from.get(mm_dtype) != stamp:
            with torch.no_grad():
                self._packed[mm_dtype] = self._pack(mm_dtype)
            self._packed_from[mm_dtype] = stamp
        return self._packed[mm_dtype]

    # ----------------------------------------------------------------------
    def forward(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, rand_ini=None, noise=None):
        """mel [B, T, num_mels]; f0 [B, T] Hz (0 = unvoiced) -> wav [B, T*hop].
        ``generator`` / ``zero_noise`` / ``rand_ini`` / ``noise`` drive the
        NSF source's random draws (see ``SineGen``)."""
        har_source = None
        if self.use_pitch_embed and f0 is not None:
            with span("hifigan.source"):
                # the phase cumsum runs over T*hop samples and stays float32
                f0_up = f0.to(torch.float32).repeat_interleave(self.hop, dim=1)[:, None]
                har_source, _, _ = self.m_source(f0_up, generator, zero_noise,
                                                 rand_ini, noise)
                har_source = har_source.to(mel.dtype)  # [B, 1, L]
        x = self.conv_pre(mel.transpose(1, 2))
        mm_dtype = self._mm_dtype()
        packed = self._stage_weights(mm_dtype) if self.resblock == "1" else None
        for i, up in enumerate(self.ups):
            with span("hifigan.stage"):
                x = up(leaky_relu(x, LRELU_SLOPE))
                if har_source is not None:
                    x = x + self.noise_convs[i](har_source)[:, :, : x.shape[-1]]
                if packed is not None:
                    x = fused_resblock_cluster(x, packed[i], self.spec, mm_dtype)
                else:
                    blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
                    x = sum(rb(x) for rb in blocks) / self.num_kernels
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

    @span("mpd")
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

    @span("msd")
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
def feature_loss(fmap_r, fmap_g):
    return 2 * sum(ddp.global_mean(torch.abs(rl - gl))
                   for dr, dg in zip(fmap_r, fmap_g) for rl, gl in zip(dr, dg))


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    r_losses = sum(ddp.global_mean((1 - dr) ** 2) for dr in disc_real_outputs)
    g_losses = sum(ddp.global_mean(dg ** 2) for dg in disc_generated_outputs)
    n = len(disc_real_outputs)
    return r_losses / n, g_losses / n


def generator_loss(disc_outputs):
    return sum(ddp.global_mean((1 - dg) ** 2) for dg in disc_outputs) / len(disc_outputs)
