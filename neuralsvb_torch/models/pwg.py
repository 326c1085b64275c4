"""Parallel WaveGAN generator and discriminator; port of
``neuralsvb_tpu/models/pwg.py`` (reference:
modules/parallel_wavegan/models/parallel_wavegan.py:21-260,
layers/residual_block.py:39-130, layers/upsample.py:16-183).

Layout ``[B, C, T]``; parameter names are the reference's, so
``neuralsvb_tpu/convert/torch2jax.py`` ``convert_pwg`` maps a generator's
``state_dict`` onto the JAX tree, and ``convert/jax2torch.py`` maps back.
The generator turns noise ``z [B, 1, T_wav]`` and a mel ``[B, aux, T + 2 ctx]``
(edge-padded by ``aux_context_window`` on each side) into a waveform
``[B, T_wav]``: a ``k = 2 ctx + 1`` valid conv over the mel, per upsample
scale a nearest stretch in time and a ``(freq_k, 2s + 1)`` conv over the
mel as a one-channel image (zero-padded by ``s`` in time), then a gated
WaveNet of dilations ``2^(i mod layers_per_stack)`` with skip sums.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Embedding, LeakyReLU


class Stretch2d(nn.Module):
    """Nearest-neighbour stretch of the last (time) axis by ``scale``."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return torch.repeat_interleave(x, self.scale, dim=-1)


class UpsampleNetwork(nn.Module):
    """``up_layers``: per scale a ``Stretch2d`` then a bias-free
    ``Conv2d(1, 1, (freq_k, 2s + 1))`` initialised to the mean of its window
    (the reference's and the JAX package's init)."""

    def __init__(self, upsample_scales: Sequence[int], freq_axis_kernel_size: int = 1):
        super().__init__()
        fpad = (freq_axis_kernel_size - 1) // 2
        self.up_layers = nn.ModuleList()
        for s in upsample_scales:
            conv = nn.Conv2d(1, 1, (freq_axis_kernel_size, 2 * s + 1), padding=(fpad, s),
                             bias=False)
            nn.init.constant_(conv.weight, 1.0 / ((2 * s + 1) * freq_axis_kernel_size))
            self.up_layers.extend([Stretch2d(s), conv])

    def forward(self, c):
        """c [B, C, T] -> [B, C, T * prod(scales)]."""
        x = c[:, None]
        for layer in self.up_layers:
            x = layer(x)
        return x[:, 0]


class ConvInUpsampleNetwork(nn.Module):
    def __init__(self, upsample_scales: Sequence[int], aux_channels: int = 80,
                 aux_context_window: int = 2):
        super().__init__()
        self.conv_in = nn.Conv1d(aux_channels, aux_channels, 2 * aux_context_window + 1,
                                 bias=False)
        self.upsample = UpsampleNetwork(upsample_scales)

    def forward(self, c):
        return self.upsample(self.conv_in(c))


class ResidualBlock(nn.Module):
    def __init__(self, kernel_size: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, aux_channels: int = 80,
                 dilation: int = 1):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = nn.Conv1d(residual_channels, gate_channels, kernel_size, padding=pad,
                              dilation=dilation)
        self.conv1x1_aux = nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        half = gate_channels // 2
        self.conv1x1_out = nn.Conv1d(half, residual_channels, 1)
        self.conv1x1_skip = nn.Conv1d(half, skip_channels, 1)

    def forward(self, x, c):
        """x [B, residual, T], c [B, aux, T] -> (residual out, skip)."""
        xa, xb = (self.conv(x) + self.conv1x1_aux(c)).chunk(2, dim=1)
        h = torch.tanh(xa) * torch.sigmoid(xb)
        return (self.conv1x1_out(h) + x) * math.sqrt(0.5), self.conv1x1_skip(h)


class ParallelWaveGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_size: int = 3,
                 layers: int = 30, stacks: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, aux_channels: int = 80,
                 aux_context_window: int = 2, upsample_scales: Sequence[int] = (4, 4, 4, 4),
                 use_pitch_embed: bool = False):
        super().__init__()
        if layers % stacks:
            raise ValueError(f"layers {layers} is not a multiple of stacks {stacks}")
        self.layers = layers
        self.aux_context_window = aux_context_window
        self.upsample_scales = tuple(upsample_scales)
        self.hop = math.prod(self.upsample_scales)
        self.use_pitch_embed = use_pitch_embed
        if use_pitch_embed:
            self.pitch_embed = Embedding(300, aux_channels, 0)
            self.c_proj = nn.Linear(2 * aux_channels, aux_channels)
        self.first_conv = nn.Conv1d(in_channels, residual_channels, 1)
        self.upsample_net = ConvInUpsampleNetwork(upsample_scales, aux_channels,
                                                  aux_context_window)
        per_stack = layers // stacks
        self.conv_layers = nn.ModuleList([
            ResidualBlock(kernel_size, residual_channels, gate_channels, skip_channels,
                          aux_channels, 2 ** (i % per_stack)) for i in range(layers)])
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(skip_channels, skip_channels, 1),
            nn.ReLU(), nn.Conv1d(skip_channels, out_channels, 1)])

    def forward(self, z, c, pitch: Optional[torch.Tensor] = None):
        """z [B, 1, T_wav]; c [B, aux, T + 2 ctx]; pitch [B, T] coarse ids
        (with ``use_pitch_embed``; the embedding joins the mel inside the
        context window, which is then edge-padded again) -> wav [B, T_wav]."""
        if self.use_pitch_embed and pitch is not None:
            ctx = self.aux_context_window
            core = c[:, :, ctx: c.shape[2] - ctx]
            fused = self.c_proj(torch.cat([core.transpose(1, 2), self.pitch_embed(pitch)], -1))
            c = F.pad(fused.transpose(1, 2), (ctx, ctx), mode="replicate") if ctx else \
                fused.transpose(1, 2)
        c = self.upsample_net(c)
        h = self.first_conv(z)
        skips = 0.0
        for block in self.conv_layers:
            h, s = block(h, c)
            skips = skips + s
        out = skips * math.sqrt(1.0 / self.layers)
        for layer in self.last_conv_layers:
            out = layer(out)
        return out[:, 0]


class ParallelWaveGANDiscriminator(nn.Module):
    """Non-causal dilated conv stack. ``conv_layers`` is the reference's
    flat list: ``conv_layers.{2i}`` the conv of layer i (dilation i for
    i > 0, 1 for the first), ``{2i + 1}`` its leaky ReLU (0.2, the JAX
    slope at exactly 0), the last entry the output conv."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_size: int = 3,
                 layers: int = 10, conv_channels: int = 64):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        c_in = in_channels
        for i in range(layers - 1):
            dilation = i if i > 0 else 1
            self.conv_layers.extend([
                nn.Conv1d(c_in, conv_channels, kernel_size,
                          padding=(kernel_size - 1) // 2 * dilation, dilation=dilation),
                LeakyReLU(0.2)])
            c_in = conv_channels
        self.conv_layers.append(nn.Conv1d(c_in, out_channels, kernel_size,
                                          padding=(kernel_size - 1) // 2))

    def forward(self, x):
        """x [B, T] -> scores [B, T]."""
        h = x[:, None]
        for layer in self.conv_layers:
            h = layer(h)
        return h[:, 0]
