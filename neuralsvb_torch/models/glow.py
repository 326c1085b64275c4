"""Glow-style residual coupling flows, the FVAE's optional prior flow
(``use_prior_glow``); port of ``neuralsvb_tpu/models/glow.py`` (reference:
modules/glow/glow_tts_modules.py:145-234). N x (a mean-only affine coupling
over a WN stack, then a channel flip). Layout ``[B, C, T]``, masks
``[B, 1, T]``; the reference's names: ``flows.{2i}`` are the couplings
(``pre``, ``enc``, ``post``) and ``flows.{2i+1}`` the flips.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .wn import WN


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        self.half = channels // 2
        self.mean_only = mean_only
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = nn.Conv1d(hidden_channels, self.half * (1 if mean_only else 2), 1)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        """x [B, C, T] -> (x', logdet [B])."""
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g)
        stats = self.post(h) * x_mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats.split(self.half, 1)
        if not reverse:
            x1 = m + x1 * torch.exp(logs) * x_mask
            logdet = logs.sum((1, 2))
        else:
            x1 = (x1 - m) * torch.exp(-logs) * x_mask
            logdet = -logs.sum((1, 2))
        return torch.cat([x0, x1], 1), logdet


class Flip(nn.Module):
    def forward(self, x):
        return torch.flip(x, [1])


class ResidualCouplingBlock(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                                    dilation_rate, n_layers, gin_channels))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        """x [B, C, T]; x_mask [B, 1, T]; g [B, gin, T] -> (x', logdet [B])."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        pairs = list(zip(self.flows[0::2], self.flows[1::2]))
        if not reverse:
            for layer, flip in pairs:
                x, ld = layer(x, x_mask, g)
                x = flip(x)
                logdet = logdet + ld
        else:
            for layer, flip in reversed(pairs):
                x, ld = layer(flip(x), x_mask, g, reverse=True)
                logdet = logdet + ld
        return x, logdet
