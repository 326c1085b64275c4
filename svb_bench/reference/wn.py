"""WaveNet-style gated dilated conv stack; port of
``neuralsvb_tpu/models/wn.py`` (reference: modules/fastspeech/fs2_vae.py:19-100).

Weight norm is folded into plain convs (the reference removes it at
inference); ``convert.fold_weight_norm`` folds a reference checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int):
        super().__init__()
        if kernel_size % 2 != 1 or hidden_channels % 2 != 0:
            raise ValueError("WN needs an odd kernel and even channels")
        C = hidden_channels
        self.hidden_channels = C
        self.n_layers = n_layers
        if gin_channels > 0:
            self.cond_layer = nn.Conv1d(gin_channels, 2 * C * n_layers, 1)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            pad = (kernel_size * dilation - dilation) // 2
            self.in_layers.append(nn.Conv1d(C, 2 * C, kernel_size,
                                            dilation=dilation, padding=pad))
            self.res_skip_layers.append(
                nn.Conv1d(C, 2 * C if i < n_layers - 1 else C, 1))

    def forward(self, x, x_mask, g=None):
        """x [B, C, T]; x_mask [B, 1, T]; g [B, gin, T] or None (no
        conditioning) -> [B, C, T]. Padded frames are re-zeroed after every
        layer."""
        C = self.hidden_channels
        if g is not None:
            g = self.cond_layer(g)
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            acts_in = self.in_layers[i](x)
            if g is not None:
                acts_in = acts_in + g[:, i * 2 * C:(i + 1) * 2 * C]
            acts = torch.tanh(acts_in[:, :C]) * torch.sigmoid(acts_in[:, C:])
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :C]) * x_mask
                output = output + res_skip[:, C:]
            else:
                output = output + res_skip
        return output * x_mask
