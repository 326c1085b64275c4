"""Multi-window 2-D mel discriminator; port of
``neuralsvb_tpu/models/disc.py`` (reference:
modules/fastspeech/multi_window_disc.py:6-199).

Per window length (32/64/128 frames) a clip ``[B, 1, win, 80]`` of the mel
goes through three stride-2 3x3 conv blocks (leaky-ReLU 0.2, dropout 0.25 in
training, a norm after the second and third) and a linear head; reduction
``stack`` returns the validities ``[B, n_windows]``, ``sum`` their sum
``[B, 1]``, and ``none`` a validity per time row of every window's last
block, concatenated ``[B, sum_w ceil(w / 8)]`` (the head then reads one
row, ``C x F'`` in torch's order). Parameter names are the
reference's (``discriminator.discriminators.0.model.1.3.weight``, ...), and
the head reads the conv output flattened in torch's NCHW order, as the
reference does; ``convert.jax2torch.disc_from_jax`` permutes the JAX head
(NHWC order) into it.

Random draws (window starts, dropout masks) come from an explicit
``torch.Generator`` on its own device, in float32 whatever the default
dtype, and move to the input's device, so a CPU generator gives a run on
the card the draws of a CPU run. In a data-parallel step the windows start
from the global batch's ``max(x_len)``, as under the JAX package's GSPMD
``jit``.

The conditional branch (``cond_size > 0``, the JAX package's ``cond_disc``):
per window a linear ``mel_proj_layers.{i}`` of the mel clip plus a linear
``cond_proj_layers.{i}`` of the condition's clip (``cond`` [B, T,
cond_size]) feeds its own multi-window stack, at the windows of the
unconditional branch. Flax creates a submodule's parameters at its first
call, and no task of the JAX package passes a ``cond``, so
``use_cond_disc: true`` leaves its discriminator without ``cond_disc``
parameters. The port builds the branch at the first call that passes a
``cond`` for the same reason: a task-built discriminator carries exactly the
JAX one's parameters and optimizer state.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .common import BatchNorm2d, Dropout, LeakyReLU


class InstanceNorm(nn.Module):
    """Per-example, per-channel normalization over the clip, no affine."""

    def forward(self, x):
        mean = x.mean((2, 3), keepdim=True)
        var = x.var((2, 3), unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5)


class Discriminator2D(nn.Module):
    """Three stride-2 conv blocks and the linear validity head."""

    def __init__(self, time_length: int, freq_length: int = 80, hidden_size: int = 128,
                 norm_type: str = "bn", dropout: float = 0.25, reduction: str = "stack"):
        super().__init__()
        self.per_row = reduction == "none"
        blocks = []
        for i in range(3):
            layers = [nn.Conv2d(1 if i == 0 else hidden_size, hidden_size, 3,
                                stride=2, padding=1),
                      LeakyReLU(0.2), Dropout(dropout)]
            if i > 0:
                if norm_type == "bn":
                    # the reference passes 0.8 positionally into BatchNorm2d:
                    # its eps (multi_window_disc.py:26)
                    layers.append(BatchNorm2d(hidden_size, eps=0.8))
                elif norm_type == "in":
                    layers.append(InstanceNorm())
                else:
                    raise NotImplementedError(f"disc_norm {norm_type!r}")
            blocks.append(nn.Sequential(*layers))
        self.model = nn.ModuleList(blocks)
        t, f = time_length, freq_length
        for _ in range(3):
            t, f = (t + 1) // 2, (f + 1) // 2
        self.adv_layer = nn.Linear(hidden_size * (1 if self.per_row else t) * f, 1)

    def forward(self, x, generator=None):
        """x [B, 1, win, F] -> (validity [B, 1], or [B, win'] per time row
        with reduction ``none``; per-block hiddens)."""
        hiddens = []
        for block in self.model:
            conv, act, drop, *norm = block
            x = drop(act(conv(x)), generator)
            for n in norm:
                x = n(x)
            hiddens.append(x)
        if self.per_row:  # [B, C, t, f] -> a validity per time row t
            return self.adv_layer(x.transpose(1, 2).flatten(2))[..., 0], hiddens
        return self.adv_layer(x.flatten(1)), hiddens


class MultiWindowDiscriminator(nn.Module):
    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128), freq_length: int = 80,
                 hidden_size: int = 128, norm_type: str = "bn", cond_size: int = 0,
                 reduction: str = "stack"):
        super().__init__()
        if reduction not in ("stack", "sum", "none"):
            raise ValueError(f"disc_reduction {reduction!r}: stack, sum or none")
        self.time_lengths = tuple(time_lengths)
        self.reduction = reduction
        self.discriminators = nn.ModuleList(
            [Discriminator2D(w, freq_length, hidden_size, norm_type, reduction=reduction)
             for w in self.time_lengths])
        if cond_size > 0:
            self.mel_proj_layers = nn.ModuleList(
                [nn.Linear(freq_length, freq_length) for _ in self.time_lengths])
            self.cond_proj_layers = nn.ModuleList(
                [nn.Linear(cond_size, freq_length) for _ in self.time_lengths])

    def forward(self, x, x_len, start_frames_wins=None, generator=None, cond=None):
        """x [B, T, F]; x_len [B] valid frames; ``cond`` [B, T, cond_size]
        for the conditional branch. A window starts at
        ``floor(u * (max(x_len) - win + 1))`` for u from ``generator``, or
        at ``start_frames_wins[i]``. Returns (validity of the reduction, or
        None when a window exceeds the padded T, starts, hiddens)."""
        B, T, _ = x.shape
        if any(win > T for win in self.time_lengths):
            return None, [], []
        validity, starts, hiddens = [], [], []
        for i, (win, disc) in enumerate(zip(self.time_lengths, self.discriminators)):
            if start_frames_wins is not None:
                start = torch.as_tensor(start_frames_wins[i], device=x.device)
            else:
                if generator is None:
                    raise ValueError("pass a torch.Generator or start_frames_wins")
                u = torch.rand((), generator=generator, dtype=torch.float32,
                               device=generator.device)
                t_end = (x_len.max() - win).clamp_min(0)
                start = torch.floor(u.to(x.device) * (t_end + 1).float()).long()
            start = start.clamp(0, T - win)
            starts.append(start)
            frames = start + torch.arange(win, device=x.device)
            clip = x[:, frames]  # [B, win, F]
            if cond is not None:
                clip = self.mel_proj_layers[i](clip) + self.cond_proj_layers[i](cond[:, frames])
            v, hs = disc(clip[:, None], generator)
            validity.append(v)
            hiddens.extend(hs)
        if self.reduction == "sum":
            return sum(validity), starts, hiddens
        if self.reduction == "stack":
            return torch.stack([v[:, 0] for v in validity], -1), starts, hiddens
        return torch.cat(validity, -1), starts, hiddens


class Discriminator(nn.Module):
    """The task's ``mel_disc`` (reference: multi_window_disc.py:154-199)."""

    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128), freq_length: int = 80,
                 hidden_size: int = 128, norm_type: str = "bn",
                 reduction: str = "stack", cond_size: int = 0):
        super().__init__()
        self.config = (tuple(time_lengths), freq_length, hidden_size, norm_type)
        self.cond_size, self.reduction = cond_size, reduction
        self.discriminator = MultiWindowDiscriminator(*self.config, reduction=reduction)
        self.cond_disc = None  # built at the first call with a cond (see above)

    def build_cond_disc(self) -> nn.Module:
        """The conditional branch, on the device and dtype of the rest."""
        if self.cond_disc is None:
            p = next(self.discriminator.parameters())
            self.cond_disc = MultiWindowDiscriminator(
                *self.config, cond_size=self.cond_size,
                reduction=self.reduction).to(p.device, p.dtype)
            self.cond_disc.train(self.training)
        return self.cond_disc

    def forward(self, x, start_frames_wins=None, generator=None, cond=None):
        """x [B, T, 80] (or [B, 1, T, 80]); ``cond`` [B, T, cond_size] or
        None -> {'y': the validity (``[B, W]`` for ``stack``) or None, 'y_c':
        the conditional branch's or None, ...}."""
        if x.dim() == 4:
            x = x[:, 0]
        x_len = (x.abs().sum(-1) > 0).long().sum(-1)
        y, starts, h = self.discriminator(x, x_len, start_frames_wins, generator)
        ret = {"y": y, "y_c": None, "start_frames_wins": starts, "h": h}
        if self.cond_size > 0 and cond is not None:
            ret["y_c"], starts, ret["h_c"] = self.build_cond_disc()(
                x, x_len, starts, generator, cond)
            ret["start_frames_wins"] = starts
        return ret
