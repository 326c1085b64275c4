"""Common building blocks; port of the parts of
``neuralsvb_tpu/models/common.py`` that the port's models use (reference:
modules/commons/common_layers.py:63-772, modules/fastspeech/pe.py:7-41).

Layout is torch's ``[B, C, T]`` with masks ``[B, 1, T]``. Parameter names
are the reference PyTorch names, so ``neuralsvb_tpu/convert/torch2jax.py``
maps a ``state_dict`` of these modules onto the JAX package. Normalization
epsilons follow the JAX package (flax defaults), which is what the parity
tests hold the port to.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


LN_EPS = 1e-6  # flax LayerNorm / GroupNorm default
BN_EPS = 1e-5


def draw_normal(shape, like: torch.Tensor, generator: Optional[torch.Generator],
                zero_noise: bool) -> torch.Tensor:
    """Standard normal noise on ``like``'s device, drawn from ``generator``;
    exact zeros when ``zero_noise`` (deterministic mean decoding). In a
    data-parallel step, this rank's rows of the global batch's draw."""
    if zero_noise:
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    if generator is None:
        raise ValueError("pass a torch.Generator, or zero_noise=True")
    return torch.randn(tuple(shape), generator=generator, dtype=like.dtype,
                       device=like.device)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """Leaky ReLU whose derivative at exactly 0 is 1, as ``jax.nn.leaky_relu``'s
    (torch's is the slope). Zero-padded inputs through convs with zero biases
    (flax's init) put values exactly at 0."""
    return torch.where(x >= 0, x, x * slope)


def dropout_keep_mask(shape, rate: float, generator: Optional[torch.Generator],
                      device) -> torch.Tensor:
    """Elementwise keep-mask (True = keep, probability 1 - rate); dim 0 is
    the batch (a data-parallel step keeps its rows of the global draw)."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u < 1.0 - rate).to(device)


class Dropout(nn.Module):
    """Elementwise dropout whose mask comes from an explicit generator, so a
    step's draws follow its seed (and a CPU generator gives a run on the
    card the masks of a CPU run)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        keep = dropout_keep_mask(x.shape, self.rate, generator, x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class LeakyReLU(nn.Module):
    """``leaky_relu`` as a module."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return leaky_relu(x, self.slope)


def _batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """BatchNorm over the channel dim 1 with flax ``nn.BatchNorm`` semantics
    (the JAX package's ``BatchNorm1d``, momentum 0.9 there = 0.1 here).

    In training the statistics run over every other dim, padding included,
    with flax's fast variance E[x^2] - E[x]^2 clipped at 0, and the running
    variance takes the BIASED batch variance (torch's own BatchNorm takes the
    unbiased one). A single value per channel normalizes to 0, where torch
    raises. In eval the running statistics apply.

    In a data-parallel step the statistics run over the GLOBAL batch, as the
    JAX package's ``axis_name=None`` BatchNorm under GSPMD ``jit`` does: the
    per-channel means of x and x^2 are averaged over the world
    (differentiably), so every rank normalizes and updates its running
    statistics as one process would.

    A bf16 ``x`` (``compute_dtype: bfloat16``) takes flax's precision: in
    training the statistics, the normalization and the running-statistics
    update run in float32 and the result is cast to bf16; in eval the
    running statistics (as given) normalize in bf16."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    if not bn.training:
        mean = bn.running_mean.view(shape).to(x.dtype)
        var = bn.running_var.view(shape).to(x.dtype)
        y = (x - mean) * torch.rsqrt(var + bn.eps)
        return y * bn.weight.view(shape) + bn.bias.view(shape)
    out_dtype = x.dtype
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = [0] + list(range(2, x.dim()))
    stats = torch.stack([x.mean(dims), (x * x).mean(dims)])
    mean = stats[0].view(shape)
    var = (stats[1].view(shape) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach().flatten(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.detach().flatten(), alpha=m)
        bn.num_batches_tracked.add_(1)
    y = (x - mean) * torch.rsqrt(var + bn.eps)
    return (y * bn.weight.view(shape).to(x.dtype) + bn.bias.view(shape).to(x.dtype)).to(out_dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same state_dict) computing as flax does; see
    ``_batch_norm``."""

    def forward(self, x):
        return _batch_norm(x, self)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state_dict) computing as flax does."""

    def forward(self, x):
        return _batch_norm(x, self)


def linear_ct(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Apply a Linear over the channel dim of [B, C, T]."""
    return F.conv1d(x, layer.weight[:, :, None], layer.bias)


class Embedding(nn.Embedding):
    """Embedding whose padding row reads as zero (reference:
    common_layers.py:63-69)."""

    def __init__(self, num_embeddings: int, features: int, padding_idx: int = 0):
        super().__init__(num_embeddings, features, padding_idx=padding_idx)
        nn.init.normal_(self.weight, 0.0, features ** -0.5)
        with torch.no_grad():
            self.weight[padding_idx].zero_()

    def forward(self, ids):
        emb = super().forward(ids)
        return emb * (ids != self.padding_idx)[..., None].to(emb.dtype)


def masked_group_norm(x, mask, norm: nn.GroupNorm):
    """GroupNorm over [B, C, T] whose statistics cover valid frames only
    (flax ``GroupNorm(mask=...)``), so padded batches match unpadded runs.
    As flax's, it computes in at least float32 and returns ``x.dtype``."""
    B, C, T = x.shape
    G = norm.num_groups
    out_dtype = x.dtype
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    xg = x.reshape(B, G, C // G, T)
    m = mask[:, None].to(x.dtype)  # [B, 1, 1, T]
    n = (m.sum((2, 3), keepdim=True) * (C // G)).clamp_min(1.0)
    mean = (xg * m).sum((2, 3), keepdim=True) / n
    var = (((xg - mean) ** 2) * m).sum((2, 3), keepdim=True) / n
    y = ((xg - mean) * torch.rsqrt(var + norm.eps)).reshape(B, C, T)
    return (y * norm.weight[None, :, None].to(x.dtype)
            + norm.bias[None, :, None].to(x.dtype)).to(out_dtype)


class ConvNorm(nn.Module):
    """Conv1d with symmetric 'same' padding (reference ConvNorm)."""

    def __init__(self, c_in, c_out, kernel_size=1):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x):
        return self.conv(x)


class ConvBlock(nn.Module):
    """conv -> GroupNorm of 16-channel groups -> ReLU (reference:
    common_layers.py:736-772). With ``x_mask`` the GroupNorm statistics
    cover the valid frames only; without, every frame, padding included."""

    def __init__(self, c_in, c_out, kernel_size=3):
        super().__init__()
        self.conv = ConvNorm(c_in, c_out, kernel_size)
        self.norm = nn.GroupNorm(c_out // 16, c_out, eps=LN_EPS)

    def forward(self, x, x_mask=None):
        x = self.conv(x)
        if x_mask is None:
            x_mask = torch.ones_like(x[:, :1])
        return F.relu(masked_group_norm(x, x_mask, self.norm))


class ConvStacks(nn.Module):
    """Conv stack of residual blocks (reference: common_layers.py:672-707).
    x [B, idim, T] -> [B, odim, T]; ``x_mask`` [B, 1, T] re-zeroes padded
    frames after every layer (None: no masking)."""

    def __init__(self, idim, n_layers=5, n_chans=256, odim=32, kernel_size=5):
        super().__init__()
        self.in_proj = nn.Linear(idim, n_chans)
        self.conv = nn.ModuleList([ConvBlock(n_chans, n_chans, kernel_size)
                                   for _ in range(n_layers)])
        self.out_proj = nn.Linear(n_chans, odim)

    def forward(self, x, x_mask=None):
        x = linear_ct(self.in_proj, x)
        if x_mask is not None:
            x = x * x_mask
        for blk in self.conv:
            h = blk(x, x_mask)
            if x_mask is not None:
                h = h * x_mask
            x = x + h
        x = linear_ct(self.out_proj, x)
        return x if x_mask is None else x * x_mask


class Prenet(nn.Module):
    """Strided conv prenet with padding-mask propagation
    (reference: modules/fastspeech/pe.py:7-41). x [B, in_dim, T] ->
    (hidden, out), both [B, out_dim, T / prod(strides)]."""

    def __init__(self, in_dim=80, out_dim=256, kernel=5,
                 strides: Sequence[int] = (2, 1, 1)):
        super().__init__()
        self.strides = list(strides)
        self.layers = nn.ModuleList()
        for i, s in enumerate(self.strides):
            self.layers.append(nn.Sequential(
                nn.Conv1d(in_dim if i == 0 else out_dim, out_dim, kernel,
                          stride=s, padding=kernel // 2),
                nn.ReLU(),
                BatchNorm1d(out_dim, eps=BN_EPS)))
        self.out_proj = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        nonpadding = (x.abs().sum(1, keepdim=True) > 0).to(x.dtype)  # [B, 1, T]
        h = x
        for s, layer in zip(self.strides, self.layers):
            nonpadding = nonpadding[:, :, ::s]
            h = layer(h) * nonpadding
        return h, linear_ct(self.out_proj, h) * nonpadding
