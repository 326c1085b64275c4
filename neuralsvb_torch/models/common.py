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
    exact zeros when ``zero_noise`` (deterministic mean decoding)."""
    if zero_noise:
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    if generator is None:
        raise ValueError("pass a torch.Generator, or zero_noise=True")
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """Leaky ReLU whose derivative at exactly 0 is 1, as ``jax.nn.leaky_relu``'s
    (torch's is the slope). Zero-padded inputs through convs with zero biases
    (flax's init) put values exactly at 0."""
    return torch.where(x >= 0, x, x * slope)


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
    raises. In eval the running statistics apply."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    if not bn.training:
        mean, var = bn.running_mean.view(shape), bn.running_var.view(shape)
    else:
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims, keepdim=True)
        var = ((x * x).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean.detach().flatten(), alpha=m)
            bn.running_var.mul_(1 - m).add_(var.detach().flatten(), alpha=m)
            bn.num_batches_tracked.add_(1)
    y = (x - mean) * torch.rsqrt(var + bn.eps)
    return y * bn.weight.view(shape) + bn.bias.view(shape)


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
    (flax ``GroupNorm(mask=...)``), so padded batches match unpadded runs."""
    B, C, T = x.shape
    G = norm.num_groups
    xg = x.reshape(B, G, C // G, T)
    m = mask[:, None].to(x.dtype)  # [B, 1, 1, T]
    n = (m.sum((2, 3), keepdim=True) * (C // G)).clamp_min(1.0)
    mean = (xg * m).sum((2, 3), keepdim=True) / n
    var = (((xg - mean) ** 2) * m).sum((2, 3), keepdim=True) / n
    y = ((xg - mean) * torch.rsqrt(var + norm.eps)).reshape(B, C, T)
    return y * norm.weight[None, :, None] + norm.bias[None, :, None]


class ConvNorm(nn.Module):
    """Conv1d with symmetric 'same' padding (reference ConvNorm)."""

    def __init__(self, c_in, c_out, kernel_size=1, stride=1, dilation=1):
        super().__init__()
        pad = (dilation * (kernel_size - 1)) // 2
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, stride=stride,
                              padding=pad, dilation=dilation)

    def forward(self, x):
        return self.conv(x)


class ConvBlock(nn.Module):
    """conv -> GroupNorm (masked statistics) -> ReLU (reference:
    common_layers.py:736-772; dropout is inactive at inference)."""

    def __init__(self, c_in, c_out, kernel_size=3, stride=1):
        super().__init__()
        self.conv = ConvNorm(c_in, c_out, kernel_size, stride)
        self.norm = nn.GroupNorm(c_out // 16, c_out, eps=LN_EPS)

    def forward(self, x, x_mask):
        return F.relu(masked_group_norm(self.conv(x), x_mask, self.norm))


class ConvStacks(nn.Module):
    """Residual conv stack (reference: common_layers.py:672-707).
    x [B, idim, T] -> [B, odim, T]; ``x_mask`` [B, 1, T] re-zeroes padded
    frames after every layer."""

    def __init__(self, idim, n_layers=5, n_chans=256, odim=32, kernel_size=5):
        super().__init__()
        self.in_proj = nn.Linear(idim, n_chans)
        self.conv = nn.ModuleList(
            [ConvBlock(n_chans, n_chans, kernel_size) for _ in range(n_layers)])
        self.out_proj = nn.Linear(n_chans, odim)

    def forward(self, x, x_mask):
        x = linear_ct(self.in_proj, x) * x_mask
        for blk in self.conv:
            x = x + blk(x, x_mask) * x_mask
        return linear_ct(self.out_proj, x) * x_mask


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


class MultiheadAttention(nn.Module):
    """Dot-product attention over ``num_heads`` heads without biases, key
    mask or k/v cache: the JAX package's ``MultiheadAttention`` as the
    seg-tech SVB VAE calls it (reference: common_layers.py:167-485). q is
    scaled by ``Dh**-0.5`` after its projection; logits and softmax run in
    at least float32. The weights are returned, so the product is written
    out rather than left to a fused attention call."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(channels, channels, bias=False)
        self.k_proj = nn.Linear(channels, channels, bias=False)
        self.v_proj = nn.Linear(channels, channels, bias=False)
        self.out_proj = nn.Linear(channels, channels, bias=False)

    def forward(self, query, key, value):
        """query [B, Tq, C]; key, value [B, Tk, C] -> (out [B, Tq, C],
        weights [B, heads, Tq, Tk])."""
        B, Tq, C = query.shape
        H = self.num_heads
        Dh = C // H

        def split(x):
            return x.reshape(B, x.shape[1], H, Dh).transpose(1, 2)

        acc = torch.promote_types(query.dtype, torch.float32)
        q = split(self.q_proj(query) * Dh ** -0.5).to(acc)
        k, v = split(self.k_proj(key)).to(acc), split(self.v_proj(value))
        weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        out = (weights @ v.to(acc)).to(query.dtype).transpose(1, 2).reshape(B, Tq, C)
        return self.out_proj(out), weights
