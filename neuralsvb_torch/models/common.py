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

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import ddp

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
    return ddp.draw_rows(lambda s: torch.randn(s, generator=generator, dtype=like.dtype,
                                               device=like.device), tuple(shape))


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
    u = ddp.draw_rows(lambda s: torch.rand(s, generator=generator, dtype=torch.float32,
                                           device=generator.device), tuple(shape))
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
    # the world's mean of the ranks' means: every rank holds as many rows
    # (ddp.local_batch)
    stats = ddp.all_sum(torch.stack([x.mean(dims), (x * x).mean(dims)])) / ddp.shard_world()
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

    def __init__(self, c_in, c_out, kernel_size=1, stride=1, dilation=1):
        super().__init__()
        pad = (dilation * (kernel_size - 1)) // 2
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, stride=stride,
                              padding=pad, dilation=dilation)

    def forward(self, x):
        return self.conv(x)


class InstanceNorm1d(nn.Module):
    """Affine instance norm over time with flax's epsilon 1e-5 (the JAX
    ``ConvBlock``'s ``in``); with ``x_mask`` the moments cover valid frames
    only."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, x_mask):
        n = x_mask.sum(-1, keepdim=True).clamp_min(1.0)
        mean = (x * x_mask).sum(-1, keepdim=True) / n
        var = (((x - mean) ** 2) * x_mask).sum(-1, keepdim=True) / n
        y = (x - mean) * torch.rsqrt(var + BN_EPS)
        return y * self.weight[None, :, None] + self.bias[None, :, None]


class ConvBlock(nn.Module):
    """conv -> norm -> ReLU -> dropout (reference:
    common_layers.py:736-772). ``norm``: ``gn`` (GroupNorm of 16-channel
    groups), ``bn`` (BatchNorm), ``in`` (affine instance norm) or ``none``.
    With ``x_mask`` the GroupNorm and instance-norm statistics cover the
    valid frames only; without, every frame, padding included."""

    def __init__(self, c_in, c_out, kernel_size=3, stride=1, dropout=0.0, norm: str = "gn"):
        super().__init__()
        self.conv = ConvNorm(c_in, c_out, kernel_size, stride)
        self.norm_type = norm
        if norm == "gn":
            self.norm = nn.GroupNorm(c_out // 16, c_out, eps=LN_EPS)
        elif norm == "bn":
            self.norm = BatchNorm1d(c_out, eps=BN_EPS)
        elif norm == "in":
            self.norm = InstanceNorm1d(c_out)
        elif norm != "none":
            raise ValueError(f"ConvBlock norm {norm!r}: gn, bn, in or none")
        self.dropout = Dropout(dropout)

    def forward(self, x, x_mask=None, generator=None):
        x = self.conv(x)
        if x_mask is None:
            x_mask = torch.ones_like(x[:, :1])
        if self.norm_type == "gn":
            x = masked_group_norm(x, x_mask, self.norm)
        elif self.norm_type == "bn":
            x = self.norm(x)
        elif self.norm_type == "in":
            x = self.norm(x, x_mask)
        return self.dropout(F.relu(x), generator)


class ConvStacks(nn.Module):
    """Conv stack (reference: common_layers.py:672-707).
    x [B, idim, T] -> [B, odim, T / prod(strides)]; ``x_mask`` [B, 1, T]
    re-zeroes padded frames after every layer (None: no masking, as the
    JAX package's PPG models call it). A layer of stride 1 adds to its input
    when ``res``; a strided layer, or any layer without ``res``, replaces it
    (and subsamples the mask)."""

    def __init__(self, idim, n_layers=5, n_chans=256, odim=32, kernel_size=5,
                 dropout=0.0, strides: Optional[Sequence[int]] = None, res: bool = True,
                 norm: str = "gn"):
        super().__init__()
        self.strides = list(strides) if strides is not None else [1] * n_layers
        self.res = res
        self.in_proj = nn.Linear(idim, n_chans)
        self.conv = nn.ModuleList(
            [ConvBlock(n_chans, n_chans, kernel_size, s, dropout=dropout, norm=norm)
             for s in self.strides])
        self.out_proj = nn.Linear(n_chans, odim)

    def forward(self, x, x_mask=None, generator=None):
        x = linear_ct(self.in_proj, x)
        if x_mask is not None:
            x = x * x_mask
        for s, blk in zip(self.strides, self.conv):
            if x_mask is not None and s > 1:
                x_mask = x_mask[:, :, ::s]
            h = blk(x, x_mask, generator)
            if x_mask is not None:
                h = h * x_mask
            x = x + h if (self.res and s == 1) else h
        x = linear_ct(self.out_proj, x)
        return x if x_mask is None else x * x_mask


class ConvGlobalStacks(nn.Module):
    """Strided conv stack and a temporal mean: the reference encoder
    (reference: common_layers.py:710-733). x [B, idim, T] -> [B, odim]; the
    mean spans the padded length, as in the JAX package and the reference.
    Five blocks of kernel 5 at stride 2, the JAX package's defaults."""

    def __init__(self, idim, n_chans=256, odim=32):
        super().__init__()
        self.in_proj = nn.Linear(idim, n_chans)
        self.conv = nn.ModuleList([ConvBlock(n_chans, n_chans, 5, 2) for _ in range(5)])
        self.out_proj = nn.Linear(n_chans, odim)

    def forward(self, x):
        x = linear_ct(self.in_proj, x)
        for blk in self.conv:
            x = blk(x)
        return self.out_proj(x.mean(-1))


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
    """Dot-product attention over ``num_heads`` heads: the JAX package's
    ``MultiheadAttention`` without its k/v cache (reference:
    common_layers.py:167-485). q is scaled by ``Dh**-0.5`` after its
    projection; logits and softmax run in at least float32. An additive
    ``attn_mask`` is added to the logits, then ``key_padding_mask`` (True =
    padded key) sets them to the dtype's lowest value, so a query row whose
    keys are all masked comes out uniform, not NaN; the weights are
    returned. The product is written out rather than left to a fused
    attention call, which differs on fully masked rows. No projection has a
    bias. ``dropout`` acts on the weights in training mode (the FS2 FFT
    blocks' ``attention_dropout``), with a mask from the ``generator``
    passed to ``forward``; the ASR runs in eval mode and the seg-tech
    attention's rate is 0.

    ``fused_in_proj`` keeps q/k/v in one ``in_proj_weight`` [3C, C], the
    reference's fairseq layout that the JAX package's ``convert_vcasr``
    reads (the ASR decoder head); otherwise ``q_proj``/``k_proj``/
    ``v_proj`` (the seg-tech SVB VAE's names)."""

    def __init__(self, channels: int, num_heads: int, fused_in_proj: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.fused_in_proj = fused_in_proj
        self.attn_dropout = Dropout(dropout)
        if fused_in_proj:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
            nn.init.xavier_uniform_(self.in_proj_weight)
        else:
            self.q_proj = nn.Linear(channels, channels, bias=False)
            self.k_proj = nn.Linear(channels, channels, bias=False)
            self.v_proj = nn.Linear(channels, channels, bias=False)
        self.out_proj = nn.Linear(channels, channels, bias=False)

    def _proj(self, x, i: int):
        if not self.fused_in_proj:
            return (self.q_proj, self.k_proj, self.v_proj)[i](x)
        C = x.shape[-1]
        return F.linear(x, self.in_proj_weight[i * C:(i + 1) * C])

    def forward(self, query, key, value, key_padding_mask=None, attn_mask=None,
                generator: Optional[torch.Generator] = None):
        """query [B, Tq, C]; key, value [B, Tk, C]; ``key_padding_mask``
        [B, Tk] bool; ``attn_mask`` additive, broadcast to [B, heads, Tq, Tk]
        -> (out [B, Tq, C], weights [B, heads, Tq, Tk], after dropout)."""
        B, Tq, C = query.shape
        H = self.num_heads
        Dh = C // H

        def split(x):
            return x.reshape(B, x.shape[1], H, Dh).transpose(1, 2)

        acc = torch.promote_types(query.dtype, torch.float32)
        q = split(self._proj(query, 0) * Dh ** -0.5).to(acc)
        k, v = split(self._proj(key, 1)).to(acc), split(self._proj(value, 2))
        logits = q @ k.transpose(-1, -2)
        if attn_mask is not None:
            logits = logits + attn_mask
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        weights = self.attn_dropout(torch.softmax(logits, dim=-1), generator)
        out = (weights @ v.to(acc)).to(query.dtype).transpose(1, 2).reshape(B, Tq, C)
        return self.out_proj(out), weights


def causal_mask(T: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive [T, T] mask: the dtype's lowest value above the diagonal."""
    return torch.triu(torch.full((T, T), torch.finfo(dtype).min, dtype=dtype,
                                 device=device), diagonal=1)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """The fairseq-style table of the JAX package (reference:
    common_layers.py:89-148) for an even ``dim``: half sin, half cos, row p
    for position p; row 0 (padding) is not zeroed."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = np.exp(np.arange(half) * -emb)
    pos = np.arange(length)[:, None] * freqs[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], -1).astype(np.float32)


class SinusoidalPositionalEmbedding(nn.Module):
    """Non-pad steps count from ``padding_idx + 1``, pad steps read row
    ``padding_idx``: positions ``cumsum(nonpad) * nonpad + padding_idx`` into
    a table of length ``T + padding_idx + 2`` (JAX: common.py:213-226)."""

    def __init__(self, dim: int, padding_idx: int = 0):
        super().__init__()
        self.dim = dim
        self.padding_idx = padding_idx

    def forward(self, nonpad_mask):
        """nonpad_mask [B, T] bool -> [B, T, dim] float32."""
        mask = nonpad_mask.long()
        positions = torch.cumsum(mask, -1) * mask + self.padding_idx
        T = nonpad_mask.shape[1]
        table = torch.from_numpy(sinusoidal_positions(T + self.padding_idx + 2, self.dim))
        return table.to(nonpad_mask.device)[positions]


class TransformerFFNLayer(nn.Module):
    """Conv-in FFN (reference: common_layers.py:487-521): conv of kernel k
    over ``SAME`` padding (k // 2 before, (k - 1) // 2 after: the FS2 FFT
    blocks) or ``LEFT`` padding (the last k steps: the ASR decoder), x
    ``k**-0.5``, gelu (the tanh approximation, as flax's), dropout of
    ``dropout`` (relu dropout) in training mode, Linear. Parameter names
    are the reference's: ``ffn_1.1`` behind the pad and ``ffn_2``."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int,
                 padding: str = "LEFT", dropout: float = 0.0):
        super().__init__()
        if padding not in ("SAME", "LEFT"):
            raise ValueError(f"padding {padding!r}: SAME or LEFT")
        self.kernel_size = kernel_size
        pad = ((kernel_size // 2, (kernel_size - 1) // 2) if padding == "SAME"
               else (kernel_size - 1, 0))
        self.ffn_1 = nn.Sequential(nn.ConstantPad1d(pad, 0.0),
                                   nn.Conv1d(hidden_size, filter_size, kernel_size))
        self.dropout = Dropout(dropout)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x [B, T, C] -> [B, T, C]."""
        h = self.ffn_1(x.transpose(1, 2)).transpose(1, 2) * self.kernel_size ** -0.5
        return self.ffn_2(self.dropout(F.gelu(h, approximate="tanh"), generator))


class EncSALayer(nn.Module):
    """Pre-norm self-attention and ``SAME``-padded conv FFN encoder layer
    (reference: common_layers.py:543-589; JAX: common.py:325-354), over
    [B, T, C]: ``dropout`` after each sublayer, 0.1 on the attention weights
    and in the FFN (the JAX layer's defaults, which every caller keeps),
    each in training mode; padded frames are zeroed after each residual."""

    def __init__(self, hidden_size: int, num_heads: int, dropout: float = 0.0,
                 kernel_size: int = 9):
        super().__init__()
        C = hidden_size
        self.layer_norm1 = nn.LayerNorm(C, eps=LN_EPS)
        self.self_attn = MultiheadAttention(C, num_heads, dropout=0.1)
        self.layer_norm2 = nn.LayerNorm(C, eps=LN_EPS)
        self.ffn = TransformerFFNLayer(C, 4 * C, kernel_size, "SAME", dropout=0.1)
        self.dropout = Dropout(dropout)

    def forward(self, x, padding_mask, generator: Optional[torch.Generator] = None):
        """x [B, T, C]; padding_mask [B, T] bool (True = padded)."""
        keep = (~padding_mask).to(x.dtype)[:, :, None]
        h = self.layer_norm1(x)
        h = self.self_attn(h, h, h, key_padding_mask=padding_mask, generator=generator)[0]
        x = (x + self.dropout(h, generator)) * keep
        h = self.ffn(self.layer_norm2(x), generator)
        return (x + self.dropout(h, generator)) * keep


class DecSALayer(nn.Module):
    """Pre-norm causal self-attention, encoder attention and a LEFT-padded
    FFN of kernel 9 (reference: common_layers.py:592-669), over [B, T, C];
    without dropout, as the ASR runs in eval mode."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        C = hidden_size
        self.layer_norm1 = nn.LayerNorm(C, eps=LN_EPS)
        self.self_attn = MultiheadAttention(C, num_heads, fused_in_proj=True)
        self.layer_norm2 = nn.LayerNorm(C, eps=LN_EPS)
        self.encoder_attn = MultiheadAttention(C, num_heads, fused_in_proj=True)
        self.layer_norm3 = nn.LayerNorm(C, eps=LN_EPS)
        self.ffn = TransformerFFNLayer(C, 4 * C, 9)

    def forward(self, x, encoder_out, encoder_padding_mask=None, self_attn_mask=None,
                self_attn_padding_mask=None):
        """-> (x, the encoder attention's weights)."""
        h = self.layer_norm1(x)
        x = x + self.self_attn(h, h, h, self_attn_padding_mask, self_attn_mask)[0]
        h = self.layer_norm2(x)
        h, attn = self.encoder_attn(h, encoder_out, encoder_out, encoder_padding_mask)
        x = x + h
        return x + self.ffn(self.layer_norm3(x)), attn
