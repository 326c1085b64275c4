"""ESPnet-style Conformer encoder with relative positional attention; port
of ``neuralsvb_tpu/models/conformer.py`` (reference:
modules/fastspeech/conformer/conformer.py:9-78, conformer/layers.py:7-260,
modules/commons/espnet_positional_embedding.py:89-112,
modules/commons/espnet_transformer_attn.py:106-186).

Attention works in ``[B, T, C]`` as ESPnet does; the convolution module
transposes to ``[B, C, T]`` and back. Inference uses the exact-length
semantics (``exact_lengths=True``): every example gets the rel-pos table
and rel-shift of its true length, so a padded batch reproduces the
reference's unpadded (bs=1) run. Training on padded batches uses the
reference's collate-length semantics (``exact_lengths=False``): one legacy
reversed table of the padded length and the plain rel-shift.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BN_EPS, LN_EPS, BatchNorm1d


def rel_positional_encoding(T: int, dim: int, max_len: int = 5000) -> np.ndarray:
    """The legacy ESPnet RelPositionalEncoding table: a REVERSED table of
    length max(max_len, T), positions L-1 ... 0, of which the first T rows
    are read (reference: espnet_positional_embedding.py:23-45,100-112)."""
    L = max(max_len, T)
    pos = np.arange(L - 1, -1, -1.0)[:T, None]
    div = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    pe = np.zeros((T, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _rel_shift(x):
    """ESPnet rel_shift: pad a zero column, reshape, drop the first row
    (the part of ``_rel_shift_exact`` for offsets <= 0)."""
    B, H, T1, T2 = x.shape
    x_padded = torch.cat([x.new_zeros(B, H, T1, 1), x], -1)
    return x_padded.reshape(B, H, T2 + 1, T1)[:, :, 1:].reshape(B, H, T1, T2)


def _rel_shift_exact(bd, n):
    """Reference-exact rel-shift under padding (see ``_rel_shift_exact`` in
    the JAX module for the derivation): for true length n the legacy shift
    gives bd[a, (n-1) + d] for offsets d = b - a <= 0, 0 at d == 1, and the
    next query row re-indexed, bd[a+1, d-2], for d >= 2."""
    B, H, T, _ = bd.shape
    part1 = _rel_shift(bd)
    bd_r = torch.cat([bd[:, :, 1:], torch.zeros_like(bd[:, :, :1])], dim=2)
    padded = F.pad(bd_r, (0, T))
    flat = padded.reshape(B, H, 2 * T * T)[:, :, : T * (2 * T - 1)]
    skew = flat.reshape(B, H, T, 2 * T - 1)  # skew[a, j] = bd_r[a, j - a]
    s = (T - n).clamp(0, T)[:, None]  # [B, 1]
    j = torch.arange(T, device=bd.device)
    idx = j[None, :] + s - 2  # [B, T]
    gidx = idx.clamp(0, 2 * T - 2)[:, None, None, :].expand(B, H, T, T)
    part2 = torch.gather(skew, -1, gidx) * (idx >= 0)[:, None, None, :].to(bd.dtype)
    d = (j[None, :] - j[:, None])[None, None]
    return torch.where(d <= 0, part1,
                       torch.where(d == 1, torch.zeros_like(part2), part2))


class RelPositionMultiHeadedAttention(nn.Module):
    """Transformer-XL style attention with position biases u/v."""

    def __init__(self, num_heads: int, channels: int):
        super().__init__()
        self.h = num_heads
        self.d_k = channels // num_heads
        self.linear_q = nn.Linear(channels, channels)
        self.linear_k = nn.Linear(channels, channels)
        self.linear_v = nn.Linear(channels, channels)
        self.linear_out = nn.Linear(channels, channels)
        self.linear_pos = nn.Linear(channels, channels, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def forward(self, x, pos_emb, mask, exact_lengths: bool = True):
        """x [B, T, C]; pos_emb [B or 1, T, C]; mask [B, 1, T] True = valid."""
        B, T, C = x.shape
        H, Dh = self.h, self.d_k
        q = self.linear_q(x).view(B, T, H, Dh)
        k = self.linear_k(x).view(B, T, H, Dh).transpose(1, 2)
        v = self.linear_v(x).view(B, T, H, Dh).transpose(1, 2)
        p = self.linear_pos(pos_emb).view(pos_emb.shape[0], T, H, Dh).transpose(1, 2)
        q_u = (q + self.pos_bias_u).transpose(1, 2)  # [B, H, T, Dh]
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        matrix_ac = q_u @ k.transpose(-1, -2)
        matrix_bd = q_v @ p.transpose(-1, -2)
        matrix_bd = (_rel_shift_exact(matrix_bd, mask[:, 0].sum(-1)) if exact_lengths
                     else _rel_shift(matrix_bd))
        scores = (matrix_ac + matrix_bd) / math.sqrt(Dh)
        keep = mask[:, None]  # [B, 1, 1, T]
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, -1).masked_fill(~keep, 0.0)
        out = (attn @ v).transpose(1, 2).reshape(B, T, C)
        return self.linear_out(out)


class ConvolutionModule(nn.Module):
    """pointwise -> GLU -> depthwise -> BN -> swish -> pointwise."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size,
                                        padding=(kernel_size - 1) // 2,
                                        groups=channels)
        self.norm = BatchNorm1d(channels, eps=BN_EPS)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        """x [B, T, C] -> [B, T, C]."""
        h = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        h = F.silu(self.norm(self.depthwise_conv(h)))
        return self.pointwise_conv2(h).transpose(1, 2)


class MultiLayeredConv1d(nn.Module):
    """Positionwise two-conv FFN (kernel 1), applied over [B, T, C]."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.w_1 = nn.Conv1d(channels, hidden, 1)
        self.w_2 = nn.Conv1d(hidden, channels, 1)

    def forward(self, x):
        h = F.relu(F.linear(x, self.w_1.weight[:, :, 0], self.w_1.bias))
        return F.linear(h, self.w_2.weight[:, :, 0], self.w_2.bias)


class ConformerEncoderLayer(nn.Module):
    """Macaron FFN + rel-pos MHA + conv module + FFN, all pre-norm."""

    def __init__(self, hidden_size: int, kernel_size: int, num_heads: int = 4):
        super().__init__()
        C = hidden_size
        self.feed_forward_macaron = MultiLayeredConv1d(C, 4 * C)
        self.self_attn = RelPositionMultiHeadedAttention(num_heads, C)
        self.conv_module = ConvolutionModule(C, kernel_size)
        self.feed_forward = MultiLayeredConv1d(C, 4 * C)
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff",
                     "norm_final"):
            setattr(self, name, nn.LayerNorm(C, eps=LN_EPS))

    def forward(self, x, pos_emb, mask, exact_lengths: bool = True):
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, mask, exact_lengths)
        # zero padded frames so the depthwise conv sees the implicit zero
        # padding of an unpadded run
        h = self.norm_conv(x) * mask.transpose(1, 2).to(x.dtype)
        x = x + self.conv_module(h)
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class ConformerLayers(nn.Module):
    """Stack of conformer layers over [B, T, C]; padding is inferred from
    all-zero frames like the reference (conformer.py:47)."""

    def __init__(self, hidden_size: int, num_layers: int, kernel_size: int = 31,
                 num_heads: int = 4, use_last_norm: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.encoder_layers = nn.ModuleList(
            [ConformerEncoderLayer(hidden_size, kernel_size, num_heads)
             for _ in range(num_layers)])
        self.layer_norm = (nn.LayerNorm(hidden_size, eps=LN_EPS) if use_last_norm
                           else nn.Linear(hidden_size, hidden_size))

    def _pos_emb_per_example(self, n_valid, T, max_len=5000):
        """The legacy rel-pos table built per example for its TRUE length:
        arg = (T-1-j) + (max(max_len, n) - n) gives the exact-length table
        whatever the padding (see the JAX module)."""
        dim = self.hidden_size
        dev = n_valid.device
        i = torch.arange(T, dtype=torch.float32, device=dev)
        n = n_valid.to(torch.float32)
        L_ref = torch.clamp(n, min=float(max_len))
        arg = (T - 1 - i)[None, :] + (L_ref - n)[:, None]  # [B, T]
        div = torch.from_numpy(
            np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
            .astype(np.float32)).to(dev)
        ang = arg[:, :, None] * div  # [B, T, D/2]
        return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(
            ang.shape[0], T, dim)

    def forward(self, x, exact_lengths: bool = True):
        """x [B, T, C] -> [B, T, C], zero at padded frames. ``exact_lengths``
        False: the collate-length table and plain shift of batched training."""
        nonpadding = x.abs().sum(-1) > 0  # [B, T]
        mask = nonpadding[:, None, :]
        T = x.shape[1]
        if exact_lengths:
            pos_emb = self._pos_emb_per_example(nonpadding.sum(-1), T)
        else:
            pos_emb = torch.from_numpy(
                rel_positional_encoding(T, self.hidden_size)).to(x.device)[None]
        pos_emb = pos_emb.to(x.dtype)
        h = x * math.sqrt(self.hidden_size)
        for layer in self.encoder_layers:
            h = layer(h, pos_emb, mask, exact_lengths)
        h = self.layer_norm(h)
        return h * nonpadding[:, :, None].to(h.dtype)
