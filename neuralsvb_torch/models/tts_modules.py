"""FastSpeech2 building blocks; port of ``neuralsvb_tpu/models/tts_modules.py``
(reference: modules/fastspeech/tts_modules.py:16-378): FFT blocks, the
duration, pitch and energy predictors and the length regulator.

The FFT blocks are attention layers and keep ``[B, T, C]``; the predictors'
convolutions run on ``[B, C, T]`` and their LayerNorm and dropout on
``[B, T, C]``, where the JAX package applies them. Submodules carry the JAX
module names (``layers.{i}`` for ``layer_{i}``, ``conv.{i}``/``ln.{i}`` for
``conv_{i}``/``ln_{i}``), so ``convert/jax2torch.py`` ``fs2_from_jax`` maps
a JAX parameter tree onto them. Every dropout draws its mask from the
``generator`` passed to ``forward`` (``models/common.py`` ``Dropout``).

Rounding: ``out2dur`` and ``length_regulator`` round half to even, as
``jnp.round``. With predicted durations the frame count is the durations'
sum unless the caller gives ``max_len`` (the JAX package passes the batch's
mel length at inference).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import LN_EPS, Dropout, Embedding, EncSALayer, SinusoidalPositionalEmbedding


def dense(in_dim: int, out_dim: int, bias: bool = True) -> nn.Linear:
    """Linear with the JAX package's ``dense`` init: xavier-uniform weight,
    zero bias (reference: common_layers.py:81-87)."""
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    nn.init.xavier_uniform_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class PredictorConvStack(nn.Module):
    """conv -> relu -> LayerNorm -> dropout per layer, then a Linear; padded
    frames (``x_masks``) zeroed after each layer and the Linear. x [B, T,
    idim] -> [B, T', odim] (the ``SAME`` padding of an even kernel drops one
    frame per layer, as in the JAX package)."""

    def __init__(self, idim: int, n_layers: int, n_chans: int, odim: int, kernel_size: int,
                 dropout_rate: float):
        super().__init__()
        k = kernel_size
        self.pad = ((k - 1) // 2, (k - 1) // 2)
        self.conv = nn.ModuleList([nn.Conv1d(idim if i == 0 else n_chans, n_chans, k)
                                   for i in range(n_layers)])
        self.ln = nn.ModuleList([nn.LayerNorm(n_chans, eps=LN_EPS) for _ in range(n_layers)])
        self.dropout = Dropout(dropout_rate)
        self.linear = nn.Linear(n_chans, odim)

    def forward(self, x, x_masks=None, generator: Optional[torch.Generator] = None):
        keep = None if x_masks is None else (~x_masks).to(x.dtype)[:, :, None]
        for conv, ln in zip(self.conv, self.ln):
            x = F.relu(conv(F.pad(x.transpose(1, 2), self.pad))).transpose(1, 2)
            x = self.dropout(ln(x), generator)
            if keep is not None:
                x = x * keep
        x = self.linear(x)
        return x if keep is None else x * keep


class DurationPredictor(nn.Module):
    """Log-domain duration predictor (reference: tts_modules.py:80-172):
    x [B, T, idim], x_masks [B, T] bool -> [B, T]."""

    def __init__(self, idim: int, n_layers: int = 2, n_chans: int = 384, kernel_size: int = 3,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.stack = PredictorConvStack(idim, n_layers, n_chans, 1, kernel_size, dropout_rate)

    def forward(self, xs, x_masks=None, generator=None):
        return self.stack(xs, x_masks, generator)[..., 0]

    @staticmethod
    def out2dur(xs_log: torch.Tensor) -> torch.Tensor:
        """Log durations -> frames: round(exp(x) - 1), at least 0."""
        return torch.clamp(torch.round(torch.exp(xs_log) - 1.0), min=0).long()


class PitchPredictor(nn.Module):
    """reference: tts_modules.py:213-256. x [B, T, idim] -> [B, T, odim]."""

    def __init__(self, idim: int, n_layers: int = 5, n_chans: int = 384, odim: int = 2,
                 kernel_size: int = 5, dropout_rate: float = 0.1):
        super().__init__()
        self.stack = PredictorConvStack(idim, n_layers, n_chans, odim, kernel_size, dropout_rate)

    def forward(self, xs, generator=None):
        return self.stack(xs, None, generator)


class EnergyPredictor(PitchPredictor):
    pass


def length_regulator(dur: torch.Tensor, dur_padding=None, alpha: float = 1.0,
                     max_len: Optional[int] = None) -> torch.Tensor:
    """Durations [B, T_txt] -> mel2ph [B, max_len] (1-based token index, 0
    past the last frame; reference: tts_modules.py:175-211). ``max_len``
    None: the longest total duration (a host value)."""
    dur = torch.round(dur.float() * alpha).long()
    if dur_padding is not None:
        dur = dur * (~dur_padding).long()
    B, T_txt = dur.shape
    if max_len is None:
        max_len = int(dur.sum(-1).max())
    token_idx = torch.arange(1, T_txt + 1, device=dur.device)[None, :, None]
    cum = torch.cumsum(dur, 1)
    prev = F.pad(cum, (1, 0))[:, :-1]
    pos = torch.arange(max_len, device=dur.device)[None, None]
    mask = (pos >= prev[:, :, None]) & (pos < cum[:, :, None])
    return (token_idx * mask.long()).sum(1)


def mel2ph_to_dur(mel2ph: torch.Tensor, T_txt: int) -> torch.Tensor:
    """mel2ph [B, T] -> per-token durations [B, T_txt] (reference:
    tts_modules.py:263-269); indices past ``T_txt`` count nowhere, as
    ``jax.nn.one_hot``'s."""
    m = torch.where(mel2ph <= T_txt, mel2ph, torch.zeros_like(mel2ph)).long()
    dur = torch.zeros(mel2ph.shape[0], T_txt + 1, dtype=torch.long, device=mel2ph.device)
    return dur.scatter_add(1, m, torch.ones_like(m))[:, 1:]


class FFTBlocks(nn.Module):
    """Transformer encoder stack with sinusoidal positions (reference:
    tts_modules.py:272-329). x [B, T, C]; without ``padding_mask`` a frame
    whose channels sum to 0 in absolute value is padding (the decoder's
    case)."""

    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 dropout: float = 0.1, num_heads: int = 2, use_pos_embed: bool = True):
        super().__init__()
        self.use_pos_embed = use_pos_embed
        self.pos = SinusoidalPositionalEmbedding(hidden_size)
        self.dropout = Dropout(dropout)
        self.layers = nn.ModuleList([
            EncSALayer(hidden_size, num_heads, dropout=dropout, kernel_size=ffn_kernel_size)
            for _ in range(num_layers)])
        self.last_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        if padding_mask is None:
            padding_mask = x.abs().sum(-1) == 0
        nonpadding = (~padding_mask).to(x.dtype)[:, :, None]
        if self.use_pos_embed:
            x = x + self.pos(~padding_mask).to(x.dtype)
        x = self.dropout(x, generator) * nonpadding
        for layer in self.layers:
            x = layer(x, padding_mask, generator) * nonpadding
        return self.last_norm(x) * nonpadding


class FastspeechEncoder(nn.Module):
    """Token embedding x sqrt(H), positions, dropout, then the FFT blocks
    (which drop out once more; reference: tts_modules.py:331-368).
    txt_tokens [B, T] -> [B, T, H]."""

    def __init__(self, dict_size: int, hidden_size: int = 256, num_layers: int = 4,
                 kernel_size: int = 9, num_heads: int = 2, dropout: float = 0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.embed_tokens = Embedding(dict_size, hidden_size, 0)
        self.pos = SinusoidalPositionalEmbedding(hidden_size)
        self.dropout = Dropout(dropout)
        self.blocks = FFTBlocks(hidden_size, num_layers, kernel_size, dropout, num_heads,
                                use_pos_embed=False)

    def forward(self, txt_tokens, generator: Optional[torch.Generator] = None):
        padding_mask = txt_tokens == 0
        x = self.embed_tokens(txt_tokens) * self.hidden_size ** 0.5
        x = x + self.pos(~padding_mask).to(x.dtype)
        x = self.dropout(x, generator) * (~padding_mask).to(x.dtype)[:, :, None]
        return self.blocks(x, padding_mask, generator)


class FastspeechDecoder(nn.Module):
    """FFT blocks over the frame-rate decoder input, padding from the input
    itself. x [B, T, H] -> [B, T, H]."""

    def __init__(self, hidden_size: int = 256, num_layers: int = 4, kernel_size: int = 9,
                 num_heads: int = 2, dropout: float = 0.1):
        super().__init__()
        self.blocks = FFTBlocks(hidden_size, num_layers, kernel_size, dropout, num_heads)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.blocks(x, None, generator)
