"""ASR-based PPG (phonetic posteriorgram) extractor and its transformer
decoder head; port of ``neuralsvb_tpu/models/asr.py`` (reference:
modules/voice_conversion/vc_modules.py:56-80, modules/asr/seq2seq.py:10-102).

mel -> strided Prenet (T/2 with mel_strides [2, 1, 1]) -> Conformer content
encoder (``asr_enc_type: conformer``) or a residual ``ConvStacks`` of five
GroupNorm blocks (``conv``) -> ``h_content``. A ``conversion_alignment``
realigns the content rows onto the target timeline inside the ASR
(``realign``, the reference's AlignedVCASR). With ``with_decoder`` the model also carries
``token_embed`` and ``asr_decoder``, which turn the previous tokens into
token logits attending to ``h_content`` (the ASR pre-training loss). The
flagship's frozen extractor is built without them, so its ``state_dict``
keys are those of every checkpoint the port has written; a checkpoint with
the decoder loads into it with the decoder's keys skipped.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (LN_EPS, ConvStacks, DecSALayer, Embedding, Prenet,
                     SinusoidalPositionalEmbedding, causal_mask)
from .conformer import ConformerLayers


ASR_HEADS = 2  # the decoder head's attention heads, the JAX package's default


class TransformerDecoderLayer(nn.Module):
    """The reference's wrapper (``layers.{i}.op``) around one ``DecSALayer``."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.op = DecSALayer(hidden_size, ASR_HEADS)


class TransformerASRDecoder(nn.Module):
    """Causal transformer decoder over token embeddings attending to
    ``h_content`` (reference: modules/asr/seq2seq.py:10-102). Its masks
    come from the inputs, as in the JAX package: a token row or content
    frame whose features sum to 0 in absolute value is padding. The JAX
    package applies it with ``train=False`` only, so it has no dropout."""

    def __init__(self, hidden_size: int, num_layers: int, out_dim: int):
        super().__init__()
        self.embed_positions = SinusoidalPositionalEmbedding(hidden_size)
        self.layers = nn.ModuleList([TransformerDecoderLayer(hidden_size)
                                     for _ in range(num_layers)])
        self.layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.project_out_dim = nn.Linear(hidden_size, out_dim, bias=False)

    def forward(self, dec_inputs, encoder_out):
        """dec_inputs [B, L, H]; encoder_out [B, S, H] -> (logits [B, L,
        out_dim], the encoder attention's weights of each layer)."""
        self_pad = dec_inputs.abs().sum(-1) == 0
        enc_pad = encoder_out.abs().sum(-1) == 0
        x = dec_inputs + self.embed_positions(~self_pad).to(dec_inputs.dtype)
        mask = causal_mask(x.shape[1], x.dtype, x.device)
        attn_logits = []
        for layer in self.layers:
            x, attn = layer.op(x, encoder_out, enc_pad, mask, self_pad)
            attn_logits.append(attn)
        return self.project_out_dim(self.layer_norm(x)), attn_logits


def realign(h_content: torch.Tensor, conversion_alignment: torch.Tensor,
            stride: int) -> torch.Tensor:
    """Content rows [B, H, S] onto the target timeline (JAX:
    ``neuralsvb_tpu/models/asr.py:89-103``; reference AlignedVCASR,
    svb_ppg.py:178-196): repeat each row ``stride`` times, gather the frames
    of the alignment [B, T] (clipped to the repeated length), zero-pad by
    ``(-T) % stride + stride`` and mean-pool by ``stride`` -> [B, H,
    ceil(T / stride) + 1]. The extra ``+ stride`` of the JAX package's pad
    makes one more pooled row than ``ceil(T / stride)``, all zeros: the ASR
    decoder's mask reads it as padding, and callers cut it off."""
    rep = h_content.repeat_interleave(stride, dim=-1)
    idx = conversion_alignment.clamp(0, rep.shape[-1] - 1)
    g = torch.gather(rep, 2, idx[:, None, :].expand(-1, rep.shape[1], -1))
    g = F.pad(g, (0, (-g.shape[-1]) % stride + stride))
    B, H, T = g.shape
    return g.reshape(B, H, T // stride, stride).mean(-1)


class VCASR(nn.Module):
    def __init__(self, dict_size: int, hidden_size: int = 256,
                 asr_enc_layers: int = 2, mel_strides: Sequence[int] = (2, 1, 1),
                 asr_last_norm: bool = False, num_mels: int = 80,
                 asr_dec_layers: int = 2, with_decoder: bool = False,
                 asr_enc_type: str = "conformer"):
        super().__init__()
        if asr_enc_type not in ("conformer", "conv"):
            raise ValueError(f"asr_enc_type {asr_enc_type!r}: conformer or conv")
        self.dict_size = dict_size  # token vocabulary of the decoder head
        self.asr_enc_type = asr_enc_type
        self.stride = 1
        for s in mel_strides:
            self.stride *= int(s)
        self.mel_prenet = Prenet(num_mels, hidden_size, strides=mel_strides)
        self.content_encoder = (
            ConformerLayers(hidden_size, asr_enc_layers, kernel_size=31,
                            use_last_norm=asr_last_norm)
            if asr_enc_type == "conformer" else
            ConvStacks(hidden_size, n_chans=hidden_size, odim=hidden_size))
        if with_decoder:
            self.token_embed = Embedding(dict_size, hidden_size, 0)
            self.asr_decoder = TransformerASRDecoder(hidden_size, asr_dec_layers, dict_size)

    def forward(self, mel, exact_lengths: bool = True, prev_tokens=None,
                conversion_alignment=None):
        """mel [B, num_mels, T] -> {'h_content': [B, H, T / stride]} and,
        given ``prev_tokens`` [B, L], 'tokens' logits [B, L, dict_size] and
        'asr_attn'; ``exact_lengths`` selects the conformer's rel-pos
        semantics. With ``conversion_alignment`` [B, T'] the content rows
        are ``realign``ed first ([B, H, ceil(T' / stride) + 1])."""
        _, h = self.mel_prenet(mel)
        if self.asr_enc_type == "conformer":
            h = self.content_encoder(h.transpose(1, 2), exact_lengths).transpose(1, 2)
        else:
            h = self.content_encoder(h)
        if conversion_alignment is not None:
            h = realign(h, conversion_alignment, self.stride)
        ret = {"h_content": h}
        if prev_tokens is not None:
            ret["tokens"], ret["asr_attn"] = self.asr_decoder(
                self.token_embed(prev_tokens), h.transpose(1, 2))
        return ret
