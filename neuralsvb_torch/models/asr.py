"""ASR-based PPG (phonetic posteriorgram) extractor and its transformer
decoder head; port of ``neuralsvb_tpu/models/asr.py`` (reference:
modules/voice_conversion/vc_modules.py:56-80, modules/asr/seq2seq.py:10-102).

mel -> strided Prenet (T/2 with mel_strides [2, 1, 1]) -> Conformer content
encoder -> ``h_content``. With ``with_decoder`` the model also carries
``token_embed`` and ``asr_decoder``, which turn the previous tokens into
token logits attending to ``h_content`` (the ASR pre-training loss). The
flagship's frozen extractor is built without them, so its ``state_dict``
keys are those of every checkpoint the port has written; a checkpoint with
the decoder loads into it with the decoder's keys skipped.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from .common import (LN_EPS, DecSALayer, Embedding, Prenet, SinusoidalPositionalEmbedding,
                     causal_mask)
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


class VCASR(nn.Module):
    def __init__(self, dict_size: int, hidden_size: int = 256,
                 asr_enc_layers: int = 2, mel_strides: Sequence[int] = (2, 1, 1),
                 asr_last_norm: bool = False, num_mels: int = 80,
                 asr_dec_layers: int = 2, with_decoder: bool = False):
        super().__init__()
        self.dict_size = dict_size  # token vocabulary of the decoder head
        self.mel_prenet = Prenet(num_mels, hidden_size, strides=mel_strides)
        self.content_encoder = ConformerLayers(
            hidden_size, asr_enc_layers, kernel_size=31,
            use_last_norm=asr_last_norm)
        if with_decoder:
            self.token_embed = Embedding(dict_size, hidden_size, 0)
            self.asr_decoder = TransformerASRDecoder(hidden_size, asr_dec_layers, dict_size)

    def forward(self, mel, exact_lengths: bool = True, prev_tokens=None):
        """mel [B, num_mels, T] -> {'h_content': [B, H, T / stride]} and,
        given ``prev_tokens`` [B, L], 'tokens' logits [B, L, dict_size] and
        'asr_attn'; ``exact_lengths`` selects the conformer's rel-pos
        semantics."""
        _, h = self.mel_prenet(mel)
        h = self.content_encoder(h.transpose(1, 2), exact_lengths)
        ret = {"h_content": h.transpose(1, 2)}
        if prev_tokens is not None:
            ret["tokens"], ret["asr_attn"] = self.asr_decoder(
                self.token_embed(prev_tokens), h)
        return ret
