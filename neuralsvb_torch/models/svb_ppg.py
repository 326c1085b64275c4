"""PPG regression models; port of ``neuralsvb_tpu/models/svb_ppg.py``
(reference: modules/voice_conversion/vc_ppg.py:7-102, svb_ppg.py:8-114):
``VCPPG`` (speech voice conversion, the ASR pre-training recipe's model),
``SVBPPG`` (+ a technique embedding) and ``ParaSVBPPG`` (+ the PPG gathered
through the DTW alignment).

Conditions: pitch embedding -> ConvStacks, the ASR's PPG upsampled x2, the
quantised energy's embedding, a style vector (the reference encoder over
the timbre mel, a speaker id's embedding, or speaker embedding 0 of the
parallel task) and the technique embedding, fused by one Linear; then a
conv decoder and a linear mel head. Mels are ``[B, T, 80]`` at the
boundary and ``[B, C, T]`` inside.

The ASR runs in eval mode whatever the model's mode, as the JAX package
applies it with ``train=False`` in every task of this family: no dropout,
its BatchNorms on their running statistics, which nothing updates. Its PPG
into the decoder runs without gradients (the exact-length rel-pos in eval,
the collate-length one in training); only ``train_vc_asr``'s CE loss
trains it, at exact lengths.

``decoder_type: fft`` decodes through the FS2 family's
``FastspeechDecoder`` (FFT blocks over ``[B, T, C]``), ``conv`` through a
conv stack.

The SVBPara subclasses' variants (JAX: svb_ppg.py:93-117,173-216):
``ParaPPGPreExp`` (``pre_exp``) gathers the raw mel through the alignment
before the ASR; ``ParaAlignedPPG`` and ``ParaPPGConstraint``
(``aligned_asr``) realign the content rows inside the ASR
(``models/asr.py`` ``realign``) and skip the gather after the upsampler.
``ref_attn`` adds a banded attention over the timbre mel to the decoder's
input: a stride-8 ``ConvStacks`` (strides 2, 2, 2, 1, 1, no residual, no
norm) encodes the keys, and query frame t sees key k only where
``|t - 8k| < 32`` (an additive mask of 0 and -1e9), four heads; it acts
only without ``use_spk_id``. ``asr_enc_type: conv`` gives the ASR a conv
content encoder.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .asr import VCASR
from .common import ConvGlobalStacks, ConvStacks, Embedding, MultiheadAttention, linear_ct
from .svb_vae import CondUpsampler
from .tts_modules import FastspeechDecoder

REF_ATTN_HEADS = 4
REF_ATTN_STRIDE, REF_ATTN_BAND = 8, 32  # keys every 8 frames, |t - 8k| < 32


def ref_attn_mask(q_len: int, kv_len: int, dtype, device) -> torch.Tensor:
    """The additive banded mask [q_len, kv_len] of ``ref_attn``: 0 where
    ``|t - 8k| < 32``, -1e9 elsewhere (JAX: svb_ppg.py:160-163)."""
    band = (torch.arange(q_len, device=device)[:, None]
            - REF_ATTN_STRIDE * torch.arange(kv_len, device=device)[None, :])
    inside = (band < REF_ATTN_BAND) & (band > -REF_ATTN_BAND)
    return torch.where(inside, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), -1e9, dtype=dtype, device=device))


def gather_frames(x: torch.Tensor, conversion_alignment: torch.Tensor) -> torch.Tensor:
    """x [B, C, T] -> x[:, :, alignment] [B, C, T'] per batch row."""
    return torch.gather(x, 2, conversion_alignment[:, None, :].expand(-1, x.shape[1], -1))


class VCPPG(nn.Module):
    def __init__(self, dict_size: int, hidden_size: int = 256, num_mel_bins: int = 80,
                 mel_strides: Sequence[int] = (2, 1, 1), asr_enc_layers: int = 2,
                 asr_dec_layers: int = 2, asr_last_norm: bool = False,
                 ref_enc_out: int = 256, use_energy: bool = True, use_spk_id: bool = False,
                 num_spk: int = 100, use_tech: bool = False, num_techs: int = 3,
                 decoder_type: str = "conv", dec_layers: int = 4, dropout: float = 0.05,
                 dec_ffn_kernel_size: int = 9, num_heads: int = 2,
                 ref_attn: bool = False, asr_enc_type: str = "conformer",
                 para: bool = False, pre_exp: bool = False, aligned_asr: bool = False,
                 spk_emb_dim: int = 256):
        super().__init__()
        if decoder_type not in ("conv", "fft"):
            raise ValueError(f"decoder_type {decoder_type!r}: conv or fft")
        H = hidden_size
        self.use_energy, self.use_spk_id, self.use_tech, self.para = (
            use_energy, use_spk_id, use_tech, para)
        self.pre_exp, self.aligned_asr, self.ref_attn = pre_exp, aligned_asr, ref_attn
        self.pitch_embed = Embedding(300, H, 0)
        self.pitch_encoder = ConvStacks(H, n_layers=3, n_chans=H, odim=H)
        self.vc_asr = VCASR(dict_size, H, asr_enc_layers, mel_strides,
                            asr_last_norm=asr_last_norm, num_mels=num_mel_bins,
                            asr_dec_layers=asr_dec_layers, with_decoder=True,
                            asr_enc_type=asr_enc_type)
        self.upsample_layer = CondUpsampler(H, mel_strides)
        if use_energy:
            self.energy_embed = Embedding(256, H, 0)
        if use_spk_id:
            self.spk_embed = nn.Embedding(num_spk, ref_enc_out)
        else:
            self.ref_encoder = ConvGlobalStacks(num_mel_bins, n_chans=ref_enc_out,
                                                odim=ref_enc_out)
        if use_tech:
            self.tech_embed = nn.Embedding(num_techs, H)
        if ref_attn:
            self.ref_attn_kv_encoder = ConvStacks(
                num_mel_bins, n_layers=5, n_chans=H, odim=H, strides=(2, 2, 2, 1, 1),
                res=False, norm="none")
            self.ref_attn_mha = MultiheadAttention(H, REF_ATTN_HEADS)
        # the parallel task's style is speaker embedding 0 of multi_spk_emb
        style = spk_emb_dim if para and not use_spk_id else ref_enc_out
        self.encoded_embed_proj = nn.Linear(
            2 * H + H * use_energy + style + H * use_tech, H)
        self.decoder_type = decoder_type
        self.decoder = (FastspeechDecoder(H, dec_layers, dec_ffn_kernel_size, num_heads, dropout)
                        if decoder_type == "fft" else
                        ConvStacks(H, n_layers=dec_layers, n_chans=H, odim=H, dropout=dropout))
        self.mel_out = nn.Linear(H, num_mel_bins)

    def train(self, mode: bool = True):
        super().train(mode)
        self.vc_asr.train(False)  # see the module's docstring
        return self

    def _ppg(self, mels_content, conversion_alignment, T: int):
        """The ASR's content rows without gradients, upsampled, optionally
        gathered onto the target timeline -> [B, H, <= T] (before the ASR
        with ``pre_exp``, inside it with ``aligned_asr``, else after the
        upsampler)."""
        mel = mels_content.transpose(1, 2)
        if self.pre_exp and conversion_alignment is not None:
            mel, conversion_alignment = gather_frames(mel, conversion_alignment), None
        with torch.no_grad():
            h = self.vc_asr(mel, exact_lengths=not self.training,
                            conversion_alignment=(conversion_alignment if self.aligned_asr
                                                  else None))["h_content"]
        h = self.upsample_layer(h)
        if self.para and not self.aligned_asr and conversion_alignment is not None:
            h = gather_frames(h[:, :, : mel.shape[-1]], conversion_alignment)
        return h[:, :, :T]

    def forward(self, mels_content, mels_timbre=None, pitch=None, energy=None,
                spk_ids=None, tech_ids=None, conversion_alignment=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """mels [B, T, 80]; pitch [B, T] int; energy [B, T]; spk_ids [B] int
        or, for the parallel model, multi_spk_emb [B, K, 256]; tech_ids [B]
        int; conversion_alignment [B, T] int -> dict with ``mel_out``
        [B, T, 80] and the conditions ([B, C, T])."""
        ret: Dict[str, Any] = {}
        B, T = pitch.shape
        h_pitch = self.pitch_encoder(self.pitch_embed(pitch).transpose(1, 2))
        ret["h_pitch"] = h_pitch
        embeds = [h_pitch]
        h_content = self._ppg(mels_content, conversion_alignment, T)
        if h_content.shape[-1] < T:
            h_content = F.pad(h_content, (0, T - h_content.shape[-1]))
        ret["h_content"] = h_content
        embeds.append(h_content)
        if self.use_energy and energy is not None:
            e = torch.div(energy * 256, 4, rounding_mode="floor").long().clamp(0, 255)
            ret["h_energy"] = h_energy = self.energy_embed(e).transpose(1, 2)
            embeds.append(h_energy)
        if self.use_spk_id:
            style = self.spk_embed(spk_ids)
        elif self.para and spk_ids is not None and spk_ids.dim() == 3:
            style = spk_ids[:, 0]
        else:
            style = self.ref_encoder(mels_timbre.transpose(1, 2))
        ret["h_style"] = h_style = style[:, :, None].expand(-1, -1, T)
        embeds.append(h_style)
        if self.use_tech and tech_ids is not None:
            embeds.append(self.tech_embed(tech_ids)[:, :, None].expand(-1, -1, T))
        ret["dec_inputs"] = dec_inputs = linear_ct(self.encoded_embed_proj,
                                                   torch.cat(embeds, 1))
        if self.ref_attn and not self.use_spk_id:
            kv = self.ref_attn_kv_encoder(mels_timbre.transpose(1, 2)).transpose(1, 2)
            mask = ref_attn_mask(T, kv.shape[1], dec_inputs.dtype, dec_inputs.device)
            attn, _ = self.ref_attn_mha(dec_inputs.transpose(1, 2), kv, kv, attn_mask=mask,
                                        generator=generator)
            dec_inputs = dec_inputs + attn.transpose(1, 2)
        nonpadding = (pitch > 0).to(dec_inputs.dtype)[:, None, :]
        if self.decoder_type == "fft":
            x = self.decoder(dec_inputs.transpose(1, 2), generator).transpose(1, 2)
        else:
            x = self.decoder(dec_inputs, None, generator)
        ret["mel_out"] = (linear_ct(self.mel_out, x) * nonpadding).transpose(1, 2)
        return ret

    def train_vc_asr(self, mels, tokens, conversion_alignment=None, with_hidden: bool = False):
        """Teacher-forced token logits [B, L, dict_size] of ``tokens`` [B, L]
        from mels [B, T, 80] (JAX: svb_ppg.py:173-192), at exact lengths.
        ``pre_exp`` gathers the mel through ``conversion_alignment`` first,
        ``aligned_asr`` realigns the content rows inside the ASR (else the
        alignment is unused). ``with_hidden`` also returns the content rows
        [B, T', H] the decoder attended to, with their gradient."""
        mel = mels.transpose(1, 2)
        if self.pre_exp and conversion_alignment is not None:
            mel, conversion_alignment = gather_frames(mel, conversion_alignment), None
        prev_tokens = F.pad(tokens[:, :-1], (1, 0))  # shifted right, 0 first
        out = self.vc_asr(mel, exact_lengths=True, prev_tokens=prev_tokens,
                          conversion_alignment=(conversion_alignment if self.aligned_asr
                                                else None))
        if with_hidden:
            return out["tokens"], out["h_content"].transpose(1, 2)
        return out["tokens"]


class SVBPPG(VCPPG):
    """+ technique embedding (reference: svb_ppg.py:8-61)."""

    def __init__(self, dict_size: int, **kw):
        kw.setdefault("use_tech", True)
        super().__init__(dict_size, **kw)


class ParaSVBPPG(SVBPPG):
    """PPG gathered through the DTW alignment (reference: svb_ppg.py:63-114)."""

    def __init__(self, dict_size: int, **kw):
        kw.setdefault("para", True)
        super().__init__(dict_size, **kw)


class ParaPPGPreExp(ParaSVBPPG):
    """Raw mel gathered before the ASR (reference: svb_ppg.py:117-175)."""

    def __init__(self, dict_size: int, **kw):
        kw.setdefault("pre_exp", True)
        super().__init__(dict_size, **kw)


class ParaAlignedPPG(ParaSVBPPG):
    """PPG repeated x stride, gathered, mean-pooled inside the ASR
    (reference: svb_ppg.py:178-249)."""

    def __init__(self, dict_size: int, **kw):
        kw.setdefault("aligned_asr", True)
        super().__init__(dict_size, **kw)


class ParaPPGConstraint(ParaAlignedPPG):
    """``ParaAlignedPPG`` whose task reads ``train_vc_asr``'s content rows
    for the PPG constraint loss."""
