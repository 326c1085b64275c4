"""The SVB VAE family; port of ``SVBVAE`` in
``neuralsvb_tpu/models/svb_vae.py`` with its five variants (reference:
modules/voice_conversion/svb_vae.py:13-478): ``mle`` (MleSVBVAE, the
flagship: a global latent and an MLE-trained z map), ``tech_mle`` (the MLE
variant with the technique prior N(0, 1) amateur / N(1, 1) professional),
``seg_tech_mle`` (the technique prior with the amateur PPG aligned to the
professional timeline by attention), ``global`` (GlobalSVBVAE: mean and
scale maps, KL against the professional posterior) and ``local`` (SVBVAE:
a frame-level latent and k3 latent maps on the alignment shrunk to the
latent rate).

Conditions per side: pitch embedding -> ConvStacks, frozen-ASR PPG
upsampled x2, projected speaker embedding broadcast over time; fused by one
Linear (``encoded_embed_proj``). Ways: a2a and p2p reconstruct each side
from its posterior latent; a2p maps the amateur latent and decodes it on the
professional timeline with the amateur content gathered through the DTW
alignment (the attention-aligned content for ``seg_tech_mle``).

``SVBVAE.forward`` takes mels ``[B, T, 80]`` and returns each way's
``mel_out`` (and ``a2p_sample_recon``) as ``[B, T, 80]``; inside,
everything is ``[B, C, T]`` and latents are ``[B, latent, Tz]``.

Training follows torch's module modes: ``model.train()`` puts every
BatchNorm into batch statistics except the frozen ASR's, which stays in
eval mode (the JAX package runs it with ``train=False`` always); the
latent-map step sets ``model.eval()`` and the maps' ``train()``.

Under a ``torch.profiler`` session the model records the spans
``svb.cond`` (a side's condition), ``svb.asr`` (the frozen ASR),
``svb.vae`` (a way's FVAE) and ``svb.map`` (the a2p way)
(``utils/profiling.py`` ``span``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..parallel import ddp
from ..utils.profiling import span
from .asr import VCASR
from .common import (BN_EPS, BatchNorm1d, ConvStacks, Embedding, MultiheadAttention,
                     draw_normal, linear_ct)
from .fvae import FVAE, GlobalLatentMap, LatentMap, gaussian_kl, normal_log_prob

WAYS = ("a2a", "p2p", "a2p")
MLE_VARIANTS = ("mle", "tech_mle", "seg_tech_mle")
VARIANTS = ("local", "global") + MLE_VARIANTS


class CondUpsampler(nn.Sequential):
    """Nearest x-scale upsample + conv + ReLU + BN per stride > 1, then a
    final k=5 conv (reference: svb_vae.py:38-45); a Sequential so the
    parameter names are the reference's (``upsample_layer.0.1.weight``).
    Padded frames are re-zeroed after each conv."""

    def __init__(self, hidden_size: int, mel_strides: Sequence[int] = (2, 1, 1)):
        H = hidden_size
        stages = [nn.Sequential(nn.Upsample(scale_factor=s, mode="nearest"),
                                nn.Conv1d(H, H, 2 * s + 1, padding=s), nn.ReLU(),
                                BatchNorm1d(H, eps=BN_EPS))
                  for s in mel_strides if s > 1]
        super().__init__(*stages, nn.Conv1d(H, H, 5, padding=2))

    def forward(self, x):
        """x [B, H, T] -> [B, H, T * prod(strides > 1)]."""
        mask = (x.abs().sum(1, keepdim=True) > 0).to(x.dtype)
        *stages, conv_out = self
        for up, conv, relu, bn in stages:
            x = up(x)
            mask = up(mask)
            x = bn(relu(conv(x))) * mask
        return conv_out(x) * mask


class SVBVAE(nn.Module):
    """``variant``: one of ``VARIANTS``; ``mle`` is the flagship's
    MleSVBVAE. Parameter names are the reference's
    (``vae_model.encoder.wn.in_layers.0.weight``, ...); the seg variant's
    attention modules are named after their JAX module paths
    (``k_mel_encoder_0``, ``seg_ref_attn.q_proj``)."""

    def __init__(self, dict_size: int, hidden_size: int = 256,
                 num_mel_bins: int = 80, latent_size: int = 128,
                 fvae_hidden: int = 192, fvae_kernel: int = 5,
                 fvae_enc_layers: int = 8, fvae_dec_layers: int = 4,
                 frames_multiple: int = 4, mel_strides: Sequence[int] = (2, 1, 1),
                 asr_enc_layers: int = 2, asr_last_norm: bool = False,
                 spk_emb_dim: int = 256, variant: str = "mle", use_prior_glow: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
        if use_prior_glow:
            # the JAX model builds its FVAE without glow widths
            # (neuralsvb_tpu/models/svb_vae.py:84-90), so its first forward
            # through a way fails: a Conv of None features in the prior flow
            raise ValueError(
                "use_prior_glow: the JAX SVBVAE passes no glow_hidden, "
                "glow_kernel_size or glow_n_blocks to its FVAE "
                "(neuralsvb_tpu/models/svb_vae.py:84-90; fvae.py:179-183) and fails at its "
                "first forward, so there is no result to match; models/fvae.py FVAE takes "
                "the prior flow with explicit widths")
        if variant == "local" and latent_size != 16:
            raise ValueError("the local variant's LatentMap adds a 16-channel speaker "
                             f"projection to the latent: latent_size must be 16, not "
                             f"{latent_size}")
        self.variant = variant
        self.frames_multiple = frames_multiple
        H = hidden_size
        self.pitch_embed = Embedding(300, H, 0)
        self.pitch_encoder = ConvStacks(H, n_layers=3, n_chans=H, odim=H)
        self.vc_asr = VCASR(dict_size, H, asr_enc_layers, mel_strides,
                            asr_last_norm=asr_last_norm, num_mels=num_mel_bins)
        self.upsample_layer = CondUpsampler(H, mel_strides)
        self.spk_embed_proj = nn.Linear(spk_emb_dim, H)
        self.encoded_embed_proj = nn.Linear(3 * H, H)
        self.vae_model = FVAE(num_mel_bins, fvae_hidden, latent_size, fvae_kernel,
                              fvae_enc_layers, fvae_dec_layers, H, frames_multiple,
                              global_latent=variant != "local")
        if variant in MLE_VARIANTS:
            self.z_mapping_function = GlobalLatentMap(latent_size, H)
        else:
            latent_map = LatentMap if variant == "local" else GlobalLatentMap
            self.m_mapping_function = latent_map(latent_size, H)
            self.logs_mapping_function = latent_map(latent_size, H)
        if variant == "seg_tech_mle":
            # attention-based PPG alignment (reference: svb_vae.py:402-478)
            self.k_mel_encoder_0 = nn.Conv1d(num_mel_bins, H, 1)
            self.k_mel_encoder_bn = BatchNorm1d(H, eps=BN_EPS)
            self.k_mel_encoder_1 = nn.Conv1d(H, H, 1)
            self.seg_ref_attn = MultiheadAttention(H, 4)

    @property
    def mapping_keys(self):
        """The latent maps' module names: the map step's parameters."""
        if self.variant in MLE_VARIANTS:
            return ("z_mapping_function",)
        return ("m_mapping_function", "logs_mapping_function")

    def train(self, mode: bool = True):
        super().train(mode)
        self.vc_asr.eval()  # frozen: never batch statistics
        return self

    # ------------------------------------------------------------------
    @span("svb.asr")
    @torch.no_grad()
    def extract_ppg(self, mel, exact_lengths: bool = True):
        """The frozen ASR's content rows for mel [B, 80, T] -> [B, H, T / 2];
        padded (zero) frames come back as zero rows."""
        return self.vc_asr(mel, exact_lengths)["h_content"]

    @span("svb.cond")
    def prepare_condition(self, mel, pitch, spk_emb, exact_lengths: bool = True,
                          ppg=None):
        """mel [B, 80, T]; pitch [B, T] int; spk_emb [B, 256]; ``ppg``:
        precomputed content rows [B, H, T / 2] (the PPG cache), else the
        frozen ASR runs here (reference: svb_vae.py:60-86)."""
        T = pitch.shape[1]
        tgt_nonpadding = (pitch > 0).to(mel.dtype)[:, None, :]  # [B, 1, T]
        h_pitch = self.pitch_encoder(self.pitch_embed(pitch).transpose(1, 2),
                                     x_mask=tgt_nonpadding)
        ppg = self.extract_ppg(mel, exact_lengths) if ppg is None else ppg.detach()
        h_content = self.upsample_layer(ppg)[:, :, :T]
        h_style = linear_ct(self.spk_embed_proj, spk_emb[:, :, None]).expand(-1, -1, T)
        return dict(h_pitch=h_pitch, h_content=h_content, h_style=h_style,
                    tgt_nonpadding=tgt_nonpadding)

    def _cond_sum(self, h_pitch, h_content, h_style, mask):
        cond = linear_ct(self.encoded_embed_proj,
                         torch.cat([h_pitch, h_content, h_style], 1))
        # zero the condition at padded frames (h_style is nonzero there), so
        # the strided g_pre_net does not smear padding into valid frames
        return cond * mask

    @span("svb.vae")
    def normal_vae(self, tgt_mel, conds, generator=None, zero_noise=False,
                   prior_mean=0.0):
        cond = self._cond_sum(conds["h_pitch"], conds["h_content"],
                              conds["h_style"], mask=conds["tgt_nonpadding"])
        return self.vae_model(tgt_mel, conds["tgt_nonpadding"], cond,
                              generator=generator, zero_noise=zero_noise,
                              prior_mean=prior_mean)

    def get_aligned_ppg(self, src_ppg, src_mel, alignment):
        """The amateur content [B, H, T_a] gathered through the alignment
        [B, T_p] and refined by attention over the amateur frames, keyed by
        the amateur mel [B, 80, T_a] (reference: svb_vae.py:413-420) ->
        ([B, H, T_p], weights [B, 4, T_p, T_a]). No key mask: padded amateur
        frames take part, as in the JAX package."""
        idx = alignment[:, None, :].expand(-1, src_ppg.shape[1], -1)
        gathered = torch.gather(src_ppg, 2, idx)
        k = self.k_mel_encoder_1(self.k_mel_encoder_bn(
            torch.relu(self.k_mel_encoder_0(src_mel))))
        out, weights = self.seg_ref_attn(gathered.transpose(1, 2), k.transpose(1, 2),
                                         src_ppg.transpose(1, 2))
        return out.transpose(1, 2), weights

    def forward(self, amateur_mel, prof_mel, amateur_pitch, prof_pitch, spk_emb,
                a2p_alignment, disable_map: bool = False,
                generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, ways: Sequence[str] = WAYS,
                exact_lengths: Optional[bool] = None, ppg_a=None,
                ppg_p=None) -> Dict[str, Dict[str, torch.Tensor]]:
        """Mels [B, T, 80]; pitch [B, T] int; spk_emb [B, 256] (the amateur
        speaker embedding serves both sides, as in the reference task);
        a2p_alignment [B, T_p] int indexes amateur frames. Runs ``ways`` (a2p
        needs a2a and p2p); returns {way: outputs}, ``mel_out`` [B, T, 80].
        ``exact_lengths`` (default: not training) picks the frozen ASR's
        rel-pos semantics; ``ppg_a``/``ppg_p`` are cached content rows."""
        if "a2p" in ways and not {"a2a", "p2p"} <= set(ways):
            raise ValueError(f"the a2p way needs a2a and p2p; got {tuple(ways)}")
        if exact_lengths is None:
            exact_lengths = not self.training
        mel_a = amateur_mel.transpose(1, 2)
        mel_p = prof_mel.transpose(1, 2)
        conds_a = self.prepare_condition(mel_a, amateur_pitch, spk_emb,
                                         exact_lengths, ppg_a)
        conds_p = self.prepare_condition(mel_p, prof_pitch, spk_emb,
                                         exact_lengths, ppg_p)
        # the technique prior N(tech_id, 1): amateur 0, professional 1
        # (reference: vae_models.py:196-200 TechPriorGlobalFVAE)
        prior_a, prior_p = (0.0, 1.0) if self.variant in ("tech_mle", "seg_tech_mle") \
            else (0.0, 0.0)
        ret: Dict[str, Dict[str, torch.Tensor]] = {}
        if "a2a" in ways:
            ret["a2a"] = self.normal_vae(mel_a, conds_a, generator, zero_noise, prior_a)
        if "p2p" in ways:
            conds = conds_p
            if self.variant == "seg_tech_mle":
                aligned, attn = self.get_aligned_ppg(conds_a["h_content"], mel_a,
                                                     a2p_alignment)
                conds = dict(conds_p, h_content=aligned)
                # a2p decodes with the same attention-aligned content
                conds_a = dict(conds_a, h_content_aligned=aligned)
            ret["p2p"] = self.normal_vae(mel_p, conds, generator, zero_noise, prior_p)
            if self.variant == "seg_tech_mle":
                ret["p2p"]["attn"] = attn
        if "a2p" in ways:
            ret["a2p"] = self._a2p(ret["a2a"], ret["p2p"], conds_a, conds_p,
                                   a2p_alignment, disable_map, generator, zero_noise)
        for out in ret.values():
            for key in ("mel_out", "a2p_sample_recon"):
                if key in out:
                    out[key] = out[key].transpose(1, 2)
        return ret

    def _gathered_cond(self, conds_a, conds_p, a2p_alignment):
        """Condition on the professional timeline: prof pitch, amateur PPG
        gathered through the DTW alignment (or attention-aligned), amateur
        style."""
        T_p = conds_p["h_pitch"].shape[-1]
        if "h_content_aligned" in conds_a:
            gathered = conds_a["h_content_aligned"]
        else:
            h = conds_a["h_content"]
            idx = a2p_alignment[:, None, :].expand(-1, h.shape[1], -1)
            gathered = torch.gather(h, 2, idx)
        style = conds_a["h_style"][:, :, :1].expand(-1, -1, T_p)
        return self._cond_sum(conds_p["h_pitch"], gathered, style,
                              mask=conds_p["tgt_nonpadding"])

    @span("svb.map")
    def _a2p(self, a2a_out, p2p_out, conds_a, conds_p, a2p_alignment,
             disable_map, generator=None, zero_noise=False):
        cond_a2p = self._gathered_cond(conds_a, conds_p, a2p_alignment)
        mask_p, style_a = conds_p["tgt_nonpadding"], conds_a["h_style"]
        decoder = self.vae_model.decoder
        if self.variant in MLE_VARIANTS:
            z_a = a2a_out["z_q"]
            z_map = z_a if disable_map else self.z_mapping_function(z_a, style_a)
            logp = normal_log_prob(z_map, p2p_out["m_q"], p2p_out["logs_q"])
            return {
                "mle": (-ddp.all_sum(logp.sum()) / (z_map.shape[0] * ddp.shard_world())
                        / z_map.shape[1]),
                "mel_out": decoder(z_map, mask_p, cond_a2p),
                "logs_amateur_zq": z_a,
                "logs_prof_zq": p2p_out["z_q"],
            }
        m_a, logs_a = a2a_out["m_q"], a2a_out["logs_q"]
        if self.variant == "local":
            # shrink the frame alignment to the latent rate (svb_vae.py:116-121)
            fm = self.frames_multiple
            shrink = (a2p_alignment[:, ::fm] // fm).clamp(0, m_a.shape[-1] - 1)
            idx = shrink[:, None, :].expand(-1, m_a.shape[1], -1)
            m_a, logs_a = torch.gather(m_a, 2, idx), torch.gather(logs_a, 2, idx)
        if disable_map:
            m_map, logs_map = m_a, logs_a
        else:
            m_map = self.m_mapping_function(m_a, style_a)
            logs_map = self.logs_mapping_function(logs_a, style_a)
        kl = gaussian_kl(m_map, logs_map, p2p_out["m_q"], p2p_out["logs_q"])
        if self.variant == "local":
            msk = p2p_out["x_mask_sqz"]
            kl = ddp.all_sum((kl * msk).sum()) / ddp.all_sum(msk.sum()) / kl.shape[1]
        else:
            kl = ddp.all_sum(kl.sum()) / (kl.shape[0] * ddp.shard_world()) / kl.shape[1]
        eps = draw_normal(m_map.shape, m_map, generator, zero_noise)
        return {
            "kl": kl,
            "mel_out": decoder(m_map, mask_p, cond_a2p),
            "a2p_sample_recon": decoder(m_map + eps * torch.exp(logs_map), mask_p,
                                        cond_a2p),
        }
