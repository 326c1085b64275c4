"""The flagship's SVB VAE (MleSVBVAE: a global latent and an MLE-trained z
map); port of the ``mle`` variant of ``SVBVAE`` in
``neuralsvb_tpu/models/svb_vae.py`` (reference:
modules/voice_conversion/svb_vae.py:13-478).

Conditions per side: pitch embedding -> ConvStacks, frozen-ASR PPG
upsampled x2, projected speaker embedding broadcast over time; fused by one
Linear (``encoded_embed_proj``). Ways: a2a and p2p reconstruct each side
from its posterior latent; a2p maps the amateur latent and decodes it on the
professional timeline with the amateur content gathered through the DTW
alignment.

``SVBVAE.forward`` takes mels ``[B, T, 80]`` and returns each way's
``mel_out`` as ``[B, T, 80]``; inside, everything is ``[B, C, T]`` and
latents are ``[B, latent, 1]``.

Training follows torch's module modes: ``model.train()`` puts every
BatchNorm into batch statistics except the frozen ASR's, which stays in
eval mode (the JAX package runs it with ``train=False`` always).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from .asr import VCASR
from .common import BN_EPS, BatchNorm1d, ConvStacks, Embedding, linear_ct
from .fvae import FVAE, GlobalLatentMap, normal_log_prob

WAYS = ("a2a", "p2p", "a2p")


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
    """Parameter names are the reference's
    (``vae_model.encoder.wn.in_layers.0.weight``, ...)."""

    mapping_keys = ("z_mapping_function",)  # the map step's parameters

    def __init__(self, hidden_size: int = 256, num_mel_bins: int = 80,
                 latent_size: int = 128, fvae_hidden: int = 192, fvae_kernel: int = 5,
                 fvae_enc_layers: int = 8, fvae_dec_layers: int = 4,
                 frames_multiple: int = 4, mel_strides: Sequence[int] = (2, 1, 1),
                 asr_enc_layers: int = 2, asr_last_norm: bool = False,
                 spk_emb_dim: int = 256):
        super().__init__()
        H = hidden_size
        self.pitch_embed = Embedding(300, H, 0)
        self.pitch_encoder = ConvStacks(H, n_layers=3, n_chans=H, odim=H)
        self.vc_asr = VCASR(H, asr_enc_layers, mel_strides, asr_last_norm=asr_last_norm,
                            num_mels=num_mel_bins)
        self.upsample_layer = CondUpsampler(H, mel_strides)
        self.spk_embed_proj = nn.Linear(spk_emb_dim, H)
        self.encoded_embed_proj = nn.Linear(3 * H, H)
        self.vae_model = FVAE(num_mel_bins, fvae_hidden, latent_size, fvae_kernel,
                              fvae_enc_layers, fvae_dec_layers, H, frames_multiple)
        self.z_mapping_function = GlobalLatentMap(latent_size, H)

    def train(self, mode: bool = True):
        super().train(mode)
        self.vc_asr.eval()  # frozen: never batch statistics
        return self

    # ------------------------------------------------------------------
    @torch.no_grad()
    def extract_ppg(self, mel, exact_lengths: bool = True):
        """The frozen ASR's content rows for mel [B, 80, T] -> [B, H, T / 2];
        padded (zero) frames come back as zero rows."""
        return self.vc_asr(mel, exact_lengths)["h_content"]

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

    def normal_vae(self, tgt_mel, conds, generator=None, zero_noise=False):
        cond = self._cond_sum(conds["h_pitch"], conds["h_content"],
                              conds["h_style"], mask=conds["tgt_nonpadding"])
        return self.vae_model(tgt_mel, conds["tgt_nonpadding"], cond,
                              generator=generator, zero_noise=zero_noise)

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
        ret: Dict[str, Dict[str, torch.Tensor]] = {}
        if "a2a" in ways:
            ret["a2a"] = self.normal_vae(mel_a, conds_a, generator, zero_noise)
        if "p2p" in ways:
            ret["p2p"] = self.normal_vae(mel_p, conds_p, generator, zero_noise)
        if "a2p" in ways:
            ret["a2p"] = self._a2p(ret["a2a"], ret["p2p"], conds_a, conds_p,
                                   a2p_alignment, disable_map)
        for out in ret.values():
            out["mel_out"] = out["mel_out"].transpose(1, 2)
        return ret

    def _gathered_cond(self, conds_a, conds_p, a2p_alignment):
        """Condition on the professional timeline: prof pitch, amateur PPG
        gathered through the DTW alignment, amateur style."""
        T_p = conds_p["h_pitch"].shape[-1]
        h = conds_a["h_content"]
        idx = a2p_alignment[:, None, :].expand(-1, h.shape[1], -1)
        gathered = torch.gather(h, 2, idx)
        style = conds_a["h_style"][:, :, :1].expand(-1, -1, T_p)
        return self._cond_sum(conds_p["h_pitch"], gathered, style,
                              mask=conds_p["tgt_nonpadding"])

    def _a2p(self, a2a_out, p2p_out, conds_a, conds_p, a2p_alignment, disable_map):
        cond_a2p = self._gathered_cond(conds_a, conds_p, a2p_alignment)
        z_a = a2a_out["z_q"]
        z_map = z_a if disable_map else self.z_mapping_function(z_a, conds_a["h_style"])
        logp = normal_log_prob(z_map, p2p_out["m_q"], p2p_out["logs_q"])
        return {
            "mle": (-(logp.sum()) / (z_map.shape[0] * 1)
                    / z_map.shape[1]),
            "mel_out": self.vae_model.decoder(z_map, conds_p["tgt_nonpadding"], cond_a2p),
            "logs_amateur_zq": z_a,
            "logs_prof_zq": p2p_out["z_q"],
        }
