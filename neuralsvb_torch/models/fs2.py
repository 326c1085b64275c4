"""FastSpeech2: text -> mel with duration, pitch and energy predictors; port
of ``neuralsvb_tpu/models/fs2.py`` (reference: modules/fastspeech/fs2.py:21-255).

Phone tokens go through the FFT encoder, expand to frames through
``mel2ph`` (ground truth, or the length regulator over the predicted
durations), take the pitch embedding (frame f0 with uv, or the CWT
spectrum's f0 with ``pitch_type: cwt``) and optionally the energy
embedding, and decode through FFT blocks (``decoder_type: fft``) or a conv
stack (``conv``) into a linear mel head. The predictors see their inputs
through ``predictor_grad`` (``x.detach() + g * (x - x.detach())``).

Inputs and outputs are ``[B, T]`` / ``[B, T, C]`` as in the JAX package.
f0 normalization, its coarse quantization and the CWT inversion run on the
device inside the graph (``ops/pitch_utils.py``, ``ops/cwt.py``). Module
names follow the JAX modules', so ``convert/jax2torch.py`` ``fs2_from_jax``
loads a JAX parameter tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cwt import cwt_scales, inverse_cwt
from ..ops.pitch_utils import denorm_f0, f0_to_coarse, norm_f0
from .common import ConvStacks, Embedding
from .tts_modules import (DurationPredictor, EnergyPredictor, FastspeechDecoder,
                          FastspeechEncoder, PitchPredictor, dense, length_regulator)


def scale_grad(x: torch.Tensor, g: float) -> torch.Tensor:
    """x forward, g x its gradient backward."""
    return x.detach() + g * (x - x.detach())


class FastSpeech2(nn.Module):
    def __init__(self, dict_size: int, hidden_size: int = 256, enc_layers: int = 4,
                 dec_layers: int = 4, enc_ffn_kernel_size: int = 9, dec_ffn_kernel_size: int = 9,
                 num_heads: int = 2, out_dims: int = 80, decoder_type: str = "fft",
                 use_spk_id: bool = False, use_spk_embed: bool = False, num_spk: int = 100,
                 use_pitch_embed: bool = True, use_energy_embed: bool = False,
                 use_uv: bool = True, pitch_type: str = "frame", predictor_hidden: int = -1,
                 predictor_kernel: int = 5, predictor_layers: int = 2,
                 dur_predictor_kernel: int = 3, dur_predictor_layers: int = 2,
                 predictor_dropout: float = 0.5, predictor_grad: float = 0.0,
                 dropout: float = 0.1, cwt_hidden_size: int = 128, cwt_std_scale: float = 0.8,
                 f0_mean: float = 220.0, f0_std: float = 60.0, pitch_norm: str = "standard",
                 spk_embed_dim: int = 256):
        super().__init__()
        if decoder_type not in ("fft", "conv"):
            raise ValueError(f"decoder_type {decoder_type!r}: fft or conv")
        H = hidden_size
        ph = predictor_hidden if predictor_hidden > 0 else H
        self.hidden_size, self.decoder_type, self.pitch_type = H, decoder_type, pitch_type
        self.use_spk_id, self.use_spk_embed = use_spk_id, use_spk_embed
        self.use_pitch_embed, self.use_energy_embed, self.use_uv = (
            use_pitch_embed, use_energy_embed, use_uv)
        self.predictor_grad, self.cwt_std_scale = predictor_grad, cwt_std_scale
        self.hp = {"pitch_norm": pitch_norm, "f0_mean": f0_mean, "f0_std": f0_std,
                   "use_uv": use_uv}
        self.encoder = FastspeechEncoder(dict_size, H, enc_layers, enc_ffn_kernel_size,
                                         num_heads, dropout)
        if use_spk_embed:
            self.spk_embed_proj = dense(spk_embed_dim, H)
        elif use_spk_id:
            self.spk_embed_proj = nn.Embedding(num_spk + 1, H)
            nn.init.normal_(self.spk_embed_proj.weight, 0.0, H ** -0.5)
        self.dur_predictor = DurationPredictor(H, dur_predictor_layers, ph, dur_predictor_kernel,
                                               predictor_dropout)
        if use_pitch_embed:
            if pitch_type == "cwt":
                self.cwt_in = dense(H, cwt_hidden_size)
                self.cwt_predictor = PitchPredictor(cwt_hidden_size, predictor_layers, ph,
                                                    10 + int(use_uv), predictor_kernel,
                                                    predictor_dropout)
                self.cwt_stats_0 = dense(H, cwt_hidden_size)
                self.cwt_stats_1 = dense(cwt_hidden_size, cwt_hidden_size)
                self.cwt_stats_2 = dense(cwt_hidden_size, 2)
            else:
                self.pitch_predictor = PitchPredictor(H, predictor_layers, ph,
                                                      2 if pitch_type == "frame" else 1,
                                                      predictor_kernel, predictor_dropout)
            self.pitch_embed = Embedding(300, H, 0)
        if use_energy_embed:
            self.energy_predictor = EnergyPredictor(H, predictor_layers, ph, 1,
                                                    predictor_kernel, predictor_dropout)
            self.energy_embed = Embedding(256, H, 0)
        if decoder_type == "fft":
            self.decoder = FastspeechDecoder(H, dec_layers, dec_ffn_kernel_size, num_heads,
                                             dropout)
        else:
            self.decoder = ConvStacks(H, n_layers=dec_layers, n_chans=H, odim=H)
        self.mel_out = dense(H, out_dims)

    def forward(self, txt_tokens, mel2ph=None, spk_embed=None, f0=None, uv=None, energy=None,
                infer: bool = False, max_frames: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """txt_tokens [B, T_txt]; mel2ph [B, T] (None: from the predicted
        durations, ``max_frames`` long if given); spk_embed [B, 256] or
        speaker ids [B]; f0, uv, energy [B, T] (None: predicted) -> dict
        with ``mel_out`` [B, T, out_dims], ``dur``, ``mel2ph``, the
        predictors' outputs and the decoder's inputs."""
        ret = {}
        encoder_out = self.encoder(txt_tokens, generator)
        src_nonpadding = (txt_tokens > 0).to(encoder_out.dtype)[:, :, None]
        if (self.use_spk_embed or self.use_spk_id) and spk_embed is not None:
            spk = self.spk_embed_proj(spk_embed)[:, None, :]
        else:
            spk = 0.0
        dur_inp = scale_grad((encoder_out + spk) * src_nonpadding, self.predictor_grad)
        ret["dur"] = dur_pred = self.dur_predictor(dur_inp, txt_tokens == 0, generator)
        if mel2ph is None:
            dur = DurationPredictor.out2dur(dur_pred)
            mel2ph = length_regulator(dur, txt_tokens == 0, max_len=max_frames).detach()
        ret["mel2ph"] = mel2ph

        dec_src = F.pad(encoder_out, (0, 0, 1, 0))  # row 0: padding
        decoder_inp = torch.gather(dec_src, 1,
                                   mel2ph[:, :, None].expand(-1, -1, self.hidden_size))
        tgt_nonpadding = (mel2ph > 0).to(decoder_inp.dtype)[:, :, None]
        ret["decoder_inp_origin"] = decoder_inp
        pitch_inp = (decoder_inp + spk) * tgt_nonpadding
        if self.use_pitch_embed:
            decoder_inp = decoder_inp + self._add_pitch(pitch_inp, f0, uv, mel2ph, ret, generator)
        if self.use_energy_embed:
            decoder_inp = decoder_inp + self._add_energy(pitch_inp, energy, ret, generator)
        ret["decoder_inp"] = decoder_inp = (decoder_inp + spk) * tgt_nonpadding
        if self.decoder_type == "fft":
            x = self.decoder(decoder_inp, generator)
        else:
            x = self.decoder(decoder_inp.transpose(1, 2), None, generator).transpose(1, 2)
        ret["mel_out"] = self.mel_out(x) * tgt_nonpadding
        return ret

    def _pitch_embed(self, f0, uv, mel2ph, ret):
        ret["f0_denorm"] = f0_denorm = denorm_f0(f0, uv, self.hp, pitch_padding=mel2ph == 0)
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def _add_pitch(self, decoder_inp, f0, uv, mel2ph, ret, generator):
        decoder_inp = scale_grad(decoder_inp, self.predictor_grad)
        if self.pitch_type == "cwt":
            return self._add_pitch_cwt(decoder_inp, f0, uv, mel2ph, ret, generator)
        ret["pitch_pred"] = pitch_pred = self.pitch_predictor(decoder_inp, generator)
        if f0 is None:
            f0 = pitch_pred[:, :, 0]
        if self.use_uv and uv is None:
            uv = pitch_pred[:, :, 1] > 0
        return self._pitch_embed(f0, uv, mel2ph, ret)

    def _add_pitch_cwt(self, decoder_inp, f0, uv, mel2ph, ret, generator):
        """Predict the 10-scale wavelet spectrum (and uv) and the utterance's
        f0 mean and std; without a given f0, invert them to the normalized
        f0 contour (reference: fs2.py:205-231)."""
        ret["cwt"] = cwt_out = self.cwt_predictor(self.cwt_in(decoder_inp), generator)
        sh = F.relu(self.cwt_stats_0(decoder_inp[:, 0, :]))
        stats = self.cwt_stats_2(F.relu(self.cwt_stats_1(sh)))
        ret["f0_mean"], ret["f0_std"] = stats[:, 0], stats[:, 1]
        if f0 is None:
            f0_rec = inverse_cwt(cwt_out[:, :, :10], cwt_scales())
            lf0 = f0_rec * (ret["f0_std"] * self.cwt_std_scale)[:, None] + ret["f0_mean"][:, None]
            f0 = norm_f0(torch.exp(lf0), None, self.hp)
            if self.use_uv:
                uv = cwt_out[:, :, -1] > 0
        return self._pitch_embed(f0[:, : mel2ph.shape[1]], uv if self.use_uv else None,
                                 mel2ph, ret)

    def _add_energy(self, decoder_inp, energy, ret, generator):
        decoder_inp = scale_grad(decoder_inp, self.predictor_grad)
        ret["energy_pred"] = energy_pred = self.energy_predictor(decoder_inp, generator)[..., 0]
        if energy is None:
            energy = energy_pred
        # a float floor division, then the 0..255 clip (JAX: fs2.py:185)
        energy_q = torch.div(energy * 256, 4, rounding_mode="floor").long().clamp(0, 255)
        return self.energy_embed(energy_q)
