"""Neural pitch extractor: mel -> (f0, uv); port of
``neuralsvb_tpu/models/pe.py`` (reference: modules/fastspeech/pe.py:44-74).
No task of either package calls it (``pe_enable`` is off in the shipped
configs); it is ported with its test.

mel [B, T, 80] -> ``pitch_pred`` [B, T, 2] (normalized f0, uv logit) and
``f0_denorm_pred`` [B, T] in Hz, 0 where unvoiced or padded (a frame of all
zeros). A stride-1 conv prenet (its projected output), a conv stack and a
five-layer pitch predictor; module names follow the JAX modules' (``convert/jax2torch.py``
``pitch_extractor_from_jax``).
"""

from __future__ import annotations

import torch.nn as nn

from ..ops.pitch_utils import denorm_f0
from .common import ConvStacks, Prenet
from .tts_modules import PitchPredictor


class PitchExtractor(nn.Module):
    def __init__(self, hidden_size: int = 256, conv_layers: int = 2, predictor_hidden: int = -1,
                 predictor_kernel: int = 5, f0_mean: float = 220.0, f0_std: float = 60.0,
                 pitch_norm: str = "standard", use_uv: bool = True, num_mel_bins: int = 80):
        super().__init__()
        H = hidden_size
        self.use_uv = use_uv
        self.hp = {"pitch_norm": pitch_norm, "f0_mean": f0_mean, "f0_std": f0_std,
                   "use_uv": use_uv}
        self.mel_prenet = Prenet(num_mel_bins, H, strides=(1, 1, 1))
        self.mel_encoder = (ConvStacks(H, n_layers=conv_layers, n_chans=H, odim=H)
                            if conv_layers > 0 else None)
        ph = predictor_hidden if predictor_hidden > 0 else H
        self.pitch_predictor = PitchPredictor(H, 5, ph, 2, predictor_kernel, 0.1)

    def forward(self, mel, generator=None) -> dict:
        _, h = self.mel_prenet(mel.transpose(1, 2))  # the projected output
        if self.mel_encoder is not None:
            h = self.mel_encoder(h, None, generator)
        pred = self.pitch_predictor(h.transpose(1, 2), generator)
        uv = (pred[:, :, 1] > 0) if self.use_uv else None
        return {"pitch_pred": pred,
                "f0_denorm_pred": denorm_f0(pred[:, :, 0], uv, self.hp,
                                            pitch_padding=mel.abs().sum(-1) == 0)}
