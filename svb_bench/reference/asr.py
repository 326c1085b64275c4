"""The flagship's frozen ASR-based PPG (phonetic posteriorgram) extractor;
port of the content path of ``neuralsvb_tpu/models/asr.py`` (reference:
modules/voice_conversion/vc_modules.py:56-80).

mel -> strided Prenet (T/2 with mel_strides [2, 1, 1]) -> Conformer content
encoder -> ``h_content``. The extractor carries no decoder head, as the
flagship builds it.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from .common import Prenet
from .conformer import ConformerLayers


class VCASR(nn.Module):
    def __init__(self, hidden_size: int = 256, asr_enc_layers: int = 2,
                 mel_strides: Sequence[int] = (2, 1, 1), asr_last_norm: bool = False,
                 num_mels: int = 80):
        super().__init__()
        self.mel_prenet = Prenet(num_mels, hidden_size, strides=mel_strides)
        self.content_encoder = ConformerLayers(hidden_size, asr_enc_layers, kernel_size=31,
                                               use_last_norm=asr_last_norm)

    def forward(self, mel, exact_lengths: bool = True):
        """mel [B, num_mels, T] -> {'h_content': [B, H, T / stride]};
        ``exact_lengths`` selects the conformer's rel-pos semantics."""
        _, h = self.mel_prenet(mel)
        h = self.content_encoder(h.transpose(1, 2), exact_lengths).transpose(1, 2)
        return {"h_content": h}
