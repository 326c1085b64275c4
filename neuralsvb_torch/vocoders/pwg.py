"""The ``pwg`` entry of the vocoder registry, which the binarize configs
resolve (``egs/egs_bases/tts/base.yaml``: ``vocoder: pwg``); counterpart of
``neuralsvb_tpu/vocoders/pwg.py``. The binarizer needs only its
``wav2spec`` (from ``BaseVocoder``); the ParallelWaveGAN generator is not
ported yet."""

from __future__ import annotations

from .base import BaseVocoder, register_vocoder


@register_vocoder
class PWG(BaseVocoder):
    def spec2wav(self, mel, **kwargs):
        raise NotImplementedError(
            "the ParallelWaveGAN vocoder is not ported yet (ROADMAP.md queue 1 "
            "item 8); the flagship vocoder is hifigan")
