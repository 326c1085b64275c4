"""Vocoder registry and base API (reference: vocoders/base_vocoder.py:5-39);
port of ``neuralsvb_tpu/vocoders/base.py``."""

from __future__ import annotations

import importlib

VOCODERS = {}


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    VOCODERS[cls.__name__] = cls
    return cls


def get_vocoder_cls(hp: dict):
    name = hp["vocoder"]
    if name in VOCODERS:
        return VOCODERS[name]
    pkg, cls_name = name.rsplit(".", 1)
    return getattr(importlib.import_module(pkg), cls_name)


class BaseVocoder:
    def spec2wav(self, mel, **kwargs):
        """mel: [T, 80] -> wav [T * hop]."""
        raise NotImplementedError
