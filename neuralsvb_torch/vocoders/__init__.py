"""Vocoder API: registry + mel->wav inference wrappers."""

from .base import BaseVocoder, get_vocoder_cls, register_vocoder  # noqa: F401
from . import hifigan as _hifigan  # noqa: F401  (registers HifiGAN)
from . import pwg as _pwg  # noqa: F401  (registers PWG)
