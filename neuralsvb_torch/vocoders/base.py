"""Vocoder registry and base API (reference: vocoders/base_vocoder.py:5-39);
port of ``neuralsvb_tpu/vocoders/base.py``, with the ``wav2spec`` frontend
(``neuralsvb_tpu/vocoders/hifigan.py:139-152``, ``pwg.py:131-143``) on
``BaseVocoder`` for every vocoder."""

from __future__ import annotations

import importlib

import numpy as np

from ..hparams import hparams as global_hparams
from ..hparams import resolve_device
from ..ops.audio import amp_to_db, load_wav, normalize
from ..ops.stft import log_mel, pad_wav_to_frames, stft_mag_np

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

    @staticmethod
    def wav2spec(wav_fn, return_linear: bool = False):
        """wav file (or samples) -> (wav [T * hop] float32, log-mel [T, 80]
        float32), the mel computed on the ``device`` the hparams name; with
        ``return_linear`` also the normalised dB linear spectrogram of that
        wav [T', n_bins] float32, on the host (``vocoders/hifigan.py:139-151``
        and ``vocoders/pwg.py:130-144`` in the JAX package)."""
        hp = global_hparams
        if isinstance(wav_fn, str):
            wav, _ = load_wav(wav_fn, sr=hp["audio_sample_rate"])
        else:
            wav = np.asarray(wav_fn, np.float32)
        mel = log_mel(wav, hp, resolve_device(hp.get("device"))).cpu().numpy()
        wav = pad_wav_to_frames(np.asarray(wav, np.float32), hp["fft_size"],
                                hp["hop_size"])
        wav = wav[: mel.shape[0] * hp["hop_size"]]
        if not return_linear:
            return wav, mel
        spc = stft_mag_np(wav, hp["fft_size"], hp["hop_size"], hp["win_size"])
        return wav, mel, normalize(amp_to_db(spc), hp).T.astype(np.float32)
