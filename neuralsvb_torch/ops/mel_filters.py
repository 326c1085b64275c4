"""Slaney-scale mel filterbank construction; port of
``neuralsvb_tpu/ops/mel_filters.py`` (numpy, the same numbers).

Numerically matches ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)``
with the default ``htk=False, norm='slaney'`` — the mel basis the reference
binarizer bakes into every packed dataset
(reference: data_gen/tts/data_gen_utils.py:128-131).
"""

from __future__ import annotations

import numpy as np


def hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asarray(freqs, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freqs - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freqs >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None,
                   dtype=np.float32) -> np.ndarray:
    """Triangular Slaney mel filterbank, shape ``[n_mels, 1 + n_fft // 2]``."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_min, mel_max = hz_to_mel_slaney(np.array([fmin, fmax]))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels + 2, n_bins]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)
