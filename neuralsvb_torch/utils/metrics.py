"""Evaluation metrics; port of ``neuralsvb_tpu/utils/metrics.py``
(reference: utils/metrics.py:3-4 ships ``laplace_var``; the mel-cepstral
distortion is the parity metric of ``BASELINE.md``: a2p mels within 0.1 dB).

Host float64 numpy and scipy, as in the JAX package: no device work.
"""

from __future__ import annotations

import numpy as np
from scipy.fftpack import dct
from scipy.ndimage import laplace


def laplace_var(x: np.ndarray) -> float:
    """Sharpness proxy: the variance of the laplacian (reference metric)."""
    return float(laplace(np.asarray(x, np.float64)).var())


def mel_cepstral_distortion(mel_a: np.ndarray, mel_b: np.ndarray, n_mfcc: int = 13) -> float:
    """MCD (dB) between two log10-mel spectrograms [T, n_mels], over their
    common length: 10/ln10 * sqrt(2 * sum_k (c_a - c_b)^2) per frame, c0
    skipped, averaged over frames."""
    T = min(len(mel_a), len(mel_b))
    a = np.asarray(mel_a[:T], np.float64) * np.log(10.0)  # ln-mel
    b = np.asarray(mel_b[:T], np.float64) * np.log(10.0)
    ca = dct(a, type=2, axis=1, norm="ortho")[:, 1:n_mfcc]
    cb = dct(b, type=2, axis=1, norm="ortho")[:, 1:n_mfcc]
    d = np.sqrt(2.0 * ((ca - cb) ** 2).sum(-1))
    return float((10.0 / np.log(10.0)) * d.mean())
