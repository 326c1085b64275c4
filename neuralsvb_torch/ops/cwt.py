"""Continuous wavelet transform of log-f0 (Mexican-hat mother wavelet);
port of ``neuralsvb_tpu/ops/cwt.py`` (reference: utils/cwt.py:12-146).

- The binarizer's side (``with_f0cwt``) is host numpy, as in the JAX
  package: a self-contained FFT CWT with the DOG(m=2) mother wavelet,
  dt = 0.005, dj = 1, s0 = 2 dt and J = 9, so 10 scales.
- The model's and the losses' side (``inverse_cwt``, ``cwt2f0``,
  ``cwt2f0_norm``) takes numpy arrays or tensors; a tensor stays on its
  device, inside the graph. ``inverse_cwt``'s std is the population std
  (``unbiased=False``), as numpy's and ``jnp.std``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gamma as _gamma

from .pitch_utils import norm_f0

CWT_DT = 0.005
CWT_DJ = 1.0
CWT_J = 9


def convert_continuous_f0(f0: np.ndarray):
    """Fill unvoiced gaps by edge extension and linear interpolation.
    Returns (uv flags, continuous f0)."""
    f0 = np.copy(np.asarray(f0, dtype=np.float64))
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        return uv, f0
    nz = np.where(f0 != 0)[0]
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1]:] = f0[nz[-1]]
    nz = np.where(f0 != 0)[0]
    return uv, np.interp(np.arange(len(f0)), nz, f0[nz])


def get_cont_lf0(f0: np.ndarray):
    uv, cont = convert_continuous_f0(f0)
    return uv, np.log(cont)


def _mexican_hat_psi_ft(w: np.ndarray) -> np.ndarray:
    """Fourier transform of the DOG(m=2) mother wavelet (pycwt convention)."""
    m = 2
    return -(1j * w) ** m / np.sqrt(_gamma(m + 0.5)) * np.exp(-(w ** 2) / 2)


def cwt_mexican_hat(signal: np.ndarray, dt: float = CWT_DT, dj: float = CWT_DJ,
                    s0: float = 2 * CWT_DT, J: int = CWT_J):
    """Continuous wavelet transform -> (W [J+1, n] complex, scales [J+1])."""
    signal = np.asarray(signal, dtype=np.float64)
    n0 = len(signal)
    N = int(2 ** np.ceil(np.log2(n0)))
    sig_ft = np.fft.fft(signal, n=N)
    w_k = 2 * np.pi * np.fft.fftfreq(N, dt)
    scales = s0 * 2.0 ** (dj * np.arange(J + 1))
    sj = scales[:, None]
    norm = np.sqrt(sj * np.abs(w_k[1]) * N)
    psi_ft_bar = norm * np.conjugate(_mexican_hat_psi_ft(sj * w_k[None, :]))
    W = np.fft.ifft(sig_ft[None, :] * psi_ft_bar, axis=1)
    return W[:, :n0], scales


def get_lf0_cwt(lf0: np.ndarray):
    """-> (real CWT [n, J+1], scales [J+1]), the reference's layout."""
    W, scales = cwt_mexican_hat(np.squeeze(lf0))
    return np.real(W).T, scales


def norm_scale(wavelet_lf0: np.ndarray):
    mean = wavelet_lf0.mean(0)[None, :]
    std = wavelet_lf0.std(0)[None, :]
    return (wavelet_lf0 - mean) / std, mean, std


def cwt_scales() -> np.ndarray:
    return (2 * CWT_DT) * 2.0 ** (CWT_DJ * np.arange(CWT_J + 1))


def inverse_cwt(wavelet_lf0, scales):
    """Approximate inverse, standardized over time; wavelet_lf0 [B, T,
    n_scales] (numpy or tensor) -> [B, T]."""
    if isinstance(wavelet_lf0, torch.Tensor):
        b = (torch.arange(len(scales), dtype=torch.float32, device=wavelet_lf0.device)
             [None, None, :] + 1 + 2.5) ** (-2.5)
        rec = (wavelet_lf0 * b).sum(-1)
        mean = rec.mean(-1, keepdim=True)
        std = rec.std(-1, unbiased=False, keepdim=True)
        return (rec - mean) / std
    b = (np.arange(len(scales), dtype=np.float32)[None, None, :] + 1 + 2.5) ** (-2.5)
    rec = (wavelet_lf0 * b).sum(-1)
    return (rec - rec.mean(-1, keepdims=True)) / rec.std(-1, keepdims=True)


def cwt2f0(cwt_spec, mean, std, cwt_scales):
    """Normalized CWT [B, T, n_scales] -> f0 in Hz [B, T]."""
    f0 = inverse_cwt(cwt_spec, cwt_scales) * std[:, None] + mean[:, None]
    return torch.exp(f0) if isinstance(f0, torch.Tensor) else np.exp(f0)


def cwt2f0_norm(cwt_spec, mean, std, mel2ph, hp):
    """The f0 a CWT spectrum decodes to, renormalized for the pitch embed
    (reference: modules/fastspeech/fs2.py:239-244): inverse CWT, the
    utterance's statistics, exp, padded to the mel length with the last
    frame, ``norm_f0``."""
    f0 = cwt2f0(cwt_spec, mean, std, cwt_scales())  # [B, T']
    T = mel2ph.shape[1]
    if f0.shape[1] < T:
        if isinstance(f0, torch.Tensor):
            f0 = torch.cat([f0, f0[:, -1:].expand(-1, T - f0.shape[1])], 1)
        else:
            f0 = np.concatenate([f0, np.repeat(f0[:, -1:], T - f0.shape[1], axis=1)], 1)
    return norm_f0(f0[:, :T], None, hp)
