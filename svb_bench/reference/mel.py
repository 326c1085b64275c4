"""The log-mel of vocoder training's loss (a copy of the port's
``ops/stft.py`` ``log_mel_batch`` and ``ops/mel_filters.py``): centred STFT,
periodic hann window, Slaney mel basis, ``log10(max(eps, .))``."""

from __future__ import annotations

import numpy as np
import torch


def hann_window(win_size: int, dtype=np.float64) -> np.ndarray:
    """Periodic (fftbins=True) hann window, matching scipy/librosa."""
    n = np.arange(win_size, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    return w.astype(dtype)


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


def log_mel_batch(wav: torch.Tensor, *, sample_rate: int, fft_size: int, hop_size: int,
                  win_size: int, num_mels: int, fmin: float, fmax: float,
                  eps: float = 1e-10) -> torch.Tensor:
    """wav [B, N] -> log10-mel [B, 1 + N // hop, num_mels], float32 and
    differentiable (``log_mel_jax``). ``torch.stft`` centres the window in
    ``fft_size`` when ``win_size`` is shorter, as the JAX function pads it.
    ``torch.maximum`` against ``eps`` splits the gradient at a tie as
    ``jnp.maximum`` does (``clamp_min`` would pass all of it)."""
    window = torch.as_tensor(hann_window(win_size, np.float32), device=wav.device)
    basis = torch.as_tensor(mel_filterbank(sample_rate, fft_size, num_mels, float(fmin),
                                           float(fmax)), device=wav.device)
    spec = torch.stft(wav.float(), n_fft=fft_size, hop_length=hop_size, win_length=win_size,
                      window=window, center=True, pad_mode="constant",
                      return_complex=True)                # [B, bins, T]
    mel = torch.einsum("mf,bft->btm", basis, spec.abs())
    return torch.log10(torch.maximum(mel.new_tensor(eps), mel))
