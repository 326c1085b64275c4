"""Multi-resolution STFT loss of vocoder training; port of
``neuralsvb_tpu/models/stft_loss.py`` (reference:
modules/parallel_wavegan/losses/stft_loss.py): spectral convergence and
log-STFT magnitude at several analysis resolutions, averaged.

Frames come from ``torch.stft`` with reflect padding of ``fft // 2``: it
centres a ``win``-long periodic Hann window in ``fft`` as the JAX function
pads it (left pad ``(fft - win) // 2``), so the frames are the same.
Magnitudes are ``sqrt(clip(|X|^2, 1e-7))``, laid out ``[B, bins, T]``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.stft import hann_window
from ..parallel import ddp

DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


@functools.lru_cache(maxsize=16)
def _window(win: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(hann_window(win, np.float32), device=device)


def stft_magnitude(x: torch.Tensor, fft_size: int, hop: int, win: int) -> torch.Tensor:
    """x [B, N] -> magnitude [B, fft // 2 + 1, 1 + N // hop] (centred, reflect pad)."""
    spec = torch.stft(x, n_fft=fft_size, hop_length=hop, win_length=win,
                      window=_window(win, x.device).to(x.dtype), center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()
    return torch.sqrt(torch.clamp(power, min=1e-7))


def spectral_convergence(mag_hat: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """One Frobenius norm over the whole batch, as the JAX function takes it
    (over the global batch in a data-parallel step)."""
    return (torch.sqrt(ddp.all_sum((mag - mag_hat).square().sum()))
            / torch.clamp(torch.sqrt(ddp.all_sum(mag.square().sum())), min=1e-7))


def log_stft_magnitude(mag_hat: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    return ddp.global_mean((torch.log(mag) - torch.log(mag_hat)).abs())


def stft_loss(y_hat, y, fft_size=1024, hop=120, win=600):
    mag_hat = stft_magnitude(y_hat, fft_size, hop, win)
    mag = stft_magnitude(y, fft_size, hop, win)
    return spectral_convergence(mag_hat, mag), log_stft_magnitude(mag_hat, mag)


def multi_resolution_stft_loss(y_hat: torch.Tensor, y: torch.Tensor,
                               resolutions: Sequence[Tuple[int, int, int]]
                               = DEFAULT_RESOLUTIONS):
    """(sc_loss, mag_loss) of y_hat against y [B, N], each averaged over
    the resolutions (fft, hop, win)."""
    sc_total, mag_total = 0.0, 0.0
    for fft_size, hop, win in resolutions:
        sc, mag = stft_loss(y_hat, y, fft_size, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n
