"""STFT + log-mel frontend; port of ``neuralsvb_tpu/ops/stft.py``
(reference: data_gen/tts/data_gen_utils.py:93-147 ``process_utterance`` and
vocoders/pwg.py:105-122 ``wav2spec``).

Centered STFT with constant (zero) padding, periodic hann window, magnitude,
Slaney mel basis and ``log10(max(eps, .))``. Two entry points:

- ``log_mel``: the binarizer's, one utterance on its device in float64, the
  precision of the JAX binarizer's numpy path (``log_mel_np``); the H100
  runs FP64 at full rate.
- ``log_mel_batch``: the vocoder training loss's, a batch in float32 with
  gradients (``log_mel_jax``).

The host float64 STFT pair of the JAX package's Griffin-Lim and
denoiser (``stft_np``, ``stft_mag_np``, ``istft``), the vocoder's
denoiser on its device (``spectral_subtract``) and HiFiGAN's torch-style
mel frontend on the host (``mel_spectrogram_hifigan``) complete the module.

No Pallas kernel is involved: the FFT and the mel matmul are library calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .mel_filters import mel_filterbank


def hann_window(win_size: int, dtype=np.float64) -> np.ndarray:
    """Periodic (fftbins=True) hann window, matching scipy/librosa."""
    n = np.arange(win_size, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    return w.astype(dtype)


def n_frames_for(n_samples: int, hop_size: int) -> int:
    """Number of centered-STFT frames for a signal of ``n_samples``."""
    return 1 + n_samples // hop_size


def pad_wav_to_frames(wav: np.ndarray, fft_size: int, hop_size: int) -> np.ndarray:
    """Right-pad the wav to a whole number of hops then truncate to
    ``n_frames * hop`` samples (reference: utils/audio.py:67-76 +
    data_gen_utils.py:137-139)."""
    n_frames = n_frames_for(len(wav), hop_size)
    pad = (len(wav) // hop_size + 1) * hop_size - len(wav)
    wav = np.pad(wav, (0, pad), mode="constant")
    return wav[: n_frames * hop_size]


def log_mel(wav: np.ndarray, hp: dict, device: torch.device) -> torch.Tensor:
    """log10-mel spectrogram ``[1 + N // hop, num_mels]`` float32 on
    ``device`` (the layout of ``log_mel_np``), computed in float64."""
    fft, hop, win = hp["fft_size"], hp["hop_size"], hp["win_size"]
    y = torch.as_tensor(np.asarray(wav, np.float64), device=device)
    spec = torch.stft(y, n_fft=fft, hop_length=hop, win_length=win,
                      window=torch.as_tensor(hann_window(win), device=device),
                      center=True, pad_mode="constant", return_complex=True)
    basis = torch.as_tensor(mel_filterbank(
        hp["audio_sample_rate"], fft, hp["audio_num_mel_bins"], hp["fmin"],
        hp["fmax"], dtype=np.float64), device=device)
    mel = basis @ spec.abs()                          # [num_mels, T]
    eps = float(hp.get("wav2spec_eps", 1e-10))
    return torch.log10(mel.clamp_min(eps)).T.float()


@functools.lru_cache(maxsize=8)
def _mel_consts(sample_rate: int, fft_size: int, win_size: int, num_mels: int,
                fmin: float, fmax: float, device: torch.device):
    """(periodic hann window [win_size], Slaney basis [num_mels, bins]) f32."""
    window = torch.as_tensor(hann_window(win_size, np.float32), device=device)
    basis = torch.as_tensor(mel_filterbank(sample_rate, fft_size, num_mels, fmin, fmax),
                            device=device)
    return window, basis


def log_mel_batch(wav: torch.Tensor, *, sample_rate: int, fft_size: int, hop_size: int,
                  win_size: int, num_mels: int, fmin: float, fmax: float,
                  eps: float = 1e-10) -> torch.Tensor:
    """wav [B, N] -> log10-mel [B, 1 + N // hop, num_mels], float32 and
    differentiable (``log_mel_jax``). ``torch.stft`` centres the window in
    ``fft_size`` when ``win_size`` is shorter, as the JAX function pads it.
    ``torch.maximum`` against ``eps`` splits the gradient at a tie as
    ``jnp.maximum`` does (``clamp_min`` would pass all of it)."""
    window, basis = _mel_consts(sample_rate, fft_size, win_size, num_mels, float(fmin),
                                float(fmax), wav.device)
    spec = torch.stft(wav.float(), n_fft=fft_size, hop_length=hop_size, win_length=win_size,
                      window=window, center=True, pad_mode="constant",
                      return_complex=True)                # [B, bins, T]
    mel = torch.einsum("mf,bft->btm", basis, spec.abs())
    return torch.log10(torch.maximum(mel.new_tensor(eps), mel))


def _padded_window(win_size: int, fft_size: int) -> np.ndarray:
    """The periodic hann window centred in ``fft_size`` (float64)."""
    window = hann_window(win_size)
    if win_size < fft_size:
        lpad = (fft_size - win_size) // 2
        window = np.pad(window, (lpad, fft_size - win_size - lpad))
    return window


def stft_np(wav: np.ndarray, fft_size: int, hop_size: int, win_size: int) -> np.ndarray:
    """Centred complex STFT with zero padding -> [n_bins, T], float64 on the
    host (JAX: ``ops/audio.py`` ``_stft_complex``)."""
    pad = fft_size // 2
    y = np.pad(np.asarray(wav, dtype=np.float64), (pad, pad), mode="constant")
    n_frames = 1 + (len(y) - fft_size) // hop_size
    idx = np.arange(fft_size)[None, :] + hop_size * np.arange(n_frames)[:, None]
    return np.fft.rfft(y[idx] * _padded_window(win_size, fft_size)[None, :], n=fft_size,
                       axis=-1).T


def stft_mag_np(wav: np.ndarray, fft_size: int, hop_size: int, win_size: int) -> np.ndarray:
    """|``stft_np``| -> [n_bins, T] (JAX: ``ops/stft.py`` ``stft_mag_np``)."""
    return np.abs(stft_np(wav, fft_size, hop_size, win_size))


def istft(spec: np.ndarray, hop_size: int, win_size: int) -> np.ndarray:
    """Inverse STFT of a complex spec [n_bins, T] with a hann synthesis
    window, normalised by the overlap-added squared window (floored at
    1e-10) and trimmed by ``n_fft // 2`` on each side; host float64 (JAX:
    ``ops/stft.py:139-158`` ``istft_np``)."""
    n_fft = (spec.shape[0] - 1) * 2
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1)  # [T, n_fft]
    window = _padded_window(win_size, n_fft)
    T = frames.shape[0]
    out_len = n_fft + hop_size * (T - 1)
    out = np.zeros(out_len)
    wsum = np.zeros(out_len)
    for t in range(T):
        s = t * hop_size
        out[s:s + n_fft] += frames[t] * window
        wsum[s:s + n_fft] += window ** 2
    out = out / np.maximum(wsum, 1e-10)
    return out[n_fft // 2: -(n_fft // 2)]


def spectral_subtract(wav: torch.Tensor, fft_size: int, hop_size: int, win_size: int,
                      c: float) -> torch.Tensor:
    """The vocoder's denoiser on ``wav``'s device, in float64: the centred
    STFT's magnitude less ``c``, clipped at 0, with the phase kept, then
    ``torch.istft``, whose hann synthesis, overlap-added squared-window
    normalisation and ``n_fft // 2`` trim on each side are ``istft``'s
    (JAX: ``ops/audio.py:100-118`` ``denoise_spectral_subtract``).
    wav [N] -> float32 [hop x (N // hop)]."""
    window = torch.as_tensor(_padded_window(win_size, fft_size), device=wav.device)
    spec = torch.stft(wav.to(torch.float64), n_fft=fft_size, hop_length=hop_size,
                      window=window, center=True, pad_mode="constant",
                      return_complex=True)                       # [bins, T]
    spec = torch.polar((spec.abs() - c).clamp_min(0.0), spec.angle())
    return torch.istft(spec, n_fft=fft_size, hop_length=hop_size, window=window,
                       center=True).to(torch.float32)


def mel_spectrogram_hifigan(y: np.ndarray, hp: dict, center: bool = False):
    """HiFiGAN-style torch-mel frontend (reference:
    modules/hifigan/mel_utils.py:45-80): clamp to [-1,1], reflect-pad by
    (n_fft - hop)/2, uncentered STFT with a zero-padded hann(win_size)
    window, Slaney mel, natural-log compression with 1e-5 clip.

    y: [B, L] or [L] float waveform -> [B, num_mels, T'] (reference layout).
    The alternate frontend the reference keeps around for official HiFiGAN
    checkpoints (usage commented out at vocoders/hifigan.py:71-76)."""
    n_fft = hp["fft_size"]
    hop = hp["hop_size"]
    win = hp["win_size"]
    y = np.atleast_2d(np.asarray(y, np.float32))
    y = np.clip(y, -1.0, 1.0)
    pad = int((n_fft - hop) / 2)
    y = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")

    window = _padded_window(win, n_fft)

    if center:
        y = np.pad(y, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    n_frames = 1 + (y.shape[1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[:, idx] * window  # [B, T', n_fft]
    spec = np.abs(np.fft.rfft(frames, axis=-1))  # [B, T', n_fft//2+1]
    spec = np.sqrt(spec ** 2 + 1e-9)
    basis = mel_filterbank(hp["audio_sample_rate"], n_fft,
                           hp["audio_num_mel_bins"], hp["fmin"], hp["fmax"])
    mel = np.einsum("mf,btf->bmt", basis, spec)
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)
