"""Host-side audio IO and DSP, the port's copies of
``neuralsvb_tpu/ops/audio.py`` (reference: utils/audio.py): 16-bit PCM mono
out; wav in through scipy, other formats through ffmpeg where it is
installed; polyphase resampling; the dB and normalisation helpers,
Griffin-Lim and ``trim_long_silences`` (host numpy, as in the JAX package).
The vocoder's denoiser runs on its device: ``ops/stft.py``
``spectral_subtract``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from fractions import Fraction

import numpy as np

from .stft import istft, stft_mag_np, stft_np


def save_wav(wav: np.ndarray, path: str, sr: int, norm: bool = False) -> None:
    wav = np.asarray(wav, dtype=np.float64)
    if norm and np.abs(wav).max() > 0:
        wav = wav / np.abs(wav).max()
    pcm = (wav * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sr))
        f.writeframes(pcm.astype("<i2").tobytes())


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    from scipy import signal as sps
    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    return sps.resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)


def load_wav(path: str, sr: int | None = None) -> tuple[np.ndarray, int]:
    """Load an audio file to float32 mono at ``sr`` (ffmpeg for formats
    other than wav)."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".wav":
        if shutil.which("ffmpeg") is None:
            raise RuntimeError(f"need ffmpeg to decode {ext} files: {path}")
        out_sr = sr or 22050
        cmd = ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le", "-ac", "1",
               "-ar", str(out_sr), "pipe:1"]
        raw = subprocess.check_output(cmd)
        return np.frombuffer(raw, dtype=np.float32).copy(), out_sr
    from scipy.io import wavfile
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(-1)
    if sr is not None and file_sr != sr:
        wav = resample(wav, file_sr, sr)
        file_sr = sr
    return wav, file_sr


def amp_to_db(x: np.ndarray) -> np.ndarray:
    return 20 * np.log10(np.maximum(1e-5, x))


def db_to_amp(x: np.ndarray) -> np.ndarray:
    return 10.0 ** (x * 0.05)


def normalize(S: np.ndarray, hp: dict) -> np.ndarray:
    return (S - hp["min_level_db"]) / -hp["min_level_db"]


def denormalize(D: np.ndarray, hp: dict) -> np.ndarray:
    return (D * -hp["min_level_db"]) + hp["min_level_db"]


def griffin_lim(S: np.ndarray, hp: dict, angles: np.ndarray | None = None) -> np.ndarray:
    """Griffin-Lim phase reconstruction from a magnitude spectrogram
    [n_bins, T] (reference: utils/audio.py:35-42)."""
    fft_size, hop, win = hp["fft_size"], hp["hop_size"], hp["win_size"]
    if angles is None:
        angles = np.exp(2j * np.pi * np.random.rand(*S.shape))
    S = np.abs(S).astype(np.complex128)
    y = istft(S * angles, hop, win)
    for _ in range(hp.get("griffin_lim_iters", 60)):
        spec = stft_mag_np(y, fft_size, hop, win)
        # re-estimate phase from the reconstructed signal
        full = stft_np(y, fft_size, hop, win)
        T = min(S.shape[1], full.shape[1])
        angles = np.exp(1j * np.angle(full[:, :T]))
        y = istft(S[:, :T] * angles, hop, win)
        del spec
    return y


def _subband_speech_flags(wav16k: np.ndarray, frame: int) -> np.ndarray:
    """Per-window speech decision on 16 kHz audio — the detector inside
    :func:`trim_long_silences`.

    The reference uses webrtcvad mode 3 here (a fixed-point 6-sub-band
    two-class GMM, unavailable in this environment and not reimplementable
    bit-exactly without its source). This substitute keeps the decision
    granularity and aggressiveness but decides from sub-band SNR against
    an adaptive noise floor: per window, log energy in the same six bands
    webrtcvad models (80-250, 250-500, 500-1k, 1-2k, 2-3k, 3-4k Hz via an
    rFFT); the noise floor is the per-band mean over the globally quietest
    ~10% of windows (quietest by total energy, so the floor is estimated
    jointly from actual silence rather than per-band percentiles, which a
    low-pass speech signal would corrupt in the high bands); speech when
    the summed over-floor log-energy exceeds a threshold tuned to
    webrtcvad mode-3-like behavior on speech-shaped signals."""
    n = len(wav16k) // frame
    frames = wav16k[: n * frame].reshape(n, frame)
    spec = np.abs(np.fft.rfft(frames * np.hanning(frame), axis=-1)) ** 2
    freqs = np.fft.rfftfreq(frame, 1.0 / 16000)
    edges = [80, 250, 500, 1000, 2000, 3000, 4000]
    band_e = np.stack([
        spec[:, (freqs >= lo) & (freqs < hi)].sum(-1)
        for lo, hi in zip(edges[:-1], edges[1:])], -1)  # [n, 6]
    log_e = 10 * np.log10(np.maximum(band_e, 1e-12))
    total = band_e.sum(-1)
    n_quiet = max(1, n // 10)
    quiet = np.argpartition(total, n_quiet - 1)[:n_quiet]
    # The floor is estimated from the clip's own quietest windows, so it is
    # only a NOISE floor when the clip actually contains silence. If the
    # loud windows (90th percentile — speech even when silence dominates
    # the clip) sit within 15 dB of the quiet floor, the clip has no real
    # dynamic range to separate on (continuously voiced, no internal
    # pause) — fail OPEN and keep everything rather than zeroing the SNR
    # of speech against itself (real silence sits far more than 15 dB
    # below speech).
    total_db = 10 * np.log10(np.maximum(total, 1e-12))
    if float(np.percentile(total_db, 90) - total_db[quiet].mean()) < 15.0:
        # < 15 dB dynamic range: either continuously voiced OR continuously
        # silent — distinguish with an absolute energy floor (ADVICE r3).
        # A 30 ms Hann window of speech at even a very quiet ~5e-4 RMS sums
        # to > -25 dB band energy here; an all-silence/noise-only clip sits
        # far below. Fail open (keep all) only when the loud windows carry
        # real speech-level energy; otherwise the clip is silence and is
        # trimmed in full (webrtcvad's behavior on silence-only input).
        if float(np.percentile(total_db, 90)) < -25.0:
            return np.zeros(n, bool)
        return np.ones(n, bool)
    floor = log_e[quiet].mean(0, keepdims=True)  # noise floor per band
    snr = np.maximum(log_e - floor, 0.0)
    # low bands carry voicing; weight them up (speech energy is low-pass)
    w = np.array([1.0, 1.0, 1.0, 0.75, 0.5, 0.5])
    return (snr * w).sum(-1) > 18.0


def trim_long_silences(wav: np.ndarray, sr: int,
                       vad_max_silence_length: int = 12,
                       return_raw_wav: bool = False):
    """Trim long internal silences; substitute for the reference's
    webrtcvad pipeline (reference: data_gen_utils.py:27-90).

    The surrounding pipeline is reproduced exactly — resample to 16 kHz,
    30 ms decision windows, moving-average smoothing (width 8, rounded),
    binary dilation with a ``vad_max_silence_length + 1`` structuring
    element, window-rate mask repeated and resized back to the raw wav
    length — only the per-window detector differs (see
    :func:`_subband_speech_flags`; webrtcvad itself is a substitute-only
    port). Returns ``(trimmed, mask, sr)`` like the
    reference (or ``(raw, mask, sr)`` with ``return_raw_wav``)."""
    wav_raw = np.asarray(wav, np.float32)
    wav16 = resample(wav_raw, sr, 16000)
    frame = (30 * 16000) // 1000  # 30 ms -> 480 samples
    wav16 = wav16[: len(wav16) - (len(wav16) % frame)]
    n = len(wav16) // frame
    if n == 0:
        mask = np.ones(len(wav_raw), bool)
        return wav_raw, mask, sr
    flags = _subband_speech_flags(wav16, frame).astype(float)

    width = 8  # reference vad_moving_average_width
    padded = np.concatenate([np.zeros((width - 1) // 2), flags,
                             np.zeros(width // 2)])
    csum = np.cumsum(padded, dtype=float)
    csum[width:] = csum[width:] - csum[:-width]
    smoothed = csum[width - 1:] / width
    audio_mask = np.round(smoothed).astype(bool)

    # dilate voiced regions: silences <= vad_max_silence_length windows
    # between speech survive (scipy-free 1-D binary_dilation)
    k = vad_max_silence_length + 1
    # scipy's even-size structuring element is centered at k//2, which
    # spreads k//2 LEFT and k//2-1 right (verified against
    # scipy.ndimage.binary_dilation; odd k is symmetric)
    half_l, half_r = k // 2, (k - 1) // 2
    idx = np.flatnonzero(audio_mask)
    dilated = np.zeros(n, bool)
    for i in idx:
        dilated[max(0, i - half_l): i + half_r + 1] = True
    audio_mask = np.repeat(dilated, frame)
    # nearest-neighbor resize to the raw length (reference: skimage resize>0)
    pos = np.minimum((np.arange(len(wav_raw)) * len(audio_mask))
                     // max(len(wav_raw), 1), len(audio_mask) - 1)
    mask = audio_mask[pos]
    if return_raw_wav:
        return wav_raw, mask, sr
    return wav_raw[mask], mask, sr
