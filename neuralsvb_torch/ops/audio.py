"""Host-side audio IO (counterparts of ``save_wav``, ``resample`` and
``load_wav`` in ``neuralsvb_tpu/ops/audio.py``): 16-bit PCM mono out; wav in
through scipy, other formats through ffmpeg where it is installed;
polyphase resampling.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from fractions import Fraction

import numpy as np


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
