"""Waveform file output (counterpart of ``save_wav`` in
``neuralsvb_tpu/ops/audio.py``): 16-bit PCM mono, the same samples."""

from __future__ import annotations

import wave

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
