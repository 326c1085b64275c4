"""GE2E speaker encoder (Resemblyzer ``VoiceEncoder``); port of
``neuralsvb_tpu/models/ge2e.py`` (reference: data_gen/singing/binarize_para.py:46,125).

40-mel power spectrogram at 16 kHz (25 ms window, 10 ms hop) -> 3-layer
LSTM(256) -> Linear -> ReLU -> L2 normalize; the utterance embedding is the
normalized mean over 50%-overlapping 160-frame partials, all embedded in one
batched forward. The module keeps Resemblyzer's parameter names
(``lstm.weight_ih_l0`` ... ``linear.bias``), so its pretrained ``state_dict``
loads as it is. The LSTM is ``nn.LSTM`` (cuDNN on the card): the JAX
version is a flax scan, not a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.audio import resample
from ..ops.mel_filters import mel_filterbank
from ..ops.stft import hann_window

GE2E_SR = 16000
GE2E_N_FFT = 400
GE2E_HOP = 160
GE2E_N_MELS = 40
PARTIAL_FRAMES = 160
HIDDEN = 256


def wav_to_mel40(wav: np.ndarray, sr: int, device: torch.device) -> torch.Tensor:
    """Power mel spectrogram [T, 40] float32 on ``device`` (librosa
    melspectrogram semantics: power 2, Slaney filterbank, centered reflect
    pad), computed in float64 like the JAX package's numpy version."""
    if sr != GE2E_SR:
        wav = resample(wav, sr, GE2E_SR)
    y = torch.as_tensor(np.asarray(wav, np.float64), device=device)
    spec = torch.stft(y, n_fft=GE2E_N_FFT, hop_length=GE2E_HOP,
                      window=torch.as_tensor(hann_window(GE2E_N_FFT), device=device),
                      center=True, pad_mode="reflect", return_complex=True)
    basis = torch.as_tensor(mel_filterbank(GE2E_SR, GE2E_N_FFT, GE2E_N_MELS, 0.0,
                                           GE2E_SR / 2, dtype=np.float64),
                            device=device)
    return (spec.abs() ** 2).T.matmul(basis.T).float()


def compute_partial_slices(n_frames: int, partial_frames: int = PARTIAL_FRAMES,
                           overlap: float = 0.5, min_coverage: float = 0.75):
    """Start indices of overlapping partials covering the utterance."""
    step = max(1, int(round(partial_frames * (1 - overlap))))
    starts = list(range(0, max(n_frames - partial_frames, 0) + 1, step))
    if not starts:
        starts = [0]
    last_end = starts[-1] + partial_frames
    if n_frames - (starts[-1] + step) >= min_coverage * partial_frames and \
            last_end < n_frames:
        starts.append(n_frames - partial_frames)
    return starts


class VoiceEncoder(nn.Module):
    def __init__(self, hidden: int = HIDDEN, n_layers: int = 3):
        super().__init__()
        self.lstm = nn.LSTM(GE2E_N_MELS, hidden, n_layers, batch_first=True)
        self.linear = nn.Linear(hidden, hidden)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        """mels [B, T, 40] -> embeddings [B, 256], L2-normalized."""
        _, (h, _) = self.lstm(mels)
        e = torch.relu(self.linear(h[-1]))
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-5)


def load_ge2e_state_dict(path: str) -> dict:
    """A Resemblyzer-layout checkpoint: the state dict itself, or under
    ``model_state`` (the key Resemblyzer's own loader reads). Entries other
    than the LSTM and the projection (GE2E's similarity scale) are dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state", ckpt)
    return {k: v for k, v in sd.items() if k.startswith(("lstm.", "linear."))}


class SpeakerEncoder:
    """Utterance embedding on ``device``: weights from a Resemblyzer
    checkpoint, or (with none) drawn from a ``torch.Generator`` seeded with
    ``seed`` with PyTorch's default LSTM/Linear init distribution."""

    def __init__(self, ckpt_path: Optional[str], device: torch.device, seed: int = 0):
        self.device = device
        self.model = VoiceEncoder()
        if ckpt_path:
            self.model.load_state_dict(load_ge2e_state_dict(ckpt_path))
        else:
            gen = torch.Generator().manual_seed(seed)
            bound = 1.0 / math.sqrt(HIDDEN)  # LSTM(256) and Linear(256, 256)
            with torch.no_grad():
                for p in self.model.parameters():
                    p.uniform_(-bound, bound, generator=gen)
        self.model = self.model.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def embed_utterance(self, wav: np.ndarray, sr: int = GE2E_SR) -> np.ndarray:
        """wav [N] at ``sr`` -> [256] float32, unit norm."""
        mel = wav_to_mel40(wav, sr, self.device)
        T = mel.shape[0]
        if T < PARTIAL_FRAMES:
            mel = torch.nn.functional.pad(mel, (0, 0, 0, PARTIAL_FRAMES - T))
            T = PARTIAL_FRAMES
        partials = torch.stack([mel[s:s + PARTIAL_FRAMES]
                                for s in compute_partial_slices(T)])
        mean = self.model(partials).mean(0).cpu().numpy()
        return mean / max(np.linalg.norm(mean), 1e-5)
