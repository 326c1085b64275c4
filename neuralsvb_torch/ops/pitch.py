"""Autocorrelation f0 tracker (Praat-style ac method + Viterbi smoothing);
port of ``neuralsvb_tpu/ops/pitch.py`` (which replaces the reference's
parselmouth ``get_pitch``, data_gen/tts/data_gen_utils.py:150-184).

1. frames of ``periods_per_window / f0_min`` seconds at the analysis hop,
   hann-windowed, mean-removed;
2. normalized autocorrelation via rFFT, divided by the window's own
   autocorrelation (Boersma's correction) and r(0);
3. the top K-1 local maxima in the valid lag band as voiced candidates,
   with parabolic refinement, and one unvoiced candidate whose strength
   follows Praat's voicing/silence threshold formula;
4. Viterbi over the candidates with octave-jump and voiced/unvoiced costs.

Steps 1-3 (``_pitch_candidates``) run on the given device in float32, as
in JAX; the Viterbi runs in the host C++ kernel (``native.py``).
``get_pitch`` keeps the reference's framing contract: a left pad of
2 * pad_size frames (8 for hop 128), the length reconciled to the mel's,
and ``f0_to_coarse``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..native import pitch_viterbi_native
from .pitch_utils import f0_to_coarse
from .stft import hann_window

K_CANDIDATES = 15


def _pitch_candidates(wav: torch.Tensor, *, sr, hop, f0_min, f0_max, frame_len,
                      voicing_threshold=0.45, silence_threshold=0.03,
                      octave_cost=0.01):
    """wav [N] float32 -> (freqs [T, K], strengths [T, K]) on wav's device;
    slot K-1 is unvoiced, T = 1 + N // hop."""
    N = wav.shape[0]
    T = 1 + N // hop
    fft_n = int(2 ** np.ceil(np.log2(2 * frame_len)))
    frames = F.pad(wav, (frame_len // 2, frame_len)).unfold(0, frame_len, hop)[:T]
    window = torch.as_tensor(hann_window(frame_len, np.float32), device=wav.device)
    frames = (frames - frames.mean(-1, keepdim=True)) * window

    global_peak = wav.abs().max() + 1e-12
    local_peak = frames.abs().amax(-1)                       # [T]

    # normalized autocorrelation of signal / window (Boersma's trick)
    spec = torch.fft.rfft(frames, fft_n)
    ac = torch.fft.irfft(spec * spec.conj(), fft_n)[:, :frame_len]
    r = ac / (ac[:, :1] + 1e-12)
    wspec = torch.fft.rfft(window, fft_n)
    wac = torch.fft.irfft(wspec * wspec.conj(), fft_n)[:frame_len]
    rw = wac / (wac[0] + 1e-12)
    rnorm = r / rw.clamp_min(1e-3)[None, :]                   # [T, L]

    lag_min = max(2, int(sr / f0_max))
    lag_max = min(frame_len - 2, int(sr / f0_min))
    lags = torch.arange(frame_len, device=wav.device)
    band = (lags >= lag_min) & (lags <= lag_max)

    # local maxima within the band
    is_peak = (rnorm[:, 1:-1] > rnorm[:, :-2]) & (rnorm[:, 1:-1] >= rnorm[:, 2:])
    is_peak = F.pad(is_peak, (1, 1))
    score = torch.where(band[None, :] & is_peak, rnorm,
                        torch.full_like(rnorm, -float("inf")))
    top_vals, top_lags = torch.topk(score, K_CANDIDATES - 1, dim=1)  # [T, K-1]

    # parabolic refinement of lag and strength
    tl = top_lags.clamp(1, frame_len - 2)
    y0 = torch.gather(rnorm, 1, tl - 1)
    y1 = torch.gather(rnorm, 1, tl)
    y2 = torch.gather(rnorm, 1, tl + 1)
    denom = y0 - 2 * y1 + y2
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (y0 - y2) / denom,
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    ref_lag = tl + delta
    ref_val = y1 - 0.25 * (y0 - y2) * delta
    freqs = sr / ref_lag.clamp_min(1.0)
    valid = torch.isfinite(top_vals) & (freqs >= f0_min) & (freqs <= f0_max)

    # Praat's octave cost: favors higher-frequency candidates
    strength = ref_val - octave_cost * torch.log2(f0_min * ref_lag / sr)
    strength = torch.where(valid, strength, torch.full_like(strength, -1e9))

    # unvoiced candidate strength (Praat formula)
    unvoiced = voicing_threshold + (
        2.0 - (local_peak / global_peak) /
        (silence_threshold / (1 + voicing_threshold))).clamp_min(0.0)
    freqs = torch.cat([freqs, freqs.new_zeros(T, 1)], 1)
    strengths = torch.cat([strength, unvoiced[:, None]], 1)
    return freqs, strengths


def track_pitch(wav: np.ndarray, sr: int, hop: int, device: torch.device,
                f0_min: float = 80.0, f0_max: float = 750.0,
                voicing_threshold: float = 0.6,
                periods_per_window: float = 3.0) -> np.ndarray:
    """wav [N] -> f0 [1 + N // hop] float32 in Hz (0 where unvoiced)."""
    frame_len = int(round(periods_per_window / f0_min * sr))
    freqs, strengths = _pitch_candidates(
        torch.as_tensor(np.asarray(wav, np.float32), device=device), sr=sr,
        hop=hop, f0_min=f0_min, f0_max=f0_max, frame_len=frame_len,
        voicing_threshold=voicing_threshold)
    freqs = freqs.cpu().numpy()
    path = pitch_viterbi_native(freqs, strengths.cpu().numpy(),
                                octave_jump_cost=0.35, vuv_cost=0.14)
    return freqs[np.arange(len(freqs)), path]


def get_pitch(wav: np.ndarray, mel: np.ndarray, hp: dict, device: torch.device):
    """Reference framing contract (data_gen_utils.py:150-184):
    returns (f0 [len(mel)], pitch_coarse [len(mel)])."""
    hop = hp["hop_size"]
    if hop == 128:
        pad_size = 4
    elif hop == 256:
        pad_size = 2
    else:
        raise ValueError(f"unsupported hop {hop}")
    f0_full = track_pitch(wav, hp["audio_sample_rate"], hop, device)
    keep = max(len(mel) - 2 * pad_size, 0)
    f0 = f0_full[:keep] if len(f0_full) >= keep else f0_full
    lpad = pad_size * 2
    rpad = max(len(mel) - len(f0) - lpad, 0)
    f0 = np.pad(f0, (lpad, rpad))
    delta_l = len(mel) - len(f0)
    if abs(delta_l) > 8:
        raise ValueError(f"f0 length {len(f0)} too far from mel length {len(mel)}")
    if delta_l > 0:
        f0 = np.concatenate([f0, [f0[-1]] * delta_l])
    f0 = f0[: len(mel)]
    return f0, f0_to_coarse(f0)
