"""Pitch utilities on the inference path; port of the functions of
``neuralsvb_tpu/ops/pitch_utils.py`` that it uses (reference:
utils/pitch_utils.py:130-196): coarse quantization, normalization and
denormalization (numpy or torch: FastSpeech2 runs them on the device inside
its graph) and normalization with interpolation through unvoiced frames
(numpy, host side).
"""

from __future__ import annotations

import numpy as np
import torch

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127 * np.log(1 + F0_MIN / 700)
F0_MEL_MAX = 1127 * np.log(1 + F0_MAX / 700)


def f0_to_coarse(f0):
    """Quantize f0 (Hz) into bins 1..255 (0 Hz lands in bin 1). A numpy
    array gives int64 bins, range-checked; a tensor gives int64 bins on its
    device, inside the graph, rounded half to even as ``jnp.rint``."""
    if isinstance(f0, torch.Tensor):
        f0_mel = 1127 * torch.log(1 + f0 / 700)
        scaled = (f0_mel - float(F0_MEL_MIN)) * (F0_BIN - 2) / float(F0_MEL_MAX - F0_MEL_MIN) + 1
        f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
        f0_mel = torch.where(f0_mel <= 1, torch.ones_like(f0_mel), f0_mel)
        f0_mel = torch.where(f0_mel > F0_BIN - 1, torch.full_like(f0_mel, F0_BIN - 1), f0_mel)
        return torch.round(f0_mel).long()
    f0 = np.asarray(f0)
    f0_mel = 1127 * np.log(1 + f0 / 700)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = np.where(f0_mel <= 1, 1.0, f0_mel)
    f0_mel = np.where(f0_mel > F0_BIN - 1, float(F0_BIN - 1), f0_mel)
    coarse = np.rint(f0_mel).astype(np.int64)
    if coarse.size and (coarse.max() > 255 or coarse.min() < 1):
        raise ValueError(f"coarse f0 out of range: {coarse.min()}..{coarse.max()}")
    return coarse


def norm_f0(f0, uv, hp: dict):
    """Hz -> normalized f0 (``pitch_norm`` standard or log), zero where
    ``uv``; numpy arrays or tensors (a tensor stays on its device)."""
    is_t = isinstance(f0, torch.Tensor)
    if hp["pitch_norm"] == "standard":
        f0 = (f0 - hp["f0_mean"]) / hp["f0_std"]
    elif hp["pitch_norm"] == "log":
        f0 = torch.log2(f0 + 1e-8) if is_t else np.log2(f0 + 1e-8)
    if uv is not None and hp.get("use_uv", True):
        f0 = (torch.where(uv > 0, torch.zeros_like(f0), f0) if is_t
              else np.where(uv > 0, 0.0, f0))
    return f0


def norm_interp_f0(f0, hp: dict):
    """Normalize then linearly interpolate through unvoiced frames.
    Returns (f0_norm, uv) as float32 arrays."""
    f0 = np.asarray(f0, dtype=np.float64).copy()
    uv = f0 == 0
    f0 = norm_f0(f0, uv, hp)
    if uv.sum() == len(f0):
        f0[uv] = 0
    elif uv.sum() > 0:
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0.astype(np.float32), uv.astype(np.float32)


def denorm_f0(f0, uv, hp: dict, pitch_padding=None, min_val=None, max_val=None):
    """Normalized f0 -> Hz, zero where unvoiced; numpy arrays or tensors
    (a tensor stays on its device)."""
    is_t = isinstance(f0, torch.Tensor)
    if hp["pitch_norm"] == "standard":
        f0 = f0 * hp["f0_std"] + hp["f0_mean"]
    elif hp["pitch_norm"] == "log":
        f0 = 2 ** f0
    lo = 0.0 if min_val is None else min_val
    hi = F0_MAX if max_val is None else max_val
    f0 = f0.clamp(lo, hi) if is_t else np.clip(f0, lo, hi)
    where = torch.where if is_t else np.where
    zero = torch.zeros((), dtype=f0.dtype, device=f0.device) if is_t else 0.0
    if uv is not None and hp.get("use_uv", True):
        f0 = where(uv > 0, zero, f0)
    if pitch_padding is not None:
        f0 = where(pitch_padding, zero, f0)
    return f0
