"""Pitch utilities on the inference path; port of the functions of
``neuralsvb_tpu/ops/pitch_utils.py`` that it uses (reference:
utils/pitch_utils.py:130-196): coarse quantization, normalization and
denormalization (numpy or torch: FastSpeech2 runs them on the device inside
its graph) and normalization with interpolation through unvoiced frames
(numpy, host side); and the WORLD / mel-cepstrum helpers of offline
analysis (numpy, host side; ``code_harmonic`` and ``decode_harmonic``
import ``pysptk`` when called, as the JAX package's do).
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


# ---------------------------------------------------------------------------
# WORLD / mel-cepstrum helpers (reference: utils/pitch_utils.py:17-127).
# Host-side numpy: these run in offline analysis tooling, not the jit path.
# ---------------------------------------------------------------------------

MCEP_ALPHA = 0.45
MCEP_FFT_SIZE = 2048
_FORMANT_ALPHA = {8000: 0.31, 16000: 0.58, 22050: 0.65, 44100: 0.76,
                  48000: 0.77}


def to_lf0(f0):
    """f0 Hz -> log-f0 with -1e10 at unvoiced (reference: pitch_utils.py:46-50)."""
    f0 = np.asarray(f0, np.float64).copy()
    unvoiced = f0 < 1.0e-5
    f0[unvoiced] = 1.0e-6
    lf0 = np.log(f0)
    lf0[unvoiced] = -1.0e10
    return lf0


def to_f0(lf0):
    """log-f0 -> f0 Hz, <=0 mapped to 0 (reference: pitch_utils.py:53-55)."""
    lf0 = np.asarray(lf0)
    return np.where(lf0 <= 0, 0.0, np.exp(lf0)).flatten()


def mc2b(mc, alpha=MCEP_ALPHA):
    """Mel-cepstrum -> MLSA filter coefficients, vectorized over frames
    (reference: pitch_utils.py:79-100; recurrence b[i] = mc[i] - a*b[i+1])."""
    mc = np.atleast_2d(np.asarray(mc, np.float64))
    b = np.empty_like(mc)
    m = mc.shape[1] - 1
    b[:, m] = mc[:, m]
    for i in range(m - 1, -1, -1):
        b[:, i] = mc[:, i] - alpha * b[:, i + 1]
    return b


def b2mc(b, alpha=MCEP_ALPHA):
    """MLSA filter coefficients -> mel-cepstrum (inverse of :func:`mc2b`;
    reference: pitch_utils.py:103-126)."""
    b = np.atleast_2d(np.asarray(b, np.float64))
    mc = np.empty_like(b)
    m = b.shape[1] - 1
    mc[:, m] = b[:, m]
    d = b[:, m].copy()
    for i in range(1, m + 1):
        mc[:, m - i] = b[:, m - i] + alpha * d
        d = b[:, m - i]
    return mc


def formant_enhancement(coded_spectrogram, beta, fs):
    """Post-filter boosting formants in the mcep domain by ``beta``
    (reference: pitch_utils.py:58-76). Vectorized over frames."""
    sp = np.asarray(coded_spectrogram, np.float64).copy()
    alpha = _FORMANT_ALPHA[fs]
    b = mc2b(sp, alpha)
    b[:, 1] = b[:, 1] - alpha * beta * b[:, 2]
    b[:, 2:] *= 1 + beta
    return b2mc(b, alpha).astype(coded_spectrogram.dtype)


def code_harmonic(sp, order, alpha=MCEP_ALPHA):
    """WORLD spectral envelope -> mel-cepstrum-based MFSC coefficients
    (reference: pitch_utils.py:17-29). Needs pysptk, imported lazily like the
    reference; raises ImportError with guidance when unavailable."""
    import pysptk  # gated: not in the baked environment
    en_floor = 10 ** (-80 / 20)
    mceps = np.apply_along_axis(pysptk.mcep, 1, sp, order - 1, alpha,
                                itype=3, threshold=en_floor)
    scale = mceps.copy()
    scale[:, 0] *= 2
    scale[:, -1] *= 2
    mirror = np.hstack([scale[:, :-1], scale[:, -1:0:-1]])
    return np.fft.rfft(mirror).real


def decode_harmonic(mfsc, fftlen=MCEP_FFT_SIZE, alpha=MCEP_ALPHA, gamma=0):
    """Inverse of :func:`code_harmonic` (reference: pitch_utils.py:32-43)."""
    import pysptk  # gated: not in the baked environment
    mceps_mirror = np.fft.irfft(mfsc)
    mceps_back = mceps_mirror[:, :60]
    mceps_back[:, 0] /= 2
    mceps_back[:, -1] /= 2
    return np.exp(np.apply_along_axis(pysptk.mgc2sp, 1, mceps_back, alpha,
                                      gamma, fftlen=fftlen).real)
