"""NSF (neural source-filter) excitation sources; port of
``neuralsvb_tpu/models/nsf.py`` (reference:
modules/parallel_wavegan/models/source.py:7-399): ``SineGen`` and
``SourceModuleHnNSF``, the HiFiGAN-NSF vocoder's source.

The random initial phase of the overtones (``rand_ini``) and the additive
noise are injectable tensors; otherwise they are drawn from the
``torch.Generator`` passed in, or are zero with ``zero_noise``. The phase is
integrated with a float32 cumsum and the reference's mod-1 wrap trick.
Layout ``[B, harmonics, L]``: the cumsums scan the contiguous last axis.
On an H100, scanning the middle axis of the JAX layout ``[B, L, harmonics]``
took longer than the whole ResBlock cluster of a vocoder call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import draw_normal


class SineGen(nn.Module):
    def __init__(self, samp_rate: int, harmonic_num: int = 0, sine_amp: float = 0.1,
                 noise_std: float = 0.003, voiced_threshold: float = 0.0):
        super().__init__()
        self.samp_rate = samp_rate
        self.harmonic_num = harmonic_num
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.voiced_threshold = voiced_threshold

    def forward(self, f0, generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, rand_ini: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None):
        """f0 [B, 1, L] Hz (0 = unvoiced) -> (sine_waves [B, dim, L], uv
        [B, 1, L], noise [B, dim, L]) with dim = harmonic_num + 1.
        ``rand_ini`` [B, dim] (column 0 is ignored: the fundamental starts
        at phase 0) and ``noise`` [B, dim, L] standard normal override the
        draws."""
        f0 = f0.to(torch.float32)
        B, _, L = f0.shape
        dim = self.harmonic_num + 1
        harmonics = torch.arange(1, dim + 1, dtype=f0.dtype, device=f0.device)
        rad = torch.remainder(f0 * harmonics[:, None] / self.samp_rate, 1.0)
        if rand_ini is None:
            if zero_noise:
                rand_ini = torch.zeros(B, dim, device=f0.device)
            elif generator is None:
                raise ValueError("pass a torch.Generator, or zero_noise=True")
            else:
                rand_ini = torch.rand((B, dim), generator=generator, device=f0.device)
        rand_ini = torch.cat([torch.zeros_like(rand_ini[:, :1]), rand_ini[:, 1:]], 1)
        rad = torch.cat([rad[:, :, :1] + rand_ini[:, :, None], rad[:, :, 1:]], -1)
        # bounded cumulative phase: subtract 1 wherever the running sum
        # wraps; the scans run along the contiguous time axis
        tmp_over_one = torch.remainder(torch.cumsum(rad, -1), 1.0)
        wraps = (tmp_over_one[:, :, 1:] - tmp_over_one[:, :, :-1]) < 0
        shift = torch.cat([torch.zeros_like(rad[:, :, :1]), -wraps.to(rad.dtype)], -1)
        sine_waves = torch.sin(torch.cumsum(rad + shift, -1) * 2 * math.pi) * self.sine_amp
        uv = (f0 > self.voiced_threshold).to(f0.dtype)
        if noise is None:
            noise = draw_normal(sine_waves.shape, sine_waves, generator, zero_noise)
        noise = (uv * self.noise_std + (1 - uv) * self.sine_amp / 3) * noise
        return sine_waves * uv + noise, uv, noise


class SourceModuleHnNSF(nn.Module):
    """SineGen -> Linear(harmonics -> 1) -> tanh, plus a noise branch."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, add_noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.sine_amp = sine_amp
        self.l_sin_gen = SineGen(sampling_rate, harmonic_num, sine_amp,
                                 add_noise_std, voiced_threshold)
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, x, generator=None, zero_noise=False, rand_ini=None,
                noise=None):
        """x: f0 [B, 1, L] -> (sine_merge [B, 1, L], noise [B, 1, L], uv)."""
        sine_wavs, uv, _ = self.l_sin_gen(x, generator, zero_noise, rand_ini, noise)
        # float32 sines through a bf16 generator's weights: the product runs
        # in the promoted dtype (float32), as flax's Dense promotes its inputs
        dt = torch.promote_types(sine_wavs.dtype, self.l_linear.weight.dtype)
        sine_merge = torch.tanh(F.conv1d(sine_wavs.to(dt), self.l_linear.weight[:, :, None].to(dt),
                                         self.l_linear.bias.to(dt)))
        noise_b = draw_normal(uv.shape, uv, generator, zero_noise) * self.sine_amp / 3
        return sine_merge, noise_b, uv
