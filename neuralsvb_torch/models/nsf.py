"""NSF (neural source-filter) excitation sources; port of
``neuralsvb_tpu/models/nsf.py`` (reference:
modules/parallel_wavegan/models/source.py:7-399): ``SineGen`` (sine and
pulse mode) and ``SourceModuleHnNSF``, the HiFiGAN-NSF vocoder's source,
and the pulse-train and cyclic-noise sources ``PulseGen``,
``signals_conv1d``, ``CyclicNoiseGen`` and ``SourceModuleCycNoise``, which
no recipe reaches (as in the JAX package) and which take the JAX layout
``[B, L, D]``.

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

from ..parallel import ddp
from .common import draw_normal


class SineGen(nn.Module):
    def __init__(self, samp_rate: int, harmonic_num: int = 0, sine_amp: float = 0.1,
                 noise_std: float = 0.003, voiced_threshold: float = 0.0,
                 flag_for_pulse: bool = False):
        super().__init__()
        self.samp_rate = samp_rate
        self.harmonic_num = harmonic_num
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.voiced_threshold = voiced_threshold
        self.flag_for_pulse = flag_for_pulse  # phase-reset mode for PulseGen

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
                rand_ini = ddp.draw_rows(lambda s: torch.rand(s, generator=generator,
                                                              device=f0.device), (B, dim))
        rand_ini = torch.cat([torch.zeros_like(rand_ini[:, :1]), rand_ini[:, 1:]], 1)
        rad = torch.cat([rad[:, :, :1] + rand_ini[:, :, None], rad[:, :, 1:]], -1)
        if self.flag_for_pulse:
            # reset the phase integral at the start of every voiced segment,
            # so that its first step is cos(0): the cumsum is nondecreasing
            # (rad >= 0), so a running max carries its value at the last
            # step of each unvoiced segment forward
            uv_h = f0 * harmonics[:, None] > self.voiced_threshold
            uv_next = torch.cat([uv_h[:, :, 1:], torch.ones_like(uv_h[:, :, :1])], -1)
            u_loc = ~uv_h & uv_next
            c = torch.cumsum(rad, -1)
            carried = torch.cummax(torch.where(u_loc, c, torch.zeros_like(c)), -1).values
            sine_waves = torch.cos((c - carried) * 2 * math.pi) * self.sine_amp
        else:
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


def _bld(x: torch.Tensor) -> torch.Tensor:
    """[B, L, D] <-> [B, D, L]."""
    return x.transpose(1, 2)


def _injected(t: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if t is None else torch.as_tensor(t, dtype=like.dtype, device=like.device)


class PulseGen(nn.Module):
    """Pulse-train source: the local maxima of a phase-reset sine in voiced
    regions (reference: source.py:140-203)."""

    def __init__(self, samp_rate: int, pulse_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.noise_std = noise_std
        self.l_sinegen = SineGen(samp_rate, harmonic_num=0, sine_amp=pulse_amp,
                                 noise_std=0.0, voiced_threshold=voiced_threshold,
                                 flag_for_pulse=True)

    def forward(self, f0, generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, rand_ini=None, sine_noise=None, pulse_noise=None):
        """f0 [B, L, 1] Hz -> (pulse_train, sine_wav, uv, pulse_noise), each
        [B, L, 1]. ``rand_ini`` [B, 1], ``sine_noise`` and ``pulse_noise``
        [B, L, 1] standard normal override the draws."""
        f0 = torch.as_tensor(f0)
        sine_noise = _injected(sine_noise, f0)
        sine_wav, uv, noise = self.l_sinegen(
            _bld(f0), generator, zero_noise, _injected(rand_ini, f0),
            None if sine_noise is None else _bld(sine_noise))
        sine_wav, uv, noise = _bld(sine_wav), _bld(uv), _bld(noise)
        pure_sine = sine_wav - noise
        sine_prev = torch.cat([pure_sine[:, -1:], pure_sine[:, :-1]], 1)
        uv_prev = torch.cat([torch.zeros_like(uv[:, :1]), uv[:, :-1]], 1)
        sine_next = torch.cat([pure_sine[:, 1:], pure_sine[:, :1]], 1)
        uv_next = torch.cat([uv[:, 1:], torch.zeros_like(uv[:, :1])], 1)
        loc = (((pure_sine > sine_prev) & (pure_sine > sine_next)
                & (uv_prev > 0) & (uv_next > 0) & (uv > 0))
               | ((uv_prev < 1) & (uv > 0))).to(uv.dtype)
        pulse_train = pure_sine * loc
        pulse_noise = _injected(pulse_noise, pure_sine)
        if pulse_noise is None:
            pulse_noise = draw_normal(pure_sine.shape, pure_sine, generator, zero_noise)
        pulse_noise = pulse_noise * self.noise_std
        pulse_train = pulse_train + pulse_noise * loc + pulse_noise * (1 - uv)
        return pulse_train, sine_wav, uv, pulse_noise


def signals_conv1d(signal: torch.Tensor, system_ir: torch.Tensor) -> torch.Tensor:
    """Convolve a [B, L1, D] signal with a [L2, D] impulse response per dim,
    left-padded, [B, L1, D] out (reference: source.py:206-246). ``conv1d``
    is a correlation, so the response is flipped."""
    pad = system_ir.shape[0] - 1
    x = F.pad(_bld(signal), (pad, 0))
    w = system_ir.to(x.dtype).flip(0).T[:, None, :]  # [D, 1, L2]
    return _bld(F.conv1d(x, w, groups=signal.shape[-1]))


class CyclicNoiseGen(nn.Module):
    """Cyclic noise source: an exponentially decaying noise burst convolved
    with a pulse train (reference: source.py:249-307 CyclicNoiseGen_v1).
    The burst's length, 4.6 x sr / mean voiced F0 samples, depends on the
    data: the mean is read on the host, as the JAX package reads it
    eagerly."""

    def __init__(self, samp_rate: int, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.samp_rate = samp_rate
        self.noise_std = noise_std
        self.l_pulse = PulseGen(samp_rate, pulse_amp=1.0, noise_std=noise_std,
                                voiced_threshold=voiced_threshold)

    def forward(self, f0s, beta, generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, rand_ini=None, sine_noise=None,
                pulse_noise=None, burst=None):
        """f0s [B, L, 1] Hz, beta a scalar -> (cyc_noise, pulse_train,
        sine_wav, uv, noise), each [B, L, 1]. ``burst`` [burst length, 1]
        standard normal overrides that draw (the others as ``PulseGen``)."""
        f0s = torch.as_tensor(f0s)
        pulse_train, sine_wav, uv, noise = self.l_pulse(
            f0s, generator, zero_noise, rand_ini, sine_noise, pulse_noise)
        pure_pulse = pulse_train - noise
        if bool((uv < 1).all()):
            cyc_noise = torch.zeros_like(sine_wav)
        else:
            f0mean = float(f0s[uv > 0].mean())
            length = int(4.6 * self.samp_rate / f0mean)
            t = torch.arange(length, dtype=torch.float32, device=f0s.device)[:, None]
            decay = torch.exp(-t * f0mean / float(beta) / self.samp_rate)
            burst = _injected(burst, decay)
            if burst is None:
                burst = draw_normal(t.shape, t, generator, zero_noise)
            elif burst.shape != t.shape:
                raise ValueError(f"burst {tuple(burst.shape)} != {tuple(t.shape)}")
            cyc_noise = signals_conv1d(pure_pulse, burst * self.noise_std * decay)
        cyc_noise = cyc_noise + noise * (1.0 - uv)
        return cyc_noise, pulse_train, sine_wav, uv, noise


class SourceModuleCycNoise(nn.Module):
    """Cyclic-noise source module (reference: source.py:310-349)."""

    def __init__(self, sampling_rate: int, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.noise_std = noise_std
        self.l_cyc_gen = CyclicNoiseGen(sampling_rate, noise_std, voiced_threshold)

    def forward(self, f0_upsamped, beta, generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, rand_ini=None, sine_noise=None,
                pulse_noise=None, burst=None, noise=None):
        """f0 [B, L, 1] Hz, beta -> (cyc [B, L, 1], noise [B, L, 1], uv);
        ``noise`` [B, L, 1] standard normal overrides the last draw."""
        cyc, _, _, uv, _ = self.l_cyc_gen(f0_upsamped, beta, generator, zero_noise,
                                          rand_ini, sine_noise, pulse_noise, burst)
        noise = _injected(noise, uv)
        if noise is None:
            noise = draw_normal(uv.shape, uv, generator, zero_noise)
        return cyc, noise * self.noise_std / 3, uv
