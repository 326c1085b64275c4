"""The port's pulse-train and cyclic-noise NSF sources against the JAX
package's (``neuralsvb_torch/models/nsf.py`` vs ``neuralsvb_tpu/models/nsf.py``):
``SineGen`` in pulse mode, ``PulseGen``, ``signals_conv1d``,
``CyclicNoiseGen`` and ``SourceModuleCycNoise``.

The JAX side runs with ``jax.random.normal``/``uniform`` wrapped by
``monkeypatch``: every draw is recorded in call order and handed to the port
as its injected tensors. The uniform draws (the overtones' initial phases)
are rounded to multiples of 1/1024 and the F0 curves sit on a grid of
sr/1024 Hz, so every phase sum is exact in float32 on both sides (the
port's ``SineGen`` integrates the phase in float32 whatever its input,
``ROADMAP.md`` §3). Inputs are seeded numpy F0 curves with voiced and
unvoiced segments, plus one all-unvoiced case. Tolerances: 1e-6 with
float64 inputs (the JAX side under ``enable_x64``), 1e-5 in float32.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import enable_x64  # noqa: E402

from neuralsvb_torch.models import nsf as tnsf  # noqa: E402
from neuralsvb_tpu.models import nsf as jnsf  # noqa: E402

SR = 22050
TOL = {"float64": 1e-6, "float32": 1e-5}


def f0_curve(seed, B=2, L=1600, unvoiced=False):
    """[B, L, 1] Hz: 8 segments per row at odd multiples of sr/1024
    (194-366 Hz), segments 2 and 5 unvoiced, row 1 starting unvoiced. With
    odd multiples no peak of the pulse sine falls halfway between two
    samples, where two equal values leave ``PulseGen``'s local maximum to
    rounding."""
    if unvoiced:
        return np.zeros((B, L, 1))
    rng = np.random.RandomState(seed)
    k = 2 * rng.randint(4, 9, size=(B, 8)) + 1
    f0 = np.repeat(k * SR / 1024, L // 8, axis=1)
    f0[:, 2 * L // 8: 3 * L // 8] = 0.0
    f0[:, 5 * L // 8: 6 * L // 8] = 0.0
    f0[1, : L // 16] = 0.0
    return f0[..., None]


@pytest.fixture
def draws(monkeypatch):
    """JAX's draws in call order, as numpy; uniforms on the 1/1024 grid."""
    got = []
    normal, uniform = jax.random.normal, jax.random.uniform

    def rec_normal(*a, **k):
        out = normal(*a, **k)
        got.append(np.asarray(out))
        return out

    def rec_uniform(*a, **k):
        out = jnp.round(uniform(*a, **k) * 1024) / 1024
        got.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", rec_normal)
    monkeypatch.setattr(jax.random, "uniform", rec_uniform)
    return got


def jax_apply(module, *args, dtype):
    with enable_x64(dtype == "float64"):
        args = [jnp.asarray(a, dtype) if isinstance(a, np.ndarray) else a for a in args]
        out = module.apply({}, *args, rngs={"noise": jax.random.PRNGKey(0)})
        return jax.tree_util.tree_map(np.asarray, out)


def agree(port, ref, tol, name):
    for i, (a, b) in enumerate(zip(port, ref)):
        a = a.detach().cpu().numpy()
        assert a.shape == b.shape, (name, i, a.shape, b.shape)
        d = float(np.abs(a.astype(np.float64) - b).max())
        assert d <= tol, f"{name}[{i}]: max |d| = {d:.3e} > {tol}"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("harmonic_num", [0, 2])
def test_sinegen_pulse_mode_matches_jax(draws, dtype, harmonic_num):
    f0 = f0_curve(harmonic_num)
    ref = jax_apply(jnsf.SineGen(SR, harmonic_num, flag_for_pulse=True), f0, dtype=dtype)
    rand_ini, noise = draws
    port = tnsf.SineGen(SR, harmonic_num, flag_for_pulse=True)(
        torch.as_tensor(f0).transpose(1, 2), rand_ini=torch.as_tensor(rand_ini),
        noise=torch.as_tensor(noise).transpose(1, 2))
    agree([t.transpose(1, 2) for t in port], ref, TOL[dtype], "SineGen pulse")
    # the phase integral restarts at each voiced segment: its first sample
    # is 0.1 cos(2 pi f0 / sr), one step from phase 0
    sine = (port[0][:, 0] - port[2][:, 0])[:, 1:]
    uv = port[1][:, 0]
    starts = (uv[:, 1:] > 0) & (uv[:, :-1] < 1)
    assert bool(starts.any())
    want = 0.1 * np.cos(2 * np.pi * f0[:, 1:, 0][starts.numpy()] / SR)
    assert np.abs(sine[starts].numpy() - want).max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("unvoiced", [False, True])
def test_pulsegen_matches_jax(draws, dtype, unvoiced):
    f0 = f0_curve(1, unvoiced=unvoiced)
    ref = jax_apply(jnsf.PulseGen(SR), f0, dtype=dtype)
    rand_ini, sine_noise, pulse_noise = draws
    port = tnsf.PulseGen(SR)(torch.as_tensor(f0), rand_ini=rand_ini, sine_noise=sine_noise,
                             pulse_noise=pulse_noise)
    agree(port, ref, TOL[dtype], "PulseGen")
    pulses = int(((port[0] - port[3]) != 0).sum())  # the noise-free train
    assert (pulses == 0) == unvoiced, pulses


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_signals_conv1d_is_a_true_convolution(dtype):
    rng = np.random.RandomState(3)
    sig, ir = rng.randn(2, 300, 3), rng.randn(40, 3)
    with enable_x64(dtype == "float64"):
        ref = np.asarray(jnsf.signals_conv1d(jnp.asarray(sig, dtype), jnp.asarray(ir, dtype)))
    port = tnsf.signals_conv1d(torch.as_tensor(sig, dtype=getattr(torch, dtype)),
                               torch.as_tensor(ir, dtype=getattr(torch, dtype)))
    agree([port], [ref], TOL[dtype], "signals_conv1d")
    want = np.stack([[np.convolve(sig[b, :, d], ir[:, d])[:300] for d in range(3)]
                     for b in range(2)]).transpose(0, 2, 1)
    assert np.abs(port.numpy() - want).max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("unvoiced", [False, True])
def test_cyclic_noise_matches_jax(draws, dtype, unvoiced):
    f0 = f0_curve(2, unvoiced=unvoiced)
    ref = jax_apply(jnsf.CyclicNoiseGen(SR), f0, 0.87, dtype=dtype)
    rand_ini, sine_noise, pulse_noise, *burst = draws
    assert len(burst) == (0 if unvoiced else 1)  # no burst drawn when all unvoiced
    port = tnsf.CyclicNoiseGen(SR)(torch.as_tensor(f0), 0.87, rand_ini=rand_ini,
                                   sine_noise=sine_noise, pulse_noise=pulse_noise,
                                   burst=burst[0] if burst else None)
    agree(port, ref, TOL[dtype], "CyclicNoiseGen")
    if not unvoiced:
        voiced = f0[f0 > 0]
        assert burst[0].shape == (int(4.6 * SR / voiced.mean()), 1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("unvoiced", [False, True])
def test_source_module_cyc_noise_matches_jax(draws, dtype, unvoiced):
    f0 = f0_curve(3, unvoiced=unvoiced)
    ref = jax_apply(jnsf.SourceModuleCycNoise(SR), f0, 1.0, dtype=dtype)
    rand_ini, sine_noise, pulse_noise, *rest = draws
    burst, noise = (None, rest[0]) if unvoiced else rest
    port = tnsf.SourceModuleCycNoise(SR)(torch.as_tensor(f0), 1.0, rand_ini=rand_ini,
                                         sine_noise=sine_noise, pulse_noise=pulse_noise,
                                         burst=burst, noise=noise)
    agree(port, ref, TOL[dtype], "SourceModuleCycNoise")


def test_cyclic_noise_draws_from_its_generator():
    """Without injected draws every draw comes from the generator: the same
    seed gives the same output, another seed another."""
    f0 = torch.as_tensor(f0_curve(4), dtype=torch.float32)
    m = tnsf.SourceModuleCycNoise(SR)
    a = m(f0, 1.0, torch.Generator().manual_seed(0))
    b = m(f0, 1.0, torch.Generator().manual_seed(0))
    c = m(f0, 1.0, torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    z = m(f0, 1.0, zero_noise=True)
    assert float(z[1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="burst"):
        tnsf.CyclicNoiseGen(SR)(f0, 1.0, zero_noise=True, burst=torch.zeros(3, 1))
