"""The port's small remaining modules against the JAX package's: the
mel-cepstrum helpers (1e-10), HiFiGAN's torch-style mel frontend (1e-5),
the mask and attention-diagnostic helpers (exactly), the validation figures
(the same drawn arrays; ``JsonLogger.add_figure`` writes a PNG), the
parameter count, and both packages raising without ``pysptk``."""

from __future__ import annotations

import io
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

import jax.numpy as jnp  # noqa: E402
from jax import enable_x64  # noqa: E402

from neuralsvb_torch import utils as tutils  # noqa: E402
from neuralsvb_torch.ops import pitch_utils as tpu_  # noqa: E402
from neuralsvb_torch.ops import stft as tstft  # noqa: E402
from neuralsvb_torch.utils import plot as tplot  # noqa: E402
from neuralsvb_torch.utils import tts_utils as ttts  # noqa: E402
from neuralsvb_tpu import utils as jutils  # noqa: E402
from neuralsvb_tpu.ops import pitch_utils as jpu  # noqa: E402
from neuralsvb_tpu.ops import stft as jstft  # noqa: E402
from neuralsvb_tpu.utils import plot as jplot  # noqa: E402
from neuralsvb_tpu.utils import tts_utils as jtts  # noqa: E402


def test_mcep_helpers_match_jax():
    rng = np.random.RandomState(0)
    f0 = rng.uniform(80, 400, 200)
    f0[::7] = 0.0
    mc = rng.randn(50, 25) * 0.3
    lf0 = jpu.to_lf0(f0)
    for name, args in (("to_lf0", (f0,)), ("to_f0", (lf0,)), ("mc2b", (mc, 0.45)),
                       ("b2mc", (mc, 0.45)), ("formant_enhancement", (mc, 0.3, 22050))):
        got, want = getattr(tpu_, name)(*args), getattr(jpu, name)(*args)
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-10, name
    assert np.abs(tpu_.b2mc(tpu_.mc2b(mc)) - mc).max() <= 1e-10  # inverse pair


@pytest.mark.parametrize("fn", ["code_harmonic", "decode_harmonic"])
def test_harmonic_coders_need_pysptk_in_both(fn):
    sp = np.ones((2, 1025))
    for mod in (tpu_, jpu):
        with pytest.raises(ModuleNotFoundError, match="pysptk"):
            getattr(mod, fn)(sp, 60) if fn == "code_harmonic" else getattr(mod, fn)(sp)


@pytest.mark.parametrize("center", [False, True])
def test_mel_spectrogram_hifigan_matches_jax(center):
    hp = dict(fft_size=1024, hop_size=256, win_size=800, audio_sample_rate=22050,
              audio_num_mel_bins=80, fmin=80, fmax=7600)
    y = np.random.RandomState(1).uniform(-1.2, 1.2, (2, 5000)).astype(np.float32)
    got = tstft.mel_spectrogram_hifigan(y, hp, center)
    want = jstft.mel_spectrogram_hifigan(y, hp, center)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-5


def test_tts_utils_match_jax_exactly():
    rng = np.random.RandomState(2)
    lengths = np.array([5, 9, 1])
    ids = np.where(np.arange(9)[None] < lengths[:, None], rng.randint(1, 50, (3, 9)), 0)
    attn = rng.rand(3, 7, 9)
    attn /= attn.sum(-1, keepdims=True)
    tgt_pad = np.arange(7)[None] >= np.array([7, 4, 2])[:, None]
    with enable_x64(True):
        src_pad_j = jtts.make_pad_mask(lengths, 9)
        want = {
            "sequence_mask": jtts.sequence_mask(lengths),
            "make_pad_mask": src_pad_j,
            "make_positions": jtts.make_positions(jnp.asarray(ids)),
            "focus": jtts.get_focus_rate(jnp.asarray(attn)),
            "focus_masked": jtts.get_focus_rate(jnp.asarray(attn), src_pad_j,
                                                jnp.asarray(tgt_pad)),
            "coverage": jtts.get_phone_coverage_rate(jnp.asarray(attn)),
            "coverage_masked": jtts.get_phone_coverage_rate(jnp.asarray(attn), src_pad_j,
                                                            jnp.asarray(tgt_pad), 0.12),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
    at, src_pad = torch.as_tensor(attn), ttts.make_pad_mask(torch.as_tensor(lengths), 9)
    got = {
        "sequence_mask": ttts.sequence_mask(torch.as_tensor(lengths)),
        "make_pad_mask": src_pad,
        "make_positions": ttts.make_positions(torch.as_tensor(ids)),
        "focus": ttts.get_focus_rate(at),
        "focus_masked": ttts.get_focus_rate(at, src_pad, torch.as_tensor(tgt_pad)),
        "coverage": ttts.get_phone_coverage_rate(at),
        "coverage_masked": ttts.get_phone_coverage_rate(at, src_pad, torch.as_tensor(tgt_pad),
                                                        0.12),
    }
    for k, v in got.items():
        if v.dtype == torch.float64:
            assert np.abs(v.numpy() - want[k]).max() <= 1e-15, k
        else:
            assert v.dtype in (torch.bool, torch.int32) and np.array_equal(v.numpy(), want[k]), k


def _drawn(fig):
    """The arrays a figure draws: its pcolor meshes and its lines."""
    ax = fig.axes[0]
    return ([np.asarray(c.get_array()) for c in ax.collections if hasattr(c, "get_array")
             and c.get_array() is not None]
            + [np.asarray(ln.get_ydata()) for ln in ax.get_lines()])


def test_figures_match_jax_and_the_logger_writes_png(tmp_path):
    import matplotlib.pyplot as plt
    from neuralsvb_torch.training.logger import JsonLogger
    rng = np.random.RandomState(3)
    spec, f0 = rng.randn(40, 20), rng.uniform(0, 400, 40)
    cases = [("spec_to_figure", (spec,), dict(vmin=-1, vmax=1, title="gt|pred")),
             ("spec_f0_to_figure", (spec, {"gt": f0, "pred": f0 * 1.1}), {}),
             ("f0_to_figure", (f0, f0 * 0.9, f0 * 1.1), {}),
             ("dur_to_figure", (np.array([3, 4, 5]), np.array([4, 4, 4]), ["a", "b", "c"]), {})]
    logger = JsonLogger(str(tmp_path))
    assert logger.writes_figures
    for name, args, kw in cases:
        fj = getattr(jplot, name)(*args, **kw)
        targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
        ft = getattr(tplot, name)(*targs, **kw)
        dj, dt = _drawn(fj), _drawn(ft)
        assert len(dj) == len(dt) > 0 or name == "dur_to_figure", name
        for a, b in zip(dt, dj):
            assert np.array_equal(a, b), name
        plt.close(fj)
        path = logger.add_figure(name, ft, 7)
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert not plt.fignum_exists(ft.number)  # closed
    assert sorted(p.name for p in (tmp_path / "lightning_logs" / "version_0" / "figures")
                  .iterdir()) == sorted(f"{n}_step7.png" for n, _, _ in cases)


def test_num_params_and_tensors_to_np_match_jax():
    from tests.test_torch_support import seeded
    from tests.test_torch_svb_vae import TINY, jax_svbvae
    from neuralsvb_torch.models.svb_vae import SVBVAE
    tm = seeded(lambda: SVBVAE(20, **TINY), 5).requires_grad_(False)
    _, params, _ = jax_svbvae(tm)
    out_t, out_j = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_t):
        n_t = tutils.num_params(tm, model_name="Generator")
    with contextlib.redirect_stdout(out_j):
        n_j = jutils.num_params(params, model_name="Generator")
    assert n_t == n_j and out_t.getvalue() == out_j.getvalue()
    d = {"a": torch.arange(3), "b": [torch.ones(2), 5], "c": (torch.zeros(1),)}
    got, want = tutils.tensors_to_np(d), jutils.tensors_to_np(
        {"a": jnp.arange(3), "b": [jnp.ones(2), 5], "c": (jnp.zeros(1),)})
    assert isinstance(got["a"], np.ndarray) and got["b"][1] == 5 and isinstance(got["c"], tuple)
    for k in ("a", "b", "c"):
        for x, y in zip(jax.tree_util.tree_leaves(got[k]), jax.tree_util.tree_leaves(want[k])):
            assert np.array_equal(x, y), k


def test_the_logger_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib the logger says so once and draws nothing (the
    card machine's case)."""
    import sys
    from neuralsvb_torch.training.logger import JsonLogger
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # find_spec -> None
    logger = JsonLogger(str(tmp_path))
    assert not logger.writes_figures
    assert capsys.readouterr().out.count("| figures not written: no matplotlib") == 1
