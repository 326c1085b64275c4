"""The port's shape-aware DTW (``neuralsvb_torch/ops/dtw.py``) and host C++
kernels (``neuralsvb_torch/native.py``) against the JAX package.

The port builds its own copy of the JAX package's ``dtw.cpp`` with the same
flags, so the DP paths must be identical. The histograms are the same float64 numpy code
(1e-12, the JAX package's own tolerance for them). The aligners differ only
in the chi-square cost's summation order (torch vs numpy), so the
alignments are held equal on >= 99% of frames and the DP's total path cost
to 1e-5 relative.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralsvb_tpu.native import pitch_viterbi_native as j_viterbi  # noqa: E402
from neuralsvb_tpu.ops import dtw as JD  # noqa: E402

from neuralsvb_torch import native  # noqa: E402
from neuralsvb_torch.ops import dtw as TD  # noqa: E402
from neuralsvb_torch.ops.chi2 import chi2_dist  # noqa: E402
from neuralsvb_torch.ops.shared_lib import GXX_FLAGS, SharedLibrary  # noqa: E402

CPU = torch.device("cpu")


def _vibrato_f0(n, period, seed, depth=50.0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    f0 = 220 + depth * np.sin(2 * np.pi * t / period) + rng.randn(n)
    f0[n // 3: n // 3 + n // 10] = 0.0  # an unvoiced stretch
    return f0


@pytest.mark.parametrize("enhanced,scale", [(False, 1.0), (True, 1.0), (True, 1.37)])
def test_histogram_matches_jax(enhanced, scale):
    f0 = _vibrato_f0(200, 40, 1)
    np.testing.assert_allclose(
        TD.f0_shape_histogram(f0, enhanced=enhanced, scale_factor=scale),
        JD.f0_shape_histogram(f0, enhanced=enhanced, scale_factor=scale), atol=1e-12)


@pytest.mark.parametrize("s,t", [(40, 55), (1, 7), (9, 1), (120, 97)])
def test_align_from_distances_equals_jax(s, t):
    cost = np.random.RandomState(s * t).rand(s, t).astype(np.float32)
    path = TD.align_from_distances(torch.from_numpy(cost))
    np.testing.assert_array_equal(path, JD.align_from_distances(cost))
    np.testing.assert_array_equal(path, JD._backtrace(JD.time_warp_np(cost)))


def test_pitch_viterbi_equals_jax():
    rng = np.random.RandomState(3)
    freqs = rng.uniform(80, 600, (200, 12)).astype(np.float32)
    freqs[rng.rand(200, 12) < 0.2] = 0.0
    strengths = rng.rand(200, 12).astype(np.float32)
    np.testing.assert_array_equal(
        native.pitch_viterbi_native(freqs, strengths, 0.35, 0.14),
        j_viterbi(freqs, strengths, 0.35, 0.14))


@pytest.mark.parametrize("name", ["SADTW", "EHSADTW"])
@pytest.mark.parametrize("n_src,n_tgt,stretch", [
    (300, 300, 1.0),    # same take, other noise
    (200, 300, 1.5),    # the professional sings 1.5x slower
    (260, 231, 0.89),
])
def test_aligners_match_jax(name, n_src, n_tgt, stretch):
    src = _vibrato_f0(n_src, 50, 2)
    tgt = _vibrato_f0(n_tgt, 50 * stretch, 3)
    out_t, al_t = TD.ALIGN_FUNCS[name](src, tgt, src, CPU)
    out_j, al_j = JD.ALIGN_FUNCS[name](src, tgt, src)
    assert al_t.shape == al_j.shape == (n_tgt,)
    assert np.mean(al_t == al_j) >= 0.99
    np.testing.assert_array_equal(out_t, src[al_t])
    assert (np.diff(al_t[1:]) >= 0).all() and al_t.max() < n_src
    # the DP's total path cost over the two cost matrices
    sh = JD.f0_shape_histogram(src, enhanced=name == "EHSADTW")
    th = JD.f0_shape_histogram(tgt, enhanced=name == "EHSADTW",
                               scale_factor=n_tgt / n_src)
    _, total_t = native.dtw_align_native(TD._chi2_cost(sh, th, CPU).numpy())
    _, total_j = native.dtw_align_native(np.ascontiguousarray(JD.chi2_dist(sh, th).T))
    assert abs(total_t - total_j) <= 1e-5 * abs(total_j)


def _code(path):
    """A C++ source without its leading comment block."""
    text = path.read_text()
    return text[text.index("#include"):]


def test_dtw_source_is_the_ports_own_copy():
    """The port builds a source under its own package, with the same code
    as the JAX package's."""
    port = Path(TD.__file__).resolve().parents[1]
    assert native.SOURCE.resolve().is_relative_to(port)
    assert native.LIBRARY.source == native.SOURCE
    jax_src = Path(JD.__file__).resolve().parents[1] / "native" / "dtw.cpp"
    assert _code(native.SOURCE) == _code(jax_src)


@pytest.mark.parametrize("name", ["SADTW", "EHSADTW"])
@pytest.mark.parametrize("n_src,n_tgt,stretch", [(300, 300, 1.0), (200, 300, 1.5),
                                                 (260, 231, 0.89)])
def test_aligners_match_the_transposed_cost(name, n_src, n_tgt, stretch):
    """The aligners read ``chi2_dist(target, source)`` as the DP's [T, S]
    cost; the alignment and gathered inputs are those of the transposed
    ``chi2_dist(source, target)``, exactly, and the JAX aligner's on >= 99%
    of frames."""
    src = _vibrato_f0(n_src, 50, 4)
    tgt = _vibrato_f0(n_tgt, 50 * stretch, 5)
    inputs = np.arange(n_src) * 0.5
    out, al = TD.ALIGN_FUNCS[name](src, tgt, inputs, CPU)
    enhanced = name == "EHSADTW"
    sh = torch.as_tensor(TD.f0_shape_histogram(src, enhanced=enhanced), dtype=torch.float32)
    th = torch.as_tensor(TD.f0_shape_histogram(tgt, enhanced=enhanced,
                                               scale_factor=n_tgt / n_src),
                         dtype=torch.float32)
    cost_st = chi2_dist(sh, th)
    assert torch.equal(TD._chi2_cost(sh.numpy(), th.numpy(), CPU), cost_st.T)
    al_st = TD.align_from_distances(cost_st.T.contiguous())
    np.testing.assert_array_equal(al, al_st)
    np.testing.assert_array_equal(out, inputs[al_st])
    _, al_j = JD.ALIGN_FUNCS[name](src, tgt, inputs)
    assert np.mean(al == al_j) >= 0.99


def test_align_from_distances_takes_arrays_tensors_and_views():
    cost = np.random.RandomState(9).rand(60, 45)
    want = TD.align_from_distances(cost.astype(np.float32))
    t = torch.from_numpy(cost.astype(np.float32))
    view = torch.from_numpy(np.ascontiguousarray(cost.T, dtype=np.float32)).T
    assert not view.is_contiguous()
    for x in (t, view, torch.from_numpy(cost), cost, cost.T.copy().T):
        np.testing.assert_array_equal(TD.align_from_distances(x), want)


def test_failed_build_raises(tmp_path):
    """No fallback: a missing compiler or a source that does not compile
    raises, every time."""
    missing = SharedLibrary("x", native.SOURCE, ("no-such-gxx",), GXX_FLAGS,
                            lambda lib: None)
    bad_src = tmp_path / "bad.cpp"
    bad_src.write_text("this is not C++\n")
    bad = SharedLibrary("bad", bad_src, ("g++",), GXX_FLAGS, lambda lib: None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no-such-gxx not found"):
            missing.get()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            bad.get()
    with pytest.raises(ValueError, match="non-empty"):
        native.dtw_align_native(np.zeros((0, 3), np.float32))
