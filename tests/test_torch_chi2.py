"""The chi-square DTW cost of the port (``neuralsvb_torch/ops/chi2.py``)
against the JAX package: its Pallas kernel in interpret mode
(``chi2_dist_pallas(interpret=True)``) and the numpy ``chi2_dist`` the JAX
binarizer runs, at atol 1e-5 (the JAX package's own tolerance,
tests/test_pallas.py). The CUDA kernel is held against the plain version on
the card only (``cuda`` marker; ``chip_smoke.py`` does it at the binarizer's
shapes). Swapping the arguments transposes the result bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralsvb_tpu.ops.dtw import chi2_dist as chi2_np  # noqa: E402
from neuralsvb_tpu.ops.pallas_kernels import chi2_dist_pallas  # noqa: E402

from neuralsvb_torch.ops import chi2  # noqa: E402


def _hists(s, t, m=48, seed=0, zero_rows=()):
    rng = np.random.RandomState(seed)
    a = rng.rand(s, m).astype(np.float32)
    b = rng.rand(t, m).astype(np.float32)
    a /= a.sum(1, keepdims=True)
    b /= b.sum(1, keepdims=True)
    for r in zero_rows:
        a[r % s] = 0.0
        b[r % t] = 0.0
    return a, b


@pytest.mark.parametrize("s,t,m,zero_rows", [
    (70, 150, 48, ()),            # the shapes of tests/test_pallas.py
    (300, 130, 48, ()),
    (129, 257, 48, ()),           # ragged against 64- and 128-row tiles
    (65, 33, 48, (0, 7, 32)),     # histograms of frames with no slopes
    (1, 1, 48, (0,)),
])
def test_plain_matches_jax(s, t, m, zero_rows):
    a, b = _hists(s, t, m, seed=s + t, zero_rows=zero_rows)
    ref = chi2_np(a, b)
    pallas = np.asarray(chi2_dist_pallas(a, b, interpret=True))
    out = chi2.chi2_dist(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and tuple(out.shape) == (s, t)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), pallas, atol=1e-5)
    np.testing.assert_array_equal(out.numpy(), chi2.chi2_dist_plain(
        torch.from_numpy(a), torch.from_numpy(b), chunk=16).numpy())


def _vibrato_hists(s, t):
    """EHSADTW histograms of two vibrato f0 contours with unvoiced stretches."""
    from neuralsvb_torch.ops.dtw import f0_shape_histogram

    def f0(n, period, seed):
        rng = np.random.RandomState(seed)
        x = 220 + 40 * np.sin(2 * np.pi * np.arange(n) / period) + rng.randn(n)
        x[n // 3: n // 3 + n // 12] = 0.0
        return x

    return (f0_shape_histogram(f0(s, 50, s), enhanced=True).astype(np.float32),
            f0_shape_histogram(f0(t, 55, t), enhanced=True,
                               scale_factor=t / s).astype(np.float32))


def _out_of_range(s, t, seed):
    """Histograms with values outside {0} U [2^-24, 2^24] (1e-30, 1e8 and
    negative, a + b below -0.8) in bins 16-31 of some rows: the CUDA
    kernel divides those chunks with `/`, the others branch-free."""
    a, b = _hists(s, t, seed=seed, zero_rows=(0, 5))
    a[1::97, 16:20] = 1e-30
    b[2::89, 20:24] = 1e8
    a[3::151, 24:28] = -1.0 - a[3::151, 24:28]
    b[4::113, 28:32] = 1e-30
    return a, b


@pytest.mark.parametrize("s,t", [(130, 70), (300, 230)])
def test_plain_matches_numpy_outside_the_branch_free_range(s, t):
    a, b = _out_of_range(s, t, seed=s)
    ref = chi2_np(a, b)
    out = chi2.chi2_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.isfinite(out).all() and np.abs(ref).max() > 1e7 and ref.min() < -1.0
    assert (np.abs(out - ref) / np.maximum(1.0, np.abs(ref))).max() <= 1e-5


@pytest.mark.parametrize("s,t,kind", [
    (129, 257, "random"), (1037, 1301, "random"), (65, 33, "zero_rows"),
    (1, 1, "zero_rows"), (300, 130, "histograms"), (97, 211, "histograms"),
    (130, 70, "out_of_range"), (1037, 1301, "out_of_range"),
])
def test_swapped_arguments_give_the_transpose_bit_for_bit(s, t, kind):
    """Each term is symmetric in (a, b) bit for bit and the sum runs over m
    in one order, so chi2_dist(b, a) == chi2_dist(a, b).T exactly: the
    aligners compute their [T, S] cost that way, without a transpose."""
    if kind == "histograms":
        a, b = _vibrato_hists(s, t)
        assert (a == 0).mean() > 0.3 and (b == 0).mean() > 0.3
    elif kind == "out_of_range":
        a, b = _out_of_range(s, t, seed=s)
    else:
        a, b = _hists(s, t, seed=s, zero_rows=(0, 3, 7) if kind == "zero_rows" else ())
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    ab = chi2.chi2_dist(a, b)
    assert torch.equal(chi2.chi2_dist(b, a), ab.T)
    assert torch.equal(chi2.chi2_dist_plain(b, a, chunk=16), ab.T)


def test_cpu_runs_plain_and_other_devices_raise():
    a, b = (torch.from_numpy(x) for x in _hists(5, 6))
    before = chi2.chi2_dist.launches
    chi2.chi2_dist(a, b)
    assert chi2.chi2_dist.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="no kernel"):
        chi2.chi2_dist(a.to("meta"), b.to("meta"))


def test_import_builds_nothing():
    assert chi2.LIBRARY._lib is None
    assert chi2.SOURCE.exists() and chi2.SOURCE.suffix == ".cu"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    for s, t in ((2400, 2400), (1037, 1301), (130, 70), (1, 1)):
        a, b = (torch.from_numpy(x).cuda() for x in _hists(s, t, zero_rows=(0, 5)))
        before = chi2.chi2_dist.launches
        out = chi2.chi2_dist(a, b)
        torch.cuda.synchronize()
        assert chi2.chi2_dist.launches == before + 1
        ref = chi2.chi2_dist_plain(a, b)
        assert float((out - ref).abs().max()) <= 1e-5
        assert torch.equal(chi2.chi2_dist(b, a), out.T)
        a, b = (torch.from_numpy(x).cuda() for x in _out_of_range(s, t, seed=s))
        out, ref = chi2.chi2_dist(a, b), chi2.chi2_dist_plain(a, b)
        assert float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max()) <= 1e-5
        assert torch.equal(chi2.chi2_dist(b, a), out.T)
