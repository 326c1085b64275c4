"""The chi-square DTW cost of the port (``neuralsvb_torch/ops/chi2.py``)
against the JAX package: its Pallas kernel in interpret mode
(``chi2_dist_pallas(interpret=True)``) and the numpy ``chi2_dist`` the JAX
binarizer runs, at atol 1e-5 (the JAX package's own tolerance,
tests/test_pallas.py). The CUDA kernel is held against the plain version on
the card only (``cuda`` marker; ``chip_smoke.py`` does it at the binarizer's
shapes)."""

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
