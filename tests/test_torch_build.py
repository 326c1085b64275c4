"""Building the port's CUDA kernel where there is no CUDA toolkit.

Importing the kernel module needs neither nvcc nor triton; the build runs
only when a kernel is first launched. Here (no nvcc, no card) the build
raises a clear error, and nothing falls back to the plain version for a
tensor that is not on the CPU."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from neuralsvb_torch.ops import chi2  # noqa: E402
from neuralsvb_torch.ops import fused_resblock as fr  # noqa: E402
from neuralsvb_torch.ops import shared_lib  # noqa: E402


def test_import_needs_no_toolkit():
    code = ("import sys; import neuralsvb_torch.ops.fused_resblock as f; "
            "import neuralsvb_torch.models.hifigan; "
            "assert 'triton' not in sys.modules; "
            "assert f.LIBRARY._lib is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=fr.SOURCE.parents[2])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert fr.SOURCE.exists() and fr.SOURCE.suffix == ".cu"


def test_build_without_nvcc_raises():
    if shutil.which("nvcc"):
        pytest.skip("a CUDA toolkit is present here")
    for lib in (fr.LIBRARY, chi2.LIBRARY):
        for _ in range(2):  # raises every time: no cached fallback
            with pytest.raises(RuntimeError, match="nvcc"):
                lib.get()


def test_launch_refuses_cpu_tensors():
    x = torch.zeros(1, 64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fr.resblock_conv1d(x, torch.zeros(64, 3, 64), torch.zeros(64), 3, 1, out=x)


def test_no_fallback_for_non_cpu_tensors():
    spec = fr.make_spec((3,), ((1,),))
    w = [torch.zeros(1, 8, 3, 8), torch.zeros(1, 8), torch.zeros(1, 8, 3, 8),
         torch.zeros(1, 8)]
    x = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fr.fused_resblock_cluster(x, [t.to("meta") for t in w], spec)


def test_build_dir_of_checkout_and_of_installed_package(tmp_path, monkeypatch):
    """From a checkout the library goes to its ``build/kernels/``; an
    installed package, with no checkout around it, builds under ``$HOME``."""
    assert shared_lib.BUILD_DIR == fr.SOURCE.parents[2] / "build" / "kernels"
    site = tmp_path / "lib" / "python3" / "site-packages"
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert shared_lib.build_dir(site / "neuralsvb_torch") == \
        tmp_path / "home" / ".cache" / "neuralsvb_torch" / "kernels"
