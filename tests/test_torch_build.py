"""Building the port's CUDA kernel where there is no CUDA toolkit.

Importing the kernel module needs neither nvcc nor triton; the build runs
only when a kernel is first launched. Here (no nvcc, no card) the build
raises a clear error, and nothing falls back to the plain version for a
tensor that is not on the CPU."""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from neuralsvb_torch.ops import chi2  # noqa: E402
from neuralsvb_torch.ops import dilated_conv as dc  # noqa: E402
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
    for lib in (fr.LIBRARY, fr.LIBRARY_BF16, dc.LIBRARY, chi2.LIBRARY):
        for _ in range(2):  # raises every time: no cached fallback
            with pytest.raises(RuntimeError, match="nvcc"):
                lib.get()


def test_launch_refuses_cpu_tensors():
    x = torch.zeros(1, 64, 128)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fr.resblock_conv1d(x, torch.zeros(64, 3, 64), torch.zeros(64), 3, 1, out=x)
    with pytest.raises(ValueError, match="CUDA"):
        fr.resblock_conv1d_bf16(xb.transpose(1, 2).contiguous(),
                                torch.zeros(64, 3, 64, dtype=torch.bfloat16),
                                torch.zeros(64), 3, 1, cur_out=x)
    with pytest.raises(ValueError, match="CUDA"):
        fr.lrelu_bf16(x, xb.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        dc.conv(x, torch.zeros(64, 3, 64), 1, x, lrelu=True, dgrad=True)
    with pytest.raises(ValueError, match="CUDA"):
        dc.wgrad(x, x, 1, torch.zeros(2, 64, 64, 3), None, lrelu=True)
    with pytest.raises(ValueError, match="CUDA"):
        dc.reduce(torch.zeros(2, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        fr.resblock_cluster_backward_cuda(x, [], (), x)


def test_backward_bindings_match_the_c_interface():
    """Every entry point of ``csrc/dilated_conv_backward.cu``, which both the
    cluster's and the AMP towers' backward launch, is bound with one ctypes
    type per C parameter, pointers as ``c_void_p``."""
    src = dc.SOURCE.read_text()
    lib = types.SimpleNamespace()
    entries = re.findall(r'extern "C" int (nsvb_\w+)\(([^)]*)\)', src)
    for name, _ in entries:
        setattr(lib, name, types.SimpleNamespace())
    dc._bind(lib)
    assert {n for n, _ in entries} == {"nsvb_dconv", "nsvb_dconv_wgrad", "nsvb_dconv_reduce"}
    for name, params in entries:
        params = [p.strip() for p in params.split(",")]
        argtypes = getattr(lib, name).argtypes
        assert len(argtypes) == len(params), name
        for p, t in zip(params, argtypes):
            if "*" in p:
                assert t is ctypes.c_void_p, (name, p)
            elif p.startswith("long long"):
                assert t is ctypes.c_longlong, (name, p)
            elif p.startswith("float"):
                assert t is ctypes.c_float, (name, p)
            else:
                assert p.startswith("int") and t is ctypes.c_int, (name, p)


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


def _fake_lib(tmp_path, monkeypatch, flags=("-O1", "-shared", "-fPIC", "-Wall")):
    """A one-function C library built by g++ through ``SharedLibrary`` into
    ``tmp_path``; ``unused`` makes g++ print a warning (a build log)."""
    monkeypatch.setattr(shared_lib, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cc"
    src.write_text('#include "k.h"\nextern "C" int f() { int unused = K; return 0; }\n')
    (tmp_path / "k.h").write_text("#define K 1\n")
    return shared_lib.SharedLibrary("fake", src, ("g++",), list(flags),
                                    lambda lib: None)


def test_library_path_follows_headers(tmp_path, monkeypatch):
    """A changed or added header beside the source gives a new library
    path, so the cache never loads a library built from the old header."""
    lib = _fake_lib(tmp_path, monkeypatch)
    p0 = lib.library_path()
    assert p0 == lib.library_path() and p0.parent == tmp_path / "build"
    (tmp_path / "k.h").write_text("#define K 2\n")
    p1 = lib.library_path()
    (tmp_path / "other.cuh").write_text("// another header\n")
    p2 = lib.library_path()
    assert len({p0, p1, p2}) == 3


def test_cached_load_reports_the_build_log(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    first = _fake_lib(tmp_path, monkeypatch)
    first.get()
    assert "unused" in first.build_log and first.build_seconds > 0
    again = _fake_lib(tmp_path, monkeypatch)  # a new process would start here
    again.get()
    assert again.path == first.path
    assert again.build_log == first.build_log and again.build_seconds == 0.0
