"""Shared libraries built from the repository's CUDA and C++ sources at
first use and loaded with ``ctypes``.

Each library is compiled from one source file into ``BUILD_DIR`` under a
name keyed by the hash of the source, the headers beside it (``*.cuh``,
``*.h``) and the flags: a change to any of them rebuilds, an unchanged
library is loaded as it is. The compiler's output is kept beside the
library, so a cached load still reports it (nvcc's registers and spills).
A missing compiler or a failed compile raises; nothing falls back to
another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

PACKAGE = Path(__file__).resolve().parents[1]

# nvcc for Hopper, IEEE float arithmetic (no --use_fast_math); -Xptxas -v
# puts each kernel's registers, shared memory and spills in the build log
NVCC = ("nvcc", "/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the host toolchain, with the flags the JAX package builds the same source with
GXX = ("g++",)
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def build_dir(package: Path = PACKAGE) -> Path:
    """``build/kernels/`` of the checkout that holds ``package``; for an
    installed package, which has no checkout around it, a cache under the
    user's ``$HOME``."""
    root = package.parent
    if (root / "pyproject.toml").is_file() and (root / "neuralsvb_torch").is_dir():
        return root / "build" / "kernels"
    return Path.home() / ".cache" / "neuralsvb_torch" / "kernels"


BUILD_DIR = build_dir()


class SharedLibrary:
    """One source -> one shared library, built and loaded once per process.

    ``bind`` declares the ``argtypes``/``restype`` of the library's entry
    points on the loaded ``ctypes.CDLL``."""

    def __init__(self, name: str, source: Path, compiler: Sequence[str],
                 flags: Sequence[str], bind: Callable[[ctypes.CDLL], None]):
        self.name, self.source = name, Path(source)
        self.compiler, self.flags, self.bind = tuple(compiler), list(flags), bind
        self._lock = threading.Lock()
        self._lib = None
        self.path: Optional[Path] = None
        self.build_log = ""
        self.build_seconds = 0.0

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def library_path(self) -> Path:
        """Where the library of the current source, headers and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(p for pat in ("*.cuh", "*.h")
                             for p in self.source.parent.glob(pat)):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:12]}.so"

    def _build_and_load(self) -> ctypes.CDLL:
        exe = next((p for p in map(shutil.which, self.compiler) if p), None)
        if exe is None:
            raise RuntimeError(
                f"{self.compiler[0]} not found: {self.name} is built from "
                f"{self.source} with it (nvcc: the CUDA toolkit of a machine "
                "with an H100)")
        self.path = self.library_path()
        log = self.path.with_suffix(".log")
        if self.path.exists():
            self.build_log = log.read_text() if log.exists() else ""
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([exe, *self.flags, "-o", str(tmp), str(self.source)],
                                  capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"{self.compiler[0]} failed on {self.source} "
                                   f"({proc.returncode}):\n{self.build_log}")
            log.write_text(self.build_log)
            os.replace(tmp, self.path)
        lib = ctypes.CDLL(str(self.path))
        self.bind(lib)
        return lib
