"""The PyTorch port imports neither jax nor flax, directly or through
neuralsvb_tpu (whose package import pulls in jax), nor the msgpack package
(it reads flax's msgpack files with its own decoder), and builds or reads
no file of neuralsvb_tpu."""

from __future__ import annotations

import ast
import importlib
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1] / "neuralsvb_torch"

CODE = """
import importlib, json, pkgutil, sys
import neuralsvb_torch
names = [m.name for m in pkgutil.walk_packages(neuralsvb_torch.__path__,
                                               "neuralsvb_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "neuralsvb_tpu", "msgpack"))
print(json.dumps({"names": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                         text=True, timeout=300, cwd=ROOT.parent)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    files = {p.relative_to(ROOT.parent).with_suffix("").as_posix().replace("/", ".")
             for p in ROOT.rglob("*.py") if p.name != "__init__.py"}
    assert files <= set(res["names"]), files - set(res["names"])
    assert res["bad"] == [], res["bad"]


def _docstrings(tree):
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


def test_port_builds_and_names_only_its_own_files():
    """Every library the port builds has its source under neuralsvb_torch/,
    and no string of a port module outside a docstring names a path under
    neuralsvb_tpu/ (a module that reads the JAX package's files as files
    slips past the import check above)."""
    import neuralsvb_torch
    from neuralsvb_torch.ops.shared_lib import SharedLibrary
    libs = {}
    for info in pkgutil.walk_packages(neuralsvb_torch.__path__, "neuralsvb_torch."):
        module = importlib.import_module(info.name)
        for name, value in vars(module).items():
            if isinstance(value, SharedLibrary):
                libs[f"{info.name}.{name}"] = value
    assert {"neuralsvb_torch.native.LIBRARY", "neuralsvb_torch.ops.chi2.LIBRARY",
            "neuralsvb_torch.ops.fused_resblock.LIBRARY",
            "neuralsvb_torch.ops.fused_resblock.LIBRARY_BF16"} <= set(libs)
    outside = {k: str(lib.source) for k, lib in libs.items()
               if not lib.source.resolve().is_relative_to(ROOT)}
    assert outside == {}, outside

    path = re.compile(r"(^|[/\\])neuralsvb_tpu($|[/\\])")
    named = []
    for py in sorted(ROOT.rglob("*.py")):
        tree = ast.parse(py.read_text())
        docs = _docstrings(tree)
        named += [f"{py.relative_to(ROOT.parent)}:{node.lineno}: {node.value!r}"
                  for node in ast.walk(tree)
                  if isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and id(node) not in docs and path.search(node.value)]
    assert named == [], named


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` (every phase, the FS2, harness, SVBPara and serving
    phases included)
    imports nothing of jax, flax, msgpack or the JAX package, at its top or
    inside a phase, and importing it with its phases' modules pulls none in."""
    smoke = ROOT.parent / "chip_smoke.py"
    tree = ast.parse(smoke.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "neuralsvb_tpu", "msgpack"}, roots
    phases = sorted(n.name for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name.startswith("phase_"))
    assert {"phase_fs2_binarize", "phase_fs2_train", "phase_fs2_step_time",
            "phase_fs2_card_vs_cpu", "phase_pitch_alignment", "phase_mcd",
            "phase_svb_para", "phase_svb_para_card_vs_cpu",
            "phase_serving_leftovers"} <= set(phases)
    code = ("import json, sys\n"
            "import chip_smoke\n"
            "import neuralsvb_torch.tasks.fs2_adv, neuralsvb_torch.tasks.mcd_eval\n"
            "import neuralsvb_torch.tasks.pitch_alignment_task\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'neuralsvb_tpu', 'msgpack'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT.parent)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
