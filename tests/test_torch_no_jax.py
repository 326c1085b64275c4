"""The PyTorch port imports neither jax nor flax, directly or through
neuralsvb_tpu (whose package import pulls in jax)."""

from __future__ import annotations

import json
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "neuralsvb_tpu"))
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
