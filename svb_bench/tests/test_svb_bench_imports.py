"""The import rule, by whole top-level names: nothing under ``svb_bench/``
imports JAX or the JAX package, and the reference imports no program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NO_JAX = {"jax", "jaxlib", "flax", "neuralsvb_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & NO_JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not set(top_level_imports(path)) & (NO_JAX | {"neuralsvb_torch"})


def test_rule_compares_whole_names(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import neuralsvb_torch_x\nimport jaxtyping\nfrom jax import numpy\n")
    assert set(top_level_imports(p)) == {"neuralsvb_torch_x", "jaxtyping", "jax"}
