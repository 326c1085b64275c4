"""What a run hands between the harness and a traffic kind."""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from .trace import SPAN_PREFIX

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


@dataclass
class Ctx:
    """A run's cell, its files and its arguments."""
    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: torch.device
    tmp: str
    t_process: float
    marks: List[Tuple[str, float]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    def mark(self, name: str) -> None:
        """Ends the set-up phase ``name`` (seconds since the process began)."""
        import time
        self.marks.append((name, time.perf_counter() - self.t_process))


@dataclass
class Result:
    """What a kind measured. ``e2e``: end-to-end metrics by name;
    ``record``: what the per-layer readers read; ``checks``: (name, value,
    limit) of each number compared, correct when value <= limit."""
    setup_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    e2e: Dict[str, float] = field(default_factory=dict)
    record: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Any] = None
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)  # printed to standard error


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A host span of the benchmark around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def load_cell(workload: str, root: Path = ROOT,
              bench: Optional[dict] = None) -> Tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of ``workload``, read from
    ``bench`` (default: ``BENCHMARK.json``) and the files it names."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def with_held(bench: dict) -> dict:
    """``bench`` with the cells and metrics of ``held_cells.json``."""
    held = json.loads((BENCH / "held_cells.json").read_text())
    return {**bench, **{k: bench[k] + held[k] for k in ("workloads", "end_to_end", "per_layer")}}


def metrics_of(bench: dict, workload: str, key: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload`` reports."""
    e2e_here = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]}
    out = []
    for m in bench[key]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif key == "end_to_end" or m.get("moves") in e2e_here:
            out.append(m)
    return out


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in matmuls and convolutions on (the control's precision) or off
    for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
