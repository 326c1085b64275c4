"""One run of one benchmark cell:

    python3 -m svb_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (weights and inputs from the seed, on the card), warms up
every shape its traffic uses, measures for ``--seconds``, compares what the
timed path produced with the plain reference, and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each number compared
beside its limit, also the last lines on standard error). Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits with 2. ``--control 1`` puts the reference computed in the precision
below the configuration's in the program's place, for the control's
readings."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "neuralsvb_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``build/kernels/``)."""
    base = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def split_base(name: str) -> str:
    """The quantity a metric named ``<quantity>.<cells>`` splits by cells
    whose end-to-end metrics differ (``mfu.train.svb``: ``mfu.train``)."""
    return name.rsplit(".", 1)[0]


def read_metric(name: str, res):
    """The per-layer reader ``metrics/<name>.py``, or that of the quantity
    it splits, applied to ``res``."""
    from .harness import BENCH
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{split_base(name)}.py"
    spec = importlib.util.spec_from_file_location(f"svb_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(res)


def run_cell(args, device=None, require_cuda: bool = True, overrides=None, bench=None):
    """Runs the cell; returns (result line as a dict, Result). ``device``,
    ``overrides`` ({"hparams"|"vocoder"|"traffic": {key: value}}, merged
    into the configuration and the traffic) and ``bench`` (the cells and
    metrics, default ``BENCHMARK.json``) serve the tests, which skip the
    look for a card."""
    from . import harness
    cache_dirs(harness.ROOT)
    import torch
    bench, cell, config, traffic = harness.load_cell(args.workload, bench=bench)
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"svb_bench: the cell needs {cell['chips']} CUDA device(s), found {n}",
                  file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for part, new in (overrides or {}).items():
        if part == "traffic":
            traffic = {**traffic, **new}
        else:
            config = {**config, part: {**config[part], **new}}
    tmp = os.path.join(tempfile.gettempdir(), "svb_bench", args.workload)
    os.makedirs(tmp, exist_ok=True)
    ctx = harness.Ctx(workload=args.workload, cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      control=bool(args.control), device=device, tmp=tmp,
                      t_process=T_PROCESS)
    ctx.mark("torch, cell")
    kind = importlib.import_module(f"svb_bench.kinds.{traffic['kind']}")
    res = kind.run(ctx)
    metrics = {}
    if args.trace:
        for m in harness.metrics_of(bench, args.workload, "per_layer"):
            v = read_metric(m["name"], res)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in harness.metrics_of(bench, args.workload, "end_to_end"):
            name = m["name"]
            v = (res.setup_s if name == "setup_s" else
                 res.e2e.get(name, res.e2e.get(split_base(name))))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": False, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": dev}
    if res.trace is not None:
        dev["busy_s"] = res.trace.busy_s
        dev["window_s"] = res.trace.window_s
        line["breakdown"] = {"device_ops": res.trace.device_ops(10),
                             "idle_gaps": res.trace.idle_gaps(10)}
    res.notes = ["set-up: " + ", ".join(f"{n} {t:.2f}" for n, t in ctx.marks)] + ctx.notes
    ok = all(v <= lim for _, v, lim in res.checks)
    line["correct"] = bool(res.checks) and ok and res.failed == 0 and res.attempted > 0
    # a non-finite reading (a shape that does not match, a NaN) is printed
    # as its name: JSON has no number for it
    line["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for n, v, lim in res.checks}
    return line, res


def main(argv=None) -> int:
    args = parse(argv)
    line, res = run_cell(args)
    for note in res.notes:
        print(note, file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"svb_bench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
