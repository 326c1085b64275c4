#!/usr/bin/env python3
"""Which convolutions a traced ``bigvgan_train`` step spends its
convolution-gradient time in, on one card.

Runs the benchmark cell through ``svb_bench.run`` with ``--trace 1`` (its
profile of the window's first ``trace_steps`` steps, here with
``record_shapes``), then matches every ``aten::convolution_backward`` of
that profile to the kernels launched inside it (the profiler's
correlation ids attach each kernel to the operation that launched it) and
sums their device time per traced step by group:

- ``tower.s<stage>.k<K>``: the generator's ``AMPBlock1`` convolutions
  (square weight [C, C, K], K odd), stage 1 the widest;
- ``ups``, ``conv_pre``, ``conv_post``: the generator's other convolutions;
- ``mpd``, ``mrd``: the discriminators' 2-D convolutions (MPD's kernels
  are (k, 1)), each under the update (``gen``/``disc``) whose span holds it.

Each group's time is split into ``dgrad`` (kernels named ``dgrad``),
``wgrad`` (named ``wgrad``) and ``other`` (the bias's reduction and the
rest), with the kernels' names. Where the towers' backward runs the
program's own kernels (``dilated_conv_*``, launched from ``amp_conv1d``'s
backward, not from a ``convolution_backward``), ``tower_kernels`` gives
their device ms and launches per step by kernel; where the MRD's runs its
own (``mrd_conv_*`` and the reduction ``dilated_conv_reduce``, launched
under ``mrd_conv2d``'s backward node), ``mrd_kernels`` does (dgrad, wgrad
and reduce, and ``mrd_kernels_ms`` their sum), and ``tower_kernels``
leaves them out. Also prints
``unmatched_ms``: the traced steps' other kernels named like a
convolution gradient that no ``convolution_backward`` holds.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/conv_grad_attribution.py [--seed N] [--out FILE]``
(default ``build/conv_grad_attribution.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_CHANNELS = (768, 384, 192, 96, 48, 24)
# the towers' own backward kernels (ops/dilated_conv.py; the cell runs no other caller)
TOWER_KERNELS = "dilated_conv_"
# the MRD's own backward kernels (ops/mrd_conv.py) and its autograd node, under
# which they and the reduction they share with the towers are launched
MRD_KERNELS = "mrd_conv_"
MRD_BACKWARD = "_MRDConvBackward"


def group_of(shapes):
    """The group of a ``convolution_backward`` from its input shapes
    (grad_output, input, weight, ...)."""
    w = shapes[2] if len(shapes) > 2 else []
    if len(w) == 4:
        return "mpd" if w[3] == 1 else "mrd"
    if len(w) != 3:
        return "other"
    co, ci, k = w
    if ci == 100:
        return "conv_pre"
    if co == 1:
        return "conv_post"
    if co == ci and k % 2 == 1 and co in STAGE_CHANNELS:
        return f"tower.s{STAGE_CHANNELS.index(co) + 1}.k{k}"
    return "ups"


def kernels_under(e):
    out = list(e.kernels)
    for c in e.cpu_children:
        out += kernels_under(c)
    return out


def part_of(name):
    return "dgrad" if "dgrad" in name else "wgrad" if "wgrad" in name else "other"


def attribute(prof, steps):
    events = prof.events()
    updates = [(e.name.split(".")[-1], e.time_range.start, e.time_range.end)
               for e in events if e.name in ("update.gen", "update.disc")]
    groups = defaultdict(lambda: {"dgrad": 0.0, "wgrad": 0.0, "other": 0.0, "calls": 0,
                                  "kernels": defaultdict(float)})
    seen = set()
    for e in events:
        if e.name != "aten::convolution_backward" or e.device_type.name != "CPU":
            continue
        g = group_of(e.input_shapes)
        if g in ("mpd", "mrd"):
            t = e.time_range.start
            up = next((n for n, s, f in updates if s <= t <= f), "none")
            g = f"{g}.{up}"
        row = groups[g]
        row["calls"] += 1 / steps
        for k in kernels_under(e):
            key = (k.name, k.duration, id(k))
            if key in seen:
                continue
            seen.add(key)
            ms = k.duration / 1e3 / steps
            row[part_of(k.name)] += ms
            row["kernels"][k.name[:90]] += ms
    attributed = sum(r["dgrad"] + r["wgrad"] for r in groups.values())
    kernels = [(e.name, e.time_range.end - e.time_range.start) for e in events
               if e.device_type.name == "CUDA"]
    own = (TOWER_KERNELS, MRD_KERNELS)
    all_grad = sum(t for n, t in kernels
                   if ("dgrad" in n or "wgrad" in n) and not any(o in n for o in own))
    by_owner = {o: defaultdict(lambda: {"ms": 0.0, "launches": 0.0}) for o in own}

    def add(owner, name, t, sign=1):
        for o in own:
            if o in name:
                kind = name.split(o, 1)[1].split("_kernel", 1)[0]
                by_owner[owner][kind]["ms"] += sign * t / 1e3 / steps
                by_owner[owner][kind]["launches"] += sign / steps
    for n, t in kernels:
        for o in own:
            if o in n:
                add(o, n, t)
    # the MRD's share of the kernels named like the towers' (the reduction)
    moved = set()
    for e in events:
        if e.device_type.name != "CPU" or not e.name.endswith(MRD_BACKWARD):
            continue
        for k in kernels_under(e):
            if id(k) in moved or TOWER_KERNELS not in k.name:
                continue
            moved.add(id(k))
            add(TOWER_KERNELS, k.name, k.duration, -1)
            add(MRD_KERNELS, k.name, k.duration)
    out = {}
    for g, r in sorted(groups.items()):
        out[g] = {"dgrad_ms": r["dgrad"], "wgrad_ms": r["wgrad"], "other_ms": r["other"],
                  "calls": r["calls"],
                  "kernels": sorted(([n, t] for n, t in r["kernels"].items()),
                                    key=lambda x: -x[1])[:6]}
    towers = [r for g, r in out.items() if g.startswith("tower")]
    summary = {"steps": steps,
               "towers_dgrad_ms": sum(r["dgrad_ms"] for r in towers),
               "towers_wgrad_ms": sum(r["wgrad_ms"] for r in towers),
               "towers_other_ms": sum(r["other_ms"] for r in towers),
               "towers_calls": sum(r["calls"] for r in towers),
               "grad_kernels_ms": all_grad / 1e3 / steps,
               "tower_kernels": dict(by_owner[TOWER_KERNELS]),
               "mrd_kernels": dict(by_owner[MRD_KERNELS]),
               "mrd_kernels_ms": sum(r["ms"] for r in by_owner[MRD_KERNELS].values()),
               "unmatched_ms": all_grad / 1e3 / steps - attributed}
    return summary, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=4190000101)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "conv_grad_attribution.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch
    from svb_bench import run
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    made = []
    base = torch.profiler.profile

    class Recorded(base):
        def __init__(self, *a, **kw):
            kw["record_shapes"] = True
            super().__init__(*a, **kw)
            made.append(self)

    torch.profiler.profile = Recorded
    try:
        line, res = run.run_cell(run.parse(["--workload", "bigvgan_train", "--seed",
                                            str(args.seed), "--seconds", str(args.seconds),
                                            "--trace", "1"]))
    finally:
        torch.profiler.profile = base
    for note in res.notes:  # the harness's own diagnostics, as its command prints them
        print(note, file=sys.stderr)
    steps = sum(1 for name, _, _ in res.trace.spans if name == "train_one")
    summary, groups = attribute(made[0], steps)
    result = {"device": torch.cuda.get_device_name(0), "seed": args.seed,
              "correct": line["correct"], "checks": line["checks"], "summary": summary,
              "groups": groups,
              "metrics": line["metrics"], "device_ops": line["breakdown"]["device_ops"]}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"summary": summary, "correct": line["correct"]}))
    for g, r in groups.items():
        print(g, json.dumps({k: v for k, v in r.items() if k != "kernels"}))


if __name__ == "__main__":
    main()
