#!/usr/bin/env python3
"""The binarize path's DTW stage on one NVIDIA card, this checkout against an
earlier one, in one run.

Run from the root of a checkout on a machine with a CUDA card::

    python3 scripts/binarize_ab.py --other DIR [--out FILE]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a git-ignored directory). The
script writes ``chip_smoke.py``'s 8 synthetic sung pairs, runs the
speaker-embedding pass once, builds each checkout's libraries, then runs
the para pass of ``python -m neuralsvb_torch.data.binarize`` on the card
six times, in turns (other, this, this, other, other, this), each from its
own checkout, and reads each pass's ``| binarize summary:`` line (seconds per stage,
chi-square launches, wall). Then, in this process, it times the χ² cost's
hand-off to the host for the largest pair's histograms: the earlier path
(``chi2_dist(source, target)``, a transpose on the card, a pageable copy)
against this checkout's (``chi2_dist(target, source)`` into pinned memory),
and the host DP that reads the cost: medians over 20 repeats, each ending
in a synchronized host array.

Prints one JSON line per result and writes them all to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def para_pass(checkout, cfg, binary_dir):
    cmd = [sys.executable, "-m", "neuralsvb_torch.data.binarize", "--config", cfg,
           "--hparams", f"device=cuda,binary_data_dir={binary_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"para pass in {checkout} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("| binarize summary: "))
    return wall, json.loads(line[len("| binarize summary: "):])


def handoff_ms(sh, th, repeats=20):
    """Median ms of the old and new hand-off of one pair's cost, and of the DP."""
    import torch
    from neuralsvb_torch.native import dtw_align_native
    from neuralsvb_torch.ops import dtw
    from neuralsvb_torch.ops.chi2 import chi2_dist
    a = torch.as_tensor(sh, dtype=torch.float32, device="cuda")
    b = torch.as_tensor(th, dtype=torch.float32, device="cuda")

    def old():
        return chi2_dist(a, b).T.contiguous().cpu().numpy()

    def new():
        return dtw._to_host(chi2_dist(b, a))

    if not (old() == new()).all():
        raise AssertionError("the two hand-offs give different costs")
    cost = new()
    times = {"old": [], "new": [], "dp": []}
    for _ in range(repeats):
        for name, fn in (("old", old), ("new", new), ("new", new), ("old", old),
                         ("dp", lambda: dtw_align_native(cost))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the earlier checkout")
    ap.add_argument("--out", default=str(REPO / "build" / "binarize_ab.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("binarize_ab.py needs a CUDA card")
    other = Path(args.other).resolve()
    root = REPO / "build" / "binarize_ab"
    shutil.rmtree(root, ignore_errors=True)
    cfgs = chip_smoke.binarize_configs(str(root), chip_smoke.write_sung_pairs(str(root)))
    rows = []

    def emit(kind, **kw):
        rows.append({"kind": kind, **kw})
        print(json.dumps(rows[-1]), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit("environment", device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    wall, emb = chip_smoke.run_binarize(cfgs["save_emb_torch"], "cuda")
    emit("save_emb", wall_s=wall, summary=emb)
    build = ("from neuralsvb_torch import native; from neuralsvb_torch.ops import chi2; "
             "chi2.LIBRARY.get(); native.LIBRARY.get()")
    for checkout in (other, REPO):  # kernel builds stay out of the timed passes
        subprocess.run([sys.executable, "-c", build], cwd=checkout, check=True, timeout=600)
    turns = ("other", "this", "this", "other", "other", "this")
    for i, name in enumerate(turns):
        checkout = other if name == "other" else REPO
        wall, summary = para_pass(checkout, cfgs["para_bin_torch"], root / f"binary_{i}")
        emit("para_pass", checkout=name, turn=i, wall_s=wall,
             dtw_align_s=summary["stage_seconds"]["dtw_align"],
             chi2_dist_launches=summary["chi2_dist_launches"], summary=summary)

    from neuralsvb_torch.ops.dtw import f0_shape_histogram
    from neuralsvb_torch.data.indexed_dataset import IndexedDataset
    items = []
    for prefix in ("train", "test"):
        ds = IndexedDataset(str(root / "binary_1" / prefix))
        items += [ds[i] for i in range(len(ds))]
    it = max(items, key=lambda x: len(x["f0"]) * len(x["prof_f0"]))
    S, T = len(it["f0"]), len(it["prof_f0"])
    sh = f0_shape_histogram(it["f0"], enhanced=True)
    th = f0_shape_histogram(it["prof_f0"], enhanced=True, scale_factor=T / S)
    emit("handoff", item=it["item_name"], S=S, T=T, cost_bytes=4 * S * T,
         median_ms=handoff_ms(sh, th))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
