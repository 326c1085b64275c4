#!/usr/bin/env python3
"""The spread of ``chip_smoke.py`` phase 22's map-gradient cosine, for sound
bf16 arithmetic and for planted faults.

Phase 22 takes phase 9's gen + disc step and then the latent map's step of
the flagship at ``compute_dtype: bfloat16`` on the card and holds the map
gradient against the CPU's float64 gradient by its cosine. Two readings:

- ``chained``: the map step follows the bf16 run's own generator step. That
  step is Adam's first, about lr x sign(g), so every gradient element near
  zero can flip the sign of its parameter's move between the two runs, and
  the map then starts from other parameters.
- ``from_f64``: the map step starts from the float64 run's parameters and
  BatchNorm statistics before its map step (``train_step_runs(map_from=)``),
  so bf16's rounding in the map step is the only difference. Phase 22
  gates its ``_tail`` at ``BF16_GRAD_COS``.

Each is also read over the map's tensors from its last BatchNorm on
(``_tail``): the map's BatchNorms normalise over the batch's four global
latents, and their backward amplifies rounding in the tensors before them.

Each run also reads ``chip_smoke.NormStatsCheck``: every training-mode
BatchNorm call's output against float64 on the same input (``_norm_err``,
the worst over modules and calls; phase 22 gates it at ``BF16_NORM_ERR``).

Each reading is taken on the card for sound code, in bf16 on the CPU (the
plain arithmetic), in float32 on the card, and on the card with a fault
planted in the BatchNorm statistics (``FAULTS``; this process only, by
replacing ``neuralsvb_torch.models.common._batch_norm``):

- ``sum_over_n``: the statistics as ``x.sum / n`` where the port takes
  ``x.mean`` (a form tried during data-parallel work; float32 either way);
- ``bf16_stats``: the statistics, normalisation and running-statistics
  update in bf16 where flax (and the port) take float32.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/bf16_map_spread.py [--seeds 1234,1,2,...] [--repeats 1]
[--out FILE]``. It binarizes ``chip_smoke.py`` phase 6's synthetic pairs
into ``build/bf16_map_spread/`` first, prints one JSON object per seed and a
summary, and writes them to ``--out`` (default
``build/bf16_map_spread.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _faulty_batch_norm(kind):
    """A training-mode ``_batch_norm`` with fault ``kind`` planted."""
    import torch
    from neuralsvb_torch.models import common

    def bn_fn(x, bn):
        if not bn.training:
            return common._SOUND_BATCH_NORM(x, bn)
        shape = [1, -1] + [1] * (x.dim() - 2)
        out_dtype = x.dtype
        if kind == "sum_over_n":
            x = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.dim()))
        if kind == "sum_over_n":
            n = x.numel() // x.shape[1]
            stats = torch.stack([x.sum(dims), (x * x).sum(dims)]) / n
        else:  # bf16_stats: x stays in its compute dtype
            stats = torch.stack([x.mean(dims), (x * x).mean(dims)])
        mean = stats[0].view(shape)
        var = (stats[1].view(shape) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean.detach().flatten().float(), alpha=m)
            bn.running_var.mul_(1 - m).add_(var.detach().flatten().float(), alpha=m)
            bn.num_batches_tracked.add_(1)
        y = (x - mean) * torch.rsqrt(var + bn.eps)
        return (y * bn.weight.view(shape).to(x.dtype)
                + bn.bias.view(shape).to(x.dtype)).to(out_dtype)
    return bn_fn


FAULTS = ("sum_over_n", "bf16_stats")


@contextlib.contextmanager
def planted(kind):
    """``neuralsvb_torch.models.common._batch_norm`` with fault ``kind``
    (None: the sound one) for the duration."""
    from neuralsvb_torch.models import common
    if not hasattr(common, "_SOUND_BATCH_NORM"):
        common._SOUND_BATCH_NORM = common._batch_norm
    common._batch_norm = (common._SOUND_BATCH_NORM if kind is None
                          else _faulty_batch_norm(kind))
    try:
        yield
    finally:
        common._batch_norm = common._SOUND_BATCH_NORM


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="1234,1,2,3,4,5")
    ap.add_argument("--repeats", type=int, default=1, help="sound card bf16 runs per seed")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bf16_map_spread.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    cs.WORK = os.path.join(REPO, "build", "bf16_map_spread")
    cs.tf32(False)
    if not os.path.isdir(os.path.join(cs.WORK, "binarize", "binary")):
        os.makedirs(cs.WORK, exist_ok=True)
        cs.phase_binarize()
    f32, f64 = torch.float32, torch.float64
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout

    def readings(ref_grads, state, tail, device, fault=None, **over):
        """{'chained', 'from_f64'}: the map gradient's cosine, and with
        '_tail' that of its tensors from its last BatchNorm on; plus the
        generator's and discriminator's cosines of the chained run."""
        out = {}
        with planted(fault):
            for name, map_from in (("chained", None), ("from_f64", state)):
                checks = []
                run, _ = cs.train_step_runs(SVBVAEMleTask, (f32,), (device,), sides=("x",),
                                            map_from=map_from,
                                            on_task=lambda t: checks.append(cs.NormStatsCheck(t)),
                                            **over)
                worst = checks[0].worst
                checks[0].close()
                out[f"{name}_norm_err"] = max(worst.values())
                out[f"{name}_norm_worst"] = max(worst, key=worst.get)
                grads = run["x", f32][1]
                out[name] = cs.grad_cosine(grads["map"], ref_grads["map"])
                out[f"{name}_tail"] = cs.grad_cosine(grads["map"][tail], ref_grads["map"][tail])
                if map_from is None:
                    out["gen"] = cs.grad_cosine(grads["gen"], ref_grads["gen"])
                    out["disc"] = cs.grad_cosine(grads["disc"], ref_grads["disc"])
        return out

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        states, names = {}, {}
        ref, _ = cs.train_step_runs(SVBVAEMleTask, (f64,), ("cpu",), sides=("cpu",),
                                    states=states, names=names, seed=seed)
        ref_grads, state = ref["cpu", f64][1], states["cpu", f64]
        tail = cs.after_last_batchnorm(names)
        bf16 = dict(compute_dtype="bfloat16", seed=seed)
        row = {"seed": seed, "nvidia_smi": smi.strip(),
               "tail": names["map"][tail],
               "card_bf16": [readings(ref_grads, state, tail, "cuda", **bf16)
                             for _ in range(args.repeats)],
               "cpu_bf16": readings(ref_grads, state, tail, "cpu", **bf16),
               "card_f32": readings(ref_grads, state, tail, "cuda", seed=seed),
               # the same form in float32: a fault would show here too
               "card_f32_sum_over_n": readings(ref_grads, state, tail, "cuda", "sum_over_n",
                                               seed=seed)}
        for fault in FAULTS:
            row[f"card_bf16_{fault}"] = readings(ref_grads, state, tail, "cuda", fault, **bf16)
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {"gates": {"norm_err": cs.BF16_NORM_ERR, "map_tail_from_f64": cs.BF16_GRAD_COS},
               "nvidia_smi": smi.strip()}
    for reading in ("chained", "chained_tail", "chained_norm_err", "from_f64", "from_f64_tail",
                    "from_f64_norm_err"):
        sound = [r[reading] for row in rows for r in row["card_bf16"]]
        summary[reading] = {
            "card_bf16": sorted(sound),
            "cpu_bf16": sorted(row["cpu_bf16"][reading] for row in rows),
            "card_f32": sorted(row["card_f32"][reading] for row in rows),
            "card_f32_sum_over_n": sorted(row["card_f32_sum_over_n"][reading] for row in rows),
            **{f"card_bf16_{f}": sorted(row[f"card_bf16_{f}"][reading] for row in rows)
               for f in FAULTS}}
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"seeds": rows, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
