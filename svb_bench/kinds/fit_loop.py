"""Training through the program's own loop: ``next(loader)``, then
``Trainer._train_one`` (every optimizer of the task on the batch, a
synchronisation on each side), step after step.

Set-up builds the task, its optimizers and its loader over a synthetic
split written under ``TMPDIR``, loads the benchmark's seeded weights, sets
the step counter past the keys of ``start_after`` and drives the loader's
first pass through the same loop: the reference follows its first
``first_steps`` steps. The window then runs the same object on. A step's
time is the window's wall time over the steps completed in it. Once the
window has closed, the same call takes one more step on the next batch
from a snapshot of the state the window left (parameters, buffers, each
leaf's optimizer state), and the reference takes that step from the same
snapshot: a fault that acts only after set-up shows there.

Compared (``checks``: the numbers the traffic gives a limit): each
optimizer's loss at the first step (``loss_rel.first``), at each of the
first steps (``loss_rel``) and at the step past the window
(``loss_rel.window``); the norm of each leaf's first gradient as the
optimizer got it (Adam's first moment after one step over 1 - beta1); the
norm of each leaf's change over the first steps (``change_norm_gap``) and
over the step past the window (``change_norm_gap.window``). Norms are
compared by the worst leaf, against the reference's norm of that leaf or
of the median leaf, whichever is larger; leaves whose reference gradient
is under a thousandth of the median leaf's are left out of a change. The
batches of the first steps, which the program's data layer cut, are
checked against the split (``data_rows_off``). With ``--control 1`` the
program's own numbers go to standard error (``program: {...}``).

Traffic keys: ``task`` (``hifigan`` or ``svb``), the split's parameters,
``start_after``, ``first_steps``, ``trace_steps`` profiled at the start of
a ``--trace 1`` window, ``limits``."""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Dict

import numpy as np
import torch

from .. import flops, synth
from ..correct import norm_gap
from ..harness import Result, span, sync, tf32
from ..weights import init_spec, load_seeded, seeded_state


def _seed(seed: int, use: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 63, 3, use]).generate_state(1)[0])


def _gen_kwargs(hp: dict) -> dict:
    return dict(upsample_rates=list(hp["upsample_rates"]),
                upsample_kernel_sizes=list(hp["upsample_kernel_sizes"]),
                upsample_initial_channel=hp["upsample_initial_channel"],
                resblock=str(hp["resblock"]),
                resblock_kernel_sizes=list(hp["resblock_kernel_sizes"]),
                resblock_dilation_sizes=[list(d) for d in hp["resblock_dilation_sizes"]],
                use_pitch_embed=hp["use_pitch_embed"],
                audio_sample_rate=hp["audio_sample_rate"],
                num_mels=hp["audio_num_mel_bins"])


def _leaves(mods: Dict[str, torch.nn.Module]) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p for k, m in mods.items() for n, p in m.named_parameters()}


def _first_grads(opts, leaves) -> Dict[str, float]:
    """Per leaf: the norm of the gradient the optimizer took at its first
    step, from Adam's first moment ((1 - beta1) g); 0 for a leaf no
    optimizer steps."""
    out = {}
    for name, p in leaves.items():
        o = next((o for o in opts if p in o.state), None)
        out[name] = (float(torch.linalg.vector_norm(o.state[p]["exp_avg"]))
                     / (1 - o.param_groups[0]["betas"][0]) if o else 0.0)
    return out


def _changes(leaves, init) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(p.detach() - init[n])) for n, p in leaves.items()}


class HifiGan:
    """The vocoder's task: generator, MPD and MSD, their crops."""
    names = ("gen", "mpd", "msd")

    @staticmethod
    def task():
        from neuralsvb_torch.tasks.vocoder_task import HifiGanTask
        return HifiGanTask()

    @staticmethod
    def split(data_dir, traffic, seed):
        return synth.write_vocoder_split(data_dir, traffic, seed)

    @staticmethod
    def modules(task):
        return {"gen": task.model, "mpd": task.mpd, "msd": task.msd}

    @staticmethod
    def kwargs(hp, task):
        return _gen_kwargs(hp)

    @staticmethod
    def reference(hp, kw, dev):
        from ..reference.vocoder_step import HifiGanStep
        return HifiGanStep(hp, kw, dev)

    @staticmethod
    def shapes(batch) -> tuple:
        return tuple(np.shape(batch["wavs"]))

    @staticmethod
    def step_least_s(hp, kw, shapes, split, memo) -> float:
        """Every crop is whole (``max_samples``): no padding to leave out."""
        if shapes not in memo:
            memo[shapes] = flops.least_s(flops.hifigan_step_flops(kw, *shapes))
        return memo[shapes]

    @staticmethod
    def cluster_least_s(hp, kw, shapes) -> float:
        B, n = shapes
        shapes = flops.stage_shapes(n // hp["hop_size"], kw["upsample_rates"],
                                    kw["upsample_initial_channel"])
        args = (B, shapes, kw["resblock_kernel_sizes"], kw["resblock_dilation_sizes"])
        return max(flops.cluster_flops(*args) / flops.PEAK_BF16,
                   flops.cluster_bytes(*args) / flops.PEAK_HBM)

    @staticmethod
    def rows_off(batches, split, hp) -> int:
        return _crops_off(batches, split, hp["hop_size"])


class SVB:
    """The flagship's task in phase 2: the SVB model and its multi-window
    discriminator, on whole takes batched by ``max_tokens``."""
    names = ("model", "mel_disc")

    @staticmethod
    def task():
        from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
        return SVBVAEMleTask()

    @staticmethod
    def split(data_dir, traffic, seed):
        return synth.write_svb_split(data_dir, traffic, seed)

    @staticmethod
    def modules(task):
        return {"model": task.model, "mel_disc": task.mel_disc}

    @staticmethod
    def kwargs(hp, task):
        from .a2p_closed_loop import _svb_kwargs
        return _svb_kwargs(hp)

    @staticmethod
    def reference(hp, kw, dev):
        from ..reference.svb_step import SVBStep
        return SVBStep(hp, kw, dev)

    @staticmethod
    def shapes(batch) -> tuple:
        """The split's items in the batch, by index."""
        return tuple(batch["id"].tolist())

    @staticmethod
    def step_least_s(hp, kw, shapes, split, memo) -> float:
        """Summed over the rows at each item's own frames, not at the
        collated length: the padding shows as lost share."""
        total = 0.0
        for i in shapes:
            key = (len(split[i]["mel"]), len(split[i]["prof_mel"]))
            if key not in memo:
                n = hp["audio_num_mel_bins"]
                memo[key] = flops.least_s(flops.svb_step_flops(hp, kw, (1, key[0], n),
                                                               (1, key[1], n)))
            total += memo[key]
        return total

    cluster_least_s = None

    @staticmethod
    def rows_off(batches, split, hp) -> int:
        return _takes_off(batches, split)


TASKS = {"hifigan": HifiGan, "svb": SVB}


def run(ctx) -> Result:
    from neuralsvb_torch.hparams import hparams
    from neuralsvb_torch.training.trainer import Trainer

    traffic, dev = ctx.traffic, ctx.device
    kind = TASKS[traffic["task"]]
    data_dir = os.path.join(ctx.tmp, "data")
    hparams.clear()
    hparams.update(ctx.config["hparams"])
    hparams.update(device=dev.type, seed=ctx.seed % 2 ** 31, work_dir="",
                   binary_data_dir=data_dir, pretrain_asr_ckpt="")
    ctx.mark("import")
    split = kind.split(data_dir, traffic, _seed(ctx.seed, 0))
    ctx.mark("data")

    task = kind.task()
    trainer = Trainer(work_dir="")
    task.trainer = trainer
    task.build_model()
    task.build_train()
    ctx.mark("build")
    kw = kind.kwargs(hparams, task)
    with torch.device("meta"):
        ref_mods = kind.reference(dict(hparams), kw, "meta").modules()
    mods = kind.modules(task)
    w_seeds = {k: _seed(ctx.seed, 1 + i) for i, k in enumerate(kind.names)}
    for k, m in mods.items():
        load_seeded(m, seeded_state(init_spec(ref_mods[k]), w_seeds[k], dev))
    del ref_mods
    leaves = _leaves(mods)
    init = {n: p.detach().clone() for n, p in leaves.items()}
    start = max(int(hparams[k]) for k in traffic["start_after"]) + 1
    trainer._set_step(task, start)
    loader_obj = task.train_dataloader()
    loader = iter(loader_obj)
    hp = dict(hparams)
    opts = [o for o in vars(task).values() if isinstance(o, torch.optim.Optimizer)]
    ctx.mark("weights, loader")

    # the first steps: what the reference follows; then the rest of the
    # loader's first pass, so that every batch shape the window meets has
    # run once (cuDNN's plans, the allocator's blocks)
    first, batches, losses = int(traffic["first_steps"]), [], []
    grads = changes = None
    for j in range(max(first, len(loader_obj))):
        batch = next(loader)
        if j < first:
            batches.append(batch)
        logs = trainer._train_one(task, batch)
        if j < first:
            losses.append({k: float(v) for k, v in logs.items() if k.startswith("total_loss")})
        if j == 0:
            grads = _first_grads(opts, leaves)
        if j == first - 1:
            changes = _changes(leaves, init)
            del init
    sync(dev)
    ctx.mark("first pass")
    setup_s = time.perf_counter() - ctx.t_process

    # the window
    n_trace = int(traffic["trace_steps"]) if ctx.trace else 0
    record: Dict[str, list] = {"data_wait_s": [], "gen_step_ms": [], "disc_step_ms": []}
    timed = {"gen_step": [], "disc_step": []}
    prof = None
    if ctx.trace:
        for name in timed:
            _wrap(task, name, timed[name], dev)
    steps, i, shapes, traced = 0, 0, [], []
    t0 = time.perf_counter()
    while True:
        if i == n_trace and prof is not None:
            sync(dev)
            win.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            prof_done = prof
            prof = None
            for v in timed.values():
                v.clear()
            t0 = time.perf_counter()
        if i >= n_trace and time.perf_counter() - t0 >= ctx.seconds:
            break
        if i == 0 and n_trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            win = span("window")
            win.__enter__()
        tw = time.perf_counter()
        with span("next_batch"):
            batch = next(loader)
        if i >= n_trace:
            record["data_wait_s"].append(time.perf_counter() - tw)
        with span("train_one"):
            trainer._train_one(task, batch)
        if i >= n_trace:
            steps += 1
            shapes.append(kind.shapes(batch))
        elif i < n_trace:
            traced.append(kind.shapes(batch))
        i += 1
    t1 = time.perf_counter()
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    step_s = (t1 - t0) / max(steps, 1)
    res = Result(setup_s=setup_s, attempted=steps, failed=0, memory_peak_bytes=mem_peak)
    res.e2e = {"train_step_ms": step_s * 1e3}
    if ctx.trace:
        from ..trace import Trace
        res.trace = Trace.from_profile(prof_done)
        sync(dev)
        for name in timed:
            record[f"{name}_ms"] = [a.elapsed_time(b) for a, b in timed[name]]
        if kind.cluster_least_s is not None:
            record["cluster_least_s"] = sum(kind.cluster_least_s(hp, kw, b) for b in traced)
        memo = {}
        record["step_least_s"] = sum(kind.step_least_s(hp, kw, b, split, memo)
                                     for b in shapes) / steps
        record["step_s"] = step_s
    res.record = record

    # one step past the window through the window's call, on the next
    # batch, from a snapshot of the state the window left: the reference
    # takes the same step from the same state
    batch = next(loader)
    late = {"step": trainer.global_step, "batch": batch,
            "state": _snapshot(mods, opts, leaves)}
    logs = trainer._train_one(task, batch)
    late["losses"] = _losses(logs)
    late["changes"] = _changes(leaves, late["state"]["params"])

    # the comparison, once the window has closed and the program is freed
    del task, trainer, loader, loader_obj, mods, leaves, opts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(ctx, kind, hp, kw, w_seeds, batches, split, start, late)
    got = {"losses": losses, "grads": grads, "changes": changes,
           "late_losses": late["losses"], "late_changes": late["changes"]}
    if ctx.control:
        ctx.notes.append("program: " + json.dumps(_numbers(got, ref)))
        got = _reference(ctx, kind, hp, kw, w_seeds, batches, split, start, late, low=True)
    numbers = _numbers(got, ref, ctx.notes)
    numbers["data_rows_off"] = float(kind.rows_off(batches, split, hp))
    limits = traffic["limits"]
    res.checks = [(n, v, limits[n]) for n, v in numbers.items() if n in limits]
    return res


def _losses(logs) -> Dict[str, float]:
    return {k: float(v) for k, v in logs.items() if k.startswith("total_loss")}


def _loss_gap(a: Dict[str, float], r: Dict[str, float]) -> float:
    """The worst optimizer's |loss - reference| / |reference|."""
    if set(a) != set(r):
        return float("inf")
    return max(abs(a[k] - r[k]) / max(abs(r[k]), 1e-12) for k in r)


def _change_gap(got, want, grads) -> tuple:
    """(worst leaf's change gap, median change) over the leaves that the
    reference's gradient ``grads`` moves: at least a thousandth of the
    median leaf's."""
    med_g = statistics.median(grads.values())
    moved = [n for n in grads if grads[n] >= 1e-3 * med_g]
    med_c = statistics.median(want[n] for n in moved)
    return max(norm_gap(got[n], want[n], med_c) for n in moved), med_c


def _numbers(got, ref, notes=None) -> Dict[str, float]:
    """The compared numbers of ``got`` against the reference ``ref``;
    ``notes`` takes the losses and the worst leaves."""
    gaps = [_loss_gap(a, r) for a, r in zip(got["losses"], ref["losses"])]
    med_g = statistics.median(ref["grads"].values())
    grad_gap = max(norm_gap(got["grads"][n], ref["grads"][n], med_g) for n in ref["grads"])
    change_gap, med_c = _change_gap(got["changes"], ref["changes"], ref["grads"])
    late_gap, med_l = _change_gap(got["late_changes"], ref["late_changes"], ref["late_grads"])
    if notes is not None:
        steps = list(zip(got["losses"], ref["losses"])) + [(got["late_losses"],
                                                            ref["late_losses"])]
        for j, (a, r) in enumerate(steps):
            name = f"step {j + 1}" if j < len(got["losses"]) else "the step past the window"
            notes.append(f"{name} losses: " + ", ".join(
                f"{k} {a.get(k)!r} ref {r[k]!r}" for k in r))
        for what, g, want, scale in (
                ("first grad", got["grads"], ref["grads"], med_g),
                ("change", got["changes"], ref["changes"], med_c),
                ("change past the window", got["late_changes"], ref["late_changes"], med_l)):
            worst = sorted(want, key=lambda n: -norm_gap(g[n], want[n], scale))[:5]
            notes.append(f"{what} (median {scale:.4g}): " + ", ".join(
                f"{n} {g[n]:.5g}/{want[n]:.5g}" for n in worst))
    return {"loss_rel.first": gaps[0], "loss_rel": max(gaps),
            "first_grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
            "loss_rel.window": _loss_gap(got["late_losses"], ref["late_losses"]),
            "change_norm_gap.window": late_gap}


def _snapshot(mods, opts, leaves) -> dict:
    """Copies of the modules' parameters and buffers and of the optimizers'
    per-leaf state, by leaf name."""
    name_of = {id(p): n for n, p in leaves.items()}
    with torch.no_grad():
        return {"params": {n: p.detach().clone() for n, p in leaves.items()},
                "buffers": {f"{k}.{n}": b.detach().clone() for k, m in mods.items()
                            for n, b in m.named_buffers()},
                "opt": {name_of[id(p)]: {k: v.detach().clone() if torch.is_tensor(v) else v
                                         for k, v in st.items()}
                        for o in opts for p, st in o.state.items()}}


def _wrap(task, name, out, dev):
    """Times every call of the task's ``name`` step with CUDA events."""
    fn = getattr(task, name)

    def timed(*a, **k):
        e0, e1 = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        e0.record()
        with span(name):
            r = fn(*a, **k)
        e1.record()
        out.append((e0, e1))
        return r
    if dev.type == "cuda":
        setattr(task, name, timed)


def _reference(ctx, kind, hp, kw, w_seeds, batches, split, start, late, low: bool = False):
    """The reference's losses, first gradients and changes over the same
    first steps, then its step past the window from the program's snapshot
    ``late`` (losses, change and each leaf's gradient); ``low``: in the
    precision below the configuration's (TF32, float8 cluster operands),
    the control."""
    dev = ctx.device
    with torch.device(dev):
        ref = kind.reference(hp, kw, dev)
    if hasattr(ref, "gen"):
        # the configuration's cluster operands: bf16 on the card (the port
        # picks float32 on the CPU, where the CPU tests run)
        ref.gen.operand = (torch.float8_e4m3fn if low else
                           torch.bfloat16 if dev.type == "cuda" else None)
    mods = ref.modules()
    for k, m in mods.items():
        load_seeded(m, seeded_state(init_spec(m), w_seeds[k], dev))
    leaves = _leaves(mods)
    init = {n: p.detach().clone() for n, p in leaves.items()}
    opts = [ref.opt_gen, ref.opt_disc]
    losses, grads = [], None
    with tf32(low):
        if hasattr(ref, "ppg"):
            ref.ppg(split)
        for j, batch in enumerate(batches):
            losses.append(ref.step(batch, start + j))
            if j == 0:
                grads = _first_grads(opts, leaves)
        changes = _changes(leaves, init)
        _restore(mods, opts, leaves, late["state"])
        ref.restart_draws(late["step"] - start, late["batch"])
        late_losses = ref.step(late["batch"], late["step"])
    late_grads = {n: float(torch.linalg.vector_norm(p.grad)) if p.grad is not None else 0.0
                  for n, p in leaves.items()}
    return {"losses": losses, "grads": grads, "changes": changes, "late_losses": late_losses,
            "late_grads": late_grads,
            "late_changes": _changes(leaves, late["state"]["params"])}


def _restore(mods, opts, leaves, state) -> None:
    """The program's snapshot into the reference: parameters, buffers and
    each leaf's optimizer state (its step count as the reference's
    optimizer keeps it)."""
    with torch.no_grad():
        for n, p in leaves.items():
            p.copy_(state["params"][n])
        for k, m in mods.items():
            for n, b in m.named_buffers():
                b.copy_(state["buffers"][f"{k}.{n}"])
    name_of = {id(p): n for n, p in leaves.items()}
    for o in opts:
        o.state.clear()
        for group in o.param_groups:
            for p in group["params"]:
                st = state["opt"].get(name_of[id(p)])
                if st is not None:
                    o.state[p] = {k: torch.tensor(float(v)) if k == "step" else
                                  v.clone() if torch.is_tensor(v) else v
                                  for k, v in st.items()}


def _takes_off(batches, split) -> int:
    """Rows of ``batches`` that are not their item of the split, zero-padded
    (mels, pitch, alignment of both sides)."""
    off = 0
    for b in batches:
        for r, idx in enumerate(b["id"]):
            it = split[int(idx)]
            ok = True
            for key, bkey in (("mel", "mels"), ("prof_mel", "prof_mels"), ("pitch", "pitch"),
                              ("prof_pitch", "prof_pitch"),
                              ("a2p_f0_alignment", "a2p_f0_alignment")):
                got, want = np.asarray(b[bkey][r]), np.asarray(it[key])
                n = len(want)
                ok &= bool(np.array_equal(got[:n], want) and not np.any(got[n:]))
            off += not ok
    return off


def _crops_off(batches, split, hop: int) -> int:
    """Rows of ``batches`` that are not a crop of one item of the split at
    one offset (mel, F0 and wav alike)."""
    index = {}
    for i, it in enumerate(split):
        for t in range(len(it["mel"])):
            index.setdefault(it["mel"][t].tobytes(), (i, t))
    off = 0
    for b in batches:
        for r in range(len(b["mels"])):
            hit = index.get(np.asarray(b["mels"][r][0], np.float32).tobytes())
            if hit is None:
                off += 1
                continue
            it, t = split[hit[0]], hit[1]
            n = len(b["mels"][r])
            ok = (np.array_equal(it["mel"][t:t + n], b["mels"][r])
                  and np.array_equal(it["f0"][t:t + n], b["f0"][r])
                  and np.array_equal(it["wav"][t * hop:(t + n) * hop], b["wavs"][r]))
            off += not ok
    return off
