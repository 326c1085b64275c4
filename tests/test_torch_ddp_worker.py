"""The rank side of the port's data-parallel tests (``tests/test_torch_ddp.py``).

``run_jobs`` is what ``torch.multiprocessing.spawn`` starts in each of the
ranks: it joins a gloo world through a file (``init_method="file://..."``,
so parallel test workers cannot collide on a port), then runs each job of
the list the parent wrote: one training step of a port task at
``mesh_shape: data:N`` on the global batch, from the initial state the
parent saved, and saves what the step left (losses, parameters, BatchNorm
statistics, optimizer states) under the job's name and the rank. This
module imports no JAX: the ranks are plain port processes. It holds no
tests of its own.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def all_keep_dropout():
    """Dropout that keeps every element (the 1 / (1 - rate) scaling stays),
    as the JAX side of a parity test patches ``jax.random.bernoulli``."""
    from neuralsvb_torch.models import common
    saved = common.dropout_keep_mask
    common.dropout_keep_mask = (lambda shape, rate, generator, device:
                                torch.ones(shape, dtype=torch.bool, device=device))
    try:
        yield
    finally:
        common.dropout_keep_mask = saved


TASKS = {"svb": "svb_vae_task.SVBVAEMleTask", "hifigan": "vocoder_task.HifiGanTask",
         "vcppg": "vc_ppg.VCPPGTask", "pwg": "vocoder_task.PWGTask",
         "spk": "svb_para.ParaPPGSpkConsistentTask"}


def build_task(kind: str):
    """A port task of ``kind`` (a key of ``TASKS``) from the current
    hparams, ready to step."""
    import importlib
    mod, name = TASKS[kind].split(".")
    task = getattr(importlib.import_module(f"neuralsvb_torch.tasks.{mod}"), name)()
    task.build_model()
    task.build_train()
    return task


def modules(task, kind: str) -> dict:
    if kind == "svb":
        return {"model": task.model, "mel_disc": task.mel_disc}
    if kind in ("vcppg", "spk"):  # every discriminator of an adversarial task
        return dict({"model": task.model},
                    **{f"mel_disc{d}": m for d, m in task.discriminators.items()})
    if kind == "pwg":
        return {"model": task.model, "disc": task.disc}
    return {"model": task.model, "mpd": task.mpd, "msd": task.msd}


def optimizers(task, kind: str) -> list:
    if kind == "svb":
        return [task.opt_gen, task.opt_disc, task.opt_map]
    return [task.opt_gen, task.opt_disc]


def step_job(job: dict, states: dict) -> dict:
    """One job: build the task, load the initial state ``states[job
    ["state"]]`` (float32, cast to the job's dtype), run the optimizer
    indices of the job at its step on the batch; returns what it left."""
    from neuralsvb_torch.hparams import hparams_scope
    dtype = getattr(torch, job["dtype"])
    kind = job["kind"]
    torch.set_default_dtype(dtype)
    try:
        with hparams_scope(job["hp"]), (all_keep_dropout() if job.get("all_keep")
                                        else contextlib.nullcontext()):
            task = build_task(kind)
            for name, m in modules(task, kind).items():
                m.to(dtype)
                m.load_state_dict(states[job["state"]][name])
            if job.get("windows") is not None:
                task.disc_start_frames_wins = job["windows"]
            grads = {}
            task.grad_hook = lambda name, params: grads.__setitem__(
                name, [p.grad.detach().clone() for p in params])
            logs = {}
            for step, idx in job["steps"]:
                ret = task.training_step(job["batch"], step, idx)
                if ret is not None:
                    logs.update({k: float(torch.as_tensor(v).detach())
                                 for k, v in ret[1].items()})
            # the modules and optimizers the job keeps (a vocoder's
            # discriminators are too large to pass around in float64)
            mods = {n: m for n, m in modules(task, kind).items()
                    if n in job.get("keep", (n,))}
            opts = optimizers(task, kind)[: job.get("keep_opts", None)]
            return {"logs": logs, "grads": grads,
                    "state": {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
                              for name, m in mods.items()},
                    "opt": [o.state_dict() for o in opts]}
    finally:
        torch.set_default_dtype(torch.float32)


def run_jobs(rank: int, world: int, init_file: str, jobs_path: str, out_path: str):
    """The spawned rank: join the world, run every job, save the results."""
    import torch.distributed as dist

    from neuralsvb_torch.parallel import ddp
    torch.set_num_threads(1)  # the ranks and the test workers share the host's cores
    ddp.init_process_group("cpu", init_method=f"file://{init_file}", world=world, rank_=rank)
    try:
        jobs = torch.load(jobs_path, weights_only=False)
        states = jobs.pop("states")
        out = {name: step_job(job, states) for name, job in jobs.items()}
        torch.save(out, f"{out_path}.{rank}")
        dist.barrier()
    finally:
        ddp.destroy_process_group()


def run_infer(rank: int, world: int, init_file: str, hp: dict, runs: list):
    """The spawned rank of a sharded ``--infer`` (``tests/test_torch_shard_infer.py``):
    join the world, then run the flagship's inference loop once per entry
    of ``runs`` (hparams over ``hp``) and save each run's summary."""
    import json

    from neuralsvb_torch.hparams import hparams_scope
    from neuralsvb_torch.parallel import ddp
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    torch.set_num_threads(1)
    ddp.init_process_group("cpu", init_method=f"file://{init_file}", world=world, rank_=rank)
    try:
        for over in runs:
            with hparams_scope(dict(hp, **over)) as h:
                summary = SVBVAEMleTask.start()
                with open(f"{h['work_dir']}/summary.{rank}.json", "w") as f:
                    json.dump(summary, f)
        ddp.barrier()
    finally:
        ddp.destroy_process_group()
