"""The training loop; port of the per-step path of
``neuralsvb_tpu/training/trainer.py`` (reference: utils/trainer.py:23-520).

``fit``: build the task, restore the newest checkpoint of ``work_dir`` (or
the one ``resume_from_checkpoint`` names; else warm-start from
``load_ckpt``), sanity-validate at step 0, then step every optimizer of the
task per batch until ``max_updates``, validating and saving every
``val_check_interval`` steps, logging every ``tb_log_interval`` steps, and
saving at the end and on KeyboardInterrupt. ``--validate`` runs one full
validation pass on the restored checkpoint. At the end it prints
``| train summary: {json}``: steps, device-synchronized seconds per step by
phase, validation time, peak device memory and the kernels' launches.
Under a ``torch.profiler`` session a step records the span ``train.step``
and one ``train.sync`` around each of its two synchronisations
(``utils/profiling.py`` ``span``).

Every batch counts as a step, under gradient accumulation too (the JAX
trainer's rule, ``neuralsvb_tpu/training/trainer.py:61``). Under data
parallelism every rank runs this loop on the same global batches, loads
the same checkpoint and validates unsharded (the JAX package replicates its
eval batches), and rank 0 alone writes checkpoints, ``config.yaml``, the
log and the validation audio; the others wait for it at a barrier after
each save. A rank that fails ends its process with an error, and torchrun
ends the world.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import time
from typing import Optional

import torch
import yaml

from ..hparams import hparams
from ..ops.counters import COUNTERS
from ..parallel import ddp
from ..utils.profiling import span
from .checkpoint import get_last_checkpoint, load_checkpoint, save_checkpoint
from .logger import JsonLogger

# per-process keys of the CLI, not part of a run's configuration
RUN_KEYS = ("infer", "debug", "validate", "exp_name")


def state_digest(state_dict: dict) -> str:
    """SHA-1 of the bytes of every tensor of a nested state dict, in key
    order."""
    h = hashlib.sha1()
    for k in sorted(state_dict):
        v = state_dict[k]
        if isinstance(v, dict):
            h.update(state_digest(v).encode())
        elif torch.is_tensor(v):
            h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class Trainer:
    def __init__(self, work_dir: str, val_check_interval: int = 2000,
                 tb_log_interval: int = 100, max_updates: int = 1000000,
                 num_ckpt_keep: int = 3, save_best: bool = True,
                 num_sanity_val_steps: int = 5, monitor_mode: str = "min",
                 max_epochs: int = 1000, monitor_key: str = "val_loss"):
        self.work_dir = work_dir
        self.val_check_interval = val_check_interval
        self.tb_log_interval = tb_log_interval
        self.max_updates = max_updates
        self.num_ckpt_keep = num_ckpt_keep
        self.save_best = save_best
        self.num_sanity_val_steps = num_sanity_val_steps
        self.monitor_mode = monitor_mode
        self.monitor_key = monitor_key
        self.max_epochs = max_epochs
        self.global_step = 0
        self.current_epoch = 0
        self.best_val = None
        self.logger = None
        self.is_main = ddp.is_main()
        self._times, self._val_seconds, self._validations = {}, 0.0, 0

    @classmethod
    def from_hparams(cls, hp: dict) -> "Trainer":
        return cls(work_dir=hp["work_dir"], val_check_interval=hp["val_check_interval"],
                   tb_log_interval=hp["tb_log_interval"], max_updates=hp["max_updates"],
                   num_ckpt_keep=hp["num_ckpt_keep"], save_best=hp["save_best"],
                   num_sanity_val_steps=hp["num_sanity_val_steps"],
                   monitor_mode=hp["valid_monitor_mode"],
                   max_epochs=hp.get("max_epochs") or 1000,
                   monitor_key=hp.get("valid_monitor_key") or "val_loss")

    # ------------------------------------------------------------------
    def _sync(self, task):
        if task.device.type == "cuda":
            torch.cuda.synchronize(task.device)

    def _set_step(self, task, step: int):
        self.global_step = task.global_step = step

    def fit(self, task):
        task.trainer = self
        task.build_model()
        task.build_train()
        resume = hparams.get("resume_from_checkpoint") or None
        ckpt = get_last_checkpoint(self.work_dir, resume) if self.work_dir else None
        if ckpt is not None:
            state = load_checkpoint(ckpt)
            task.load_checkpoint_state(state)
            self._set_step(task, int(state["global_step"]))
            self.current_epoch = task.current_epoch = int(state.get("epoch", 0))
            self.best_val = state.get("checkpoint_callback_best")
            print(f"| Restored ckpt: {ckpt}")
        elif hparams.get("load_ckpt"):
            task.warm_start(hparams["load_ckpt"])
        if self.work_dir and self.is_main:
            self.logger = task.logger = JsonLogger(self.work_dir)
            self._write_config()
        for c in COUNTERS:
            c.launches = 0
        if task.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(task.device)
        self._times = {}
        self._val_seconds, self._validations = 0.0, 0
        start_step = self.global_step

        if hparams.get("validate"):
            self.run_evaluation(task, save=False)
            return self._summary(task, start_step)

        train_loader = iter(task.train_dataloader())
        if self.num_sanity_val_steps > 0 and self.global_step == 0:
            self.run_evaluation(task, max_batches=self.num_sanity_val_steps, save=False)
        try:
            while self.global_step < self.max_updates:
                try:
                    batch = next(train_loader)
                except StopIteration:
                    self.current_epoch = task.current_epoch = self.current_epoch + 1
                    if self.current_epoch >= self.max_epochs:
                        break
                    train_loader = iter(task.train_dataloader())
                    continue
                if not batch:
                    continue
                self._maybe_log(self._train_one(task, batch))
                if self.global_step % self.val_check_interval == 0:
                    self.run_evaluation(task)
        except KeyboardInterrupt:
            print("| KeyboardInterrupt: saving and exiting.")
        self._save(task)
        return self._summary(task, start_step)

    def _write_config(self):
        """``config.yaml`` of the run in ``work_dir`` unless one is there
        (``--exp_name`` writes it): a vocoder directory is read through it
        (``vocoders/hifigan.py``)."""
        path = os.path.join(self.work_dir, "config.yaml")
        if not os.path.exists(path):
            with open(path, "w") as f:
                yaml.safe_dump({k: v for k, v in hparams.items() if k not in RUN_KEYS}, f)

    @span("train.step")
    def _train_one(self, task, batch) -> dict:
        step = self.global_step
        phase = task.train_phase(step)
        with span("train.sync"):
            self._sync(task)
        t0 = time.perf_counter()
        logs = {}
        for opt_idx in range(task.num_optimizers):
            ret = task.training_step(batch, step, opt_idx)
            if ret is None:
                continue
            total, log_outputs = ret
            logs.update(log_outputs)
            logs[f"total_loss_{opt_idx}"] = total
        logs = {k: v.detach() if torch.is_tensor(v) else v for k, v in logs.items()}
        with span("train.sync"):
            self._sync(task)
        self._times.setdefault(phase, []).append(time.perf_counter() - t0)
        self._set_step(task, step + 1)
        return logs

    def _maybe_log(self, logs: dict):
        """Log when the step crosses a ``tb_log_interval`` boundary."""
        step, last = self.global_step, getattr(self, "_last_log_step", 0)
        if not logs or step // self.tb_log_interval <= last // self.tb_log_interval:
            return
        self._last_log_step = step
        scalars = {k: float(v) for k, v in logs.items()}
        if not self.is_main:
            return
        print(f"| step {step}: {json.dumps({k: round(v, 5) for k, v in scalars.items()})}")
        if self.logger is not None:
            self.logger.log_metrics({f"tr/{k}": v for k, v in scalars.items()}, step)

    # ------------------------------------------------------------------
    def run_evaluation(self, task, max_batches: Optional[int] = None, save: bool = True):
        t0 = time.perf_counter()
        outputs = []
        for i, batch in enumerate(task.val_dataloader()):
            if max_batches is not None and i >= max_batches:
                break
            if batch:
                outputs.append(task.validation_step(batch, i))
        self._sync(task)
        self._val_seconds += time.perf_counter() - t0
        self._validations += 1
        if not outputs:
            return
        result = task.validation_end(outputs)
        if self.logger is not None:
            self.logger.log_metrics(result["tb_log"], self.global_step)
        if save and self.work_dir:
            # the JAX trainer's lookup: 'val/x' reads the result's 'val_x',
            # and a key the result lacks falls back to val_loss
            val = result.get(self.monitor_key.replace("val/", "val_"), result["val_loss"])
            is_best = False
            if self.save_best and (self.best_val is None
                                   or (self.monitor_mode == "min" and val < self.best_val)
                                   or (self.monitor_mode == "max" and val > self.best_val)):
                self.best_val, is_best = val, True
            self._save(task, is_best)

    def _save(self, task, is_best: bool = False):
        if not self.work_dir:
            return
        if self.is_main:
            payload = dict(task.checkpoint_state(), global_step=self.global_step,
                           epoch=self.current_epoch, checkpoint_callback_best=self.best_val)
            path = save_checkpoint(payload, self.work_dir, self.global_step,
                                   self.num_ckpt_keep, is_best)
            print(f"| Saved ckpt: {path}")
        ddp.barrier()

    def _summary(self, task, start_step: int) -> dict:
        phases = {}
        for phase, times in sorted(self._times.items()):
            warm = times[1:] or times
            phases[str(phase)] = {"steps": len(times), "first_step_s": times[0],
                                  "median_warm_step_s": statistics.median(warm),
                                  "mean_warm_step_s": sum(warm) / len(warm)}
        summary = {"device": str(task.device), "rank": ddp.rank(),
                   "world": ddp.world_size(), "start_step": start_step,
                   "end_step": self.global_step, "phases": phases,
                   "validations": self._validations, "validation_s": self._val_seconds,
                   "vocoder_calls": getattr(task, "vocoder_calls", 0),
                   **{f"{c.__name__}_launches": c.launches for c in COUNTERS}}
        if task.device.type == "cuda":
            summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(task.device)
        if ddp.world_size() > 1:
            # the ranks step identically: their states hash alike
            summary["state_digest"] = state_digest(task.checkpoint_state()["state_dict"])
        print(f"| train summary: {json.dumps(summary)}")
        return summary
