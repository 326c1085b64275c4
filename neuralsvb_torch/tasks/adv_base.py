"""Two-optimizer (generator / mel discriminator) adversarial mel tasks; port
of ``neuralsvb_tpu/tasks/adv_base.py`` (reference: tasks/tts/fs2_adv.py:11-128
and the training loop's multi-optimizer dispatch, utils/trainer.py:269-342).

A subclass builds its generator (``build_generator``), moves a collated
batch to the device (``prep_batch``) and computes its losses with the fakes
and real mels the discriminator sees (``forward_losses``); this class owns
the discriminators, the two optimizer chains, their schedules and the
steps. ``discriminators`` maps a name to a multi-window discriminator:
``''`` is the mel discriminator (``mel_disc``), and ``build_extra_discs``
adds others (the speaker-consistency task's ``'_spk'``), as the JAX base's
dict (``neuralsvb_tpu/tasks/adv_base.py:78-110``). Every fake meets every
discriminator:

- generator (optimizer 0): the subclass's losses plus, once the step
  exceeds ``disc_start_steps``, ``lambda_mel_adv * mse(D(fake), 1)`` per
  fake, the discriminator in eval mode (``{name}a``); a chain of an
  optional value clip, a clip by global norm (``generator_grad_norm`` or
  ``clip_grad_norm``) and AdamW at ``rsqrt_schedule(lr, warmup_updates,
  hidden_size)``; the loss of fake ``name`` against discriminator
  ``dname`` is ``{name}{dname}a``;
- discriminator (optimizer 1, every ``disc_interval`` steps once on): LSGAN
  on the generator step's detached fakes (``{name}{dname}r``,
  ``{name}{dname}f``), eps from ``discriminator_optimizer_params``, the step
  schedule at ``max(step - disc_start_steps, 1)``. One chain spans every
  discriminator's parameters, as the JAX package's one ``tx_disc`` over its
  ``disc_params`` dict: the clip by global norm and AdamW see their union.

Discriminator ``j`` initialises from ``seed + 1 + j``: the JAX package
seeds each from ``hash(name) % 100``, which Python salts per process, so
its initialisation cannot be reproduced; the tests carry its weights
across with ``convert.jax2torch.discs_from_jax``.

As the flagship's task, random draws of a step (the discriminator's
windows and dropout, the generator's dropout) come from a ``torch.Generator``
seeded by (seed, step), so a resumed run draws what the uninterrupted run
draws; checkpoints hold the model, every discriminator (``mel_disc``,
``mel_disc_spk``, ...), both optimizers and the host random stream.

The JAX package's training options: ``accumulate_grad_batches`` (one
``MultiSteps`` per optimizer, each counting its own micro-steps),
``use_cond_disc`` (the discriminator's conditional branch, which no step
feeds: see ``models/disc.py``), ``binary_data_dirs`` (the subclasses' train
dataloaders concatenate the directories) and data parallelism over
``mesh_shape`` (``parallel/ddp.py``: every rank takes its rows of the
global batch). The JAX ``AdversarialTaskBase`` has no ``compute_dtype``
cast, and neither has this one.

Under a ``torch.profiler`` session ``gen_step`` and ``disc_step`` record
the spans ``update.gen`` and ``update.disc`` (``utils/profiling.py``
``span``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.checkpoint import is_torch_file, load_into, load_state_dict, newest_checkpoint
from ..hparams import hparams, resolve_device
from ..models.disc import Discriminator
from ..parallel import ddp
from ..training.schedulers import rsqrt_schedule, step_lr_schedule
from ..utils.profiling import span
from .base_task import (BaseTask, copy_parameters, no_grad_for, np_rng_state,
                        set_np_rng_state, step_generator)
from .losses import mse, parse_mel_losses


def cross_entropy_ignore0(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token CE over the targets that are not 0 (padding); logits
    [..., V], targets [...] int (reference: svb_para.py add_asr_losses)."""
    nll = -torch.gather(F.log_softmax(logits, -1), -1, targets[..., None])[..., 0]
    mask = (targets != 0).to(nll.dtype)
    return ddp.all_sum((nll * mask).sum()) / ddp.all_sum(mask.sum()).clamp_min(1.0)


class AdversarialTaskBase(BaseTask):
    num_optimizers = 2

    def __init__(self):
        super().__init__()
        self.device = resolve_device(hparams.get("device"))
        self.seed = int(hparams.get("seed", 1234))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.loss_and_lambda = parse_mel_losses(hparams["mel_loss"])
        self._np_rng = np.random.RandomState(self.seed)
        # where a training step's random draws run; a CPU generator gives a
        # run on the card the draws of a CPU run
        self.rand_device = self.device
        self.disc_start_frames_wins = None  # pins the discriminator's windows
        self.discriminators: Dict[str, torch.nn.Module] = {}
        self.vocoder = None
        self.vocoder_calls = 0
        self._last_fakes = None

    # ------------------------------------------------------------------
    # subclass API
    def build_generator(self) -> torch.nn.Module:
        raise NotImplementedError

    def prep_batch(self, batch, infer: bool = False) -> Dict[str, torch.Tensor]:
        """Collated numpy batch -> the model's inputs on the device."""
        raise NotImplementedError

    def forward_losses(self, b, generator, train: bool):
        """-> (losses, fakes {name: mel}, real mels {name: mel})."""
        raise NotImplementedError

    def frozen_keys(self) -> Tuple[str, ...]:
        """Top-level modules of the generator that no optimizer updates."""
        return ()

    def build_extra_discs(self) -> Dict[str, Callable[[], torch.nn.Module]]:
        """Builders of the discriminators beyond the mel discriminator, by
        name (the speaker-consistency task's ``'_spk'``)."""
        return {}

    @property
    def mel_disc(self):
        """``discriminators['']``, under the name the flagship's task gives
        its one discriminator (None before ``build_train``)."""
        return self.discriminators.get("")

    def new_disc(self) -> Discriminator:
        """A multi-window mel discriminator of the recipe's settings."""
        hp = hparams
        return Discriminator(
            time_lengths=(32, 64, 128)[: hp["disc_win_num"]],
            freq_length=hp["audio_num_mel_bins"], hidden_size=hp["mel_disc_hidden_size"],
            norm_type=hp["disc_norm"], reduction=hp["disc_reduction"],
            cond_size=hp["hidden_size"] if hp.get("use_cond_disc") else 0)

    def _from_jax(self, state: dict) -> Dict[str, torch.Tensor]:
        """A JAX package checkpoint's ``state`` -> the model's state_dict."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _dev(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def build_model(self):
        """The generator from the seed, in eval mode without gradients;
        ``build_train`` makes it trainable."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            model = self.build_generator()
        self.model = model.to(self.device).eval().requires_grad_(False)
        return self.model

    def build_train(self):
        """Discriminator, optimizers and schedules (JAX: adv_base.py:74-160)."""
        hp = hparams
        if hp.get("mel_gan"):
            builders = dict({"": self.new_disc}, **self.build_extra_discs())
            for j, (name, build) in enumerate(builders.items()):
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(self.seed + 1 + j)
                    self.discriminators[name] = build().to(self.device)
        self.model.requires_grad_(True)
        frozen = tuple(f"{k}." for k in self.frozen_keys())
        for k in self.frozen_keys():
            getattr(self.model, k).requires_grad_(False)
        self.gen_params = [p for n, p in self.model.named_parameters()
                           if not n.startswith(frozen)]
        self.disc_params = [p for d in self.discriminators.values() for p in d.parameters()]
        b1, b2 = hp["optimizer_adam_beta1"], hp["optimizer_adam_beta2"]
        disc_p = hp.get("discriminator_optimizer_params") or {}
        self.opt_gen = torch.optim.AdamW(self.gen_params, lr=0.0, betas=(b1, b2), eps=1e-8,
                                         weight_decay=hp.get("weight_decay", 0.0) or 0.0)
        self.opt_disc = (torch.optim.AdamW(self.disc_params, lr=0.0, betas=(b1, b2),
                                           eps=disc_p.get("eps", 1e-8),
                                           weight_decay=disc_p.get("weight_decay", 0.0))
                         if self.disc_params else None)
        self.gen_grad_norm = hp.get("generator_grad_norm") or hp.get("clip_grad_norm") or 0
        self.sched_gen = (rsqrt_schedule(hp["lr"], hp["warmup_updates"], hp["hidden_size"])
                          if hp["scheduler"] == "rsqrt" else (lambda s: hp["lr"]))
        dsp = hp.get("discriminator_scheduler_params") or {"step_size": 60000, "gamma": 0.5}
        self.sched_disc = step_lr_schedule(hp["disc_lr"], dsp["step_size"], dsp["gamma"])
        self.build_accumulators(dict({"gen": self.gen_params},
                                     **({"disc": self.disc_params} if self.disc_params else {})))

    # ------------------------------------------------------------------
    # checkpoints
    def restore(self) -> int:
        ckpt = newest_checkpoint(hparams["work_dir"]) if hparams.get("work_dir") else None
        if ckpt is None:
            print(f"| WARNING: no checkpoint in '{hparams.get('work_dir')}'; "
                  "running with seeded random init.")
            return 0
        load_into(self.model, load_state_dict(ckpt, "model", self._from_jax),
                  type(self.model).__name__)
        print(f"| Restored ckpt: {ckpt}")
        return int(ckpt.rsplit("steps_", 1)[1].split(".")[0])

    def warm_start(self, path: str):
        """``load_ckpt``: the generator's parameters from another run's
        checkpoint (the port's or the JAX package's); BatchNorm statistics
        keep their init, as the JAX trainer loads ``state.params`` only."""
        ckpt = newest_checkpoint(path) if os.path.isdir(path) else path
        if not ckpt or not os.path.exists(ckpt):
            print(f"| WARNING: no checkpoint at {path}; keeping init.")
            return
        copy_parameters(self.model, load_state_dict(ckpt, "model", self._from_jax))
        print(f"| Warm-started params from {ckpt}")
        if not is_torch_file(ckpt):
            print("| The JAX checkpoint's optimizer states are not carried over.")

    def checkpoint_state(self) -> dict:
        sd = {"model": self.model.state_dict()}
        opts = [self.opt_gen.state_dict()]
        for name, d in self.discriminators.items():
            sd[f"mel_disc{name}"] = d.state_dict()
        if self.opt_disc is not None:
            opts.append(self.opt_disc.state_dict())
        return {"state_dict": sd, "optimizer_states": opts,
                "np_rng": np_rng_state(self._np_rng), "accumulators": self.accumulator_state()}

    def load_checkpoint_state(self, ckpt: dict):
        self.model.load_state_dict(ckpt["state_dict"]["model"])
        for name, d in self.discriminators.items():
            d.load_state_dict(ckpt["state_dict"][f"mel_disc{name}"])
        for opt, st in zip((self.opt_gen, self.opt_disc), ckpt.get("optimizer_states") or []):
            opt.load_state_dict(st)
        set_np_rng_state(self._np_rng, ckpt["np_rng"])
        self.load_accumulator_state(ckpt)

    # ------------------------------------------------------------------
    # the two optimizer steps (JAX: adv_base.py:181-300)
    def _disc_start(self, step: int) -> bool:
        return bool(hparams.get("mel_gan", False) and step > hparams["disc_start_steps"]
                    and hparams["lambda_mel_adv"] > 0)

    def _adv_loss(self, disc, mel, generator, target: float):
        o = disc(mel, self.disc_start_frames_wins, generator)
        return None if o["y"] is None else mse(o["y"], target)

    @span("update.gen")
    def gen_step(self, b, disc_on: bool, lr: float, generator):
        self.model.train()
        for d in self.discriminators.values():
            d.eval()
        losses, fakes, gts = self.forward_losses(b, generator, train=True)
        if disc_on and self.discriminators:
            with no_grad_for(self.disc_params):
                for name, mel in fakes.items():
                    for dname, disc in self.discriminators.items():
                        adv = self._adv_loss(disc, mel, generator, 1.0)
                        if adv is not None:
                            losses[f"{name}{dname}a"] = adv * hparams["lambda_mel_adv"]
        self.update("gen", self.opt_gen, self.gen_params, sum(losses.values()), lr,
                    self.gen_grad_norm, hparams.get("clip_grad_value"))
        return losses, {k: v.detach() for k, v in fakes.items()}, gts

    @span("update.disc")
    def disc_step(self, fakes, gts, lr: float, generator):
        for d in self.discriminators.values():
            d.train()
        losses: Dict[str, torch.Tensor] = {}
        for name in fakes:
            for dname, disc in self.discriminators.items():
                real = self._adv_loss(disc, gts[name], generator, 1.0)
                fake = self._adv_loss(disc, fakes[name], generator, 0.0)
                if real is not None:
                    losses[f"{name}{dname}r"] = real
                if fake is not None:
                    losses[f"{name}{dname}f"] = fake
        self.update("disc", self.opt_disc, self.disc_params,
                    sum(losses.values()) if losses else 0.0, lr,
                    hparams.get("discriminator_grad_norm", 0), hparams.get("clip_grad_value"))
        return losses

    def _training_step(self, batch, step: int, optimizer_idx: int):
        """(total loss, logs) of optimizer ``optimizer_idx`` at ``step``, or
        None when it is idle."""
        disc_on = self._disc_start(step)
        if optimizer_idx == 0:
            b = self.prep_batch(batch)
            g = step_generator(self.seed, step, self.rand_device)
            lr = self.sched_gen(step)
            losses, fakes, gts = self.gen_step(b, disc_on, lr, g)
            self._last_fakes = (fakes, gts, g)
            return sum(losses.values()), dict(losses, lr_0=lr)
        if optimizer_idx == 1:
            if (not self.discriminators or not disc_on or self._last_fakes is None
                    or step % hparams["disc_interval"] != 0):
                return None
            fakes, gts, g = self._last_fakes
            lr = self.sched_disc(max(step - hparams["disc_start_steps"], 1))
            losses = self.disc_step(fakes, gts, lr, g)
            if not losses:
                return None
            return sum(losses.values()), dict(losses, lr_1=lr)
        return None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def validation_step(self, batch, batch_idx: int):
        self.model.eval()
        b = self.prep_batch(batch, infer=True)
        losses, fakes, gts = self.forward_losses(b, self.generator, train=False)
        self.vis_validation(batch, fakes, gts, batch_idx)
        losses = {k: float(v) for k, v in losses.items()}
        return {"losses": losses, "total_loss": sum(losses.values()),
                "nsamples": batch["nsamples"]}

    def vis_validation(self, batch, fakes, gts, batch_idx):
        """Validation rendering hook; subclasses override."""
