"""SVB VAE tasks: three-optimizer training (generator, multi-window
discriminator, latent map) and the a2a/p2p/a2p inference path; port of
``neuralsvb_tpu/tasks/svb_vae_task.py`` (reference:
tasks/singing/svb_vae_task.py:48-726). ``SVBVAEMleTask`` is the flagship
recipe; ``SVBVAETechMleTask``, ``SVBVAESegTechMleTask``, ``SVBVAEBoostTask``
and ``SVBVAETask`` differ only in the model's ``variant`` (see
``models/svb_vae.py``), in their latent maps and, for the boost task, in
its validation ways.

Training (``Trainer.fit``): phase 2 runs the generator step on the ways
``a2a,p2p`` and the discriminator step on its detached fakes; phase 3
(after ``phase_2_steps``) runs only the latent-map step, with the model in
eval mode and its latent maps in training mode. The map step's a2p term is
the ``mle`` of the ``mle`` variant and the ``kl`` of every other, as in the
JAX package: the two technique-prior variants return an ``mle`` and no
``kl``, so their map trains on the a2p mel and adversarial losses alone. Each optimizer is a
chain of an optional value clip, a clip by global norm (by hand: optax
scales by max/norm only when norm > max) and AdamW with the learning rate
of its schedule at the step. Random draws of a step come from a
``torch.Generator`` seeded by (seed, step), so a resumed run draws what the
uninterrupted run draws.

The JAX package's training options: ``accumulate_grad_batches`` (one
``MultiSteps`` per optimizer; the trainer still counts every batch as a
step, so schedules and phases advance per micro-batch), ``compute_dtype:
bfloat16`` (the model and the discriminator run in bf16 behind the cast at
the apply boundary, ``apply_in_dtype``; parameters, optimizer states,
losses and the carried BatchNorm statistics stay in the master dtype),
``use_cond_disc`` (the discriminator's conditional branch, which no step
feeds: see ``models/disc.py``), ``binary_data_dirs`` (a concatenation of
the directories' train splits; the PPG cache then streams, see
``_build_ppg_cache``) and data parallelism over ``mesh_shape``
(``parallel/ddp.py``: each rank takes its rows of the global batch, and
the step computes what one process computes on the global batch).

Inference (``--infer``): packed test split -> ``SVBVAE`` forward for the
three ways -> HiFiGAN-NSF ->
``generated_{step}_{gen_dir_name}/wavs/{gt_a,gt_p,a2a,p2p,a2p}_wavout`` and
``mels/*_mel``. Everything after the collated numpy batch runs on the
``device`` hparam's device, f0 denormalization and the NSF source included.

``shard_infer: true`` under a launched world of ``mesh_shape: data:N``
(JAX: ``svb_vae_task.py:1032-1056``): with ``infer_batch_size`` a multiple
of N, every rank runs its rows of each test and validation batch inside
``ddp.sharded``, so its noise is its rows of the global batch's draw and its
losses are the global batch's, as the GSPMD forward computes; each rank
vocodes and writes its own items, under their global indices. A test batch
that does not divide (the ragged tail) runs whole on rank 0, as the JAX
package falls back to one device; a ragged validation batch runs whole on
every rank. Without a launched world the option changes nothing.

Under a ``torch.profiler`` session the step records the spans
``task.prep_batch`` (the batch's move to the device, the cached PPG rows
included), ``update.gen``, ``update.disc`` and ``update.map`` (each
optimizer's whole step) and ``mel_disc`` (each discriminator call)
(``utils/profiling.py`` ``span``).
"""

from __future__ import annotations

import glob
import json
import os
import time
from multiprocessing.pool import ThreadPool
from typing import Dict, Tuple

import numpy as np
import torch

from ..convert import msgpack_ckpt
from ..convert.checkpoint import (is_torch_file, load_into, load_state_dict,
                                  newest_checkpoint)
from ..convert.jax2torch import svbvae_from_jax, vcasr_from_jax
from ..data.datasets import MultiSpkEmbDataset, maybe_concat_dataset
from ..hparams import hparams, resolve_device
from ..models.disc import Discriminator
from ..models.svb_vae import SVBVAE, WAYS
from ..ops.fused_resblock import KERNEL_COUNTERS
from ..ops.pitch_utils import denorm_f0
from ..parallel import ddp
from ..training.schedulers import rsqrt_schedule, step_lr_schedule
from ..utils import num_params
from ..utils.plot import spec_to_figure
from ..utils.profiling import RTFMeter, span
from .base_task import (BaseTask, apply_in_dtype, compute_dtype, copy_parameters,
                        no_grad_for, np_rng_state, set_np_rng_state, step_generator)
from .losses import add_mel_loss, mse, nan_guard, parse_mel_losses


def _off(v) -> bool:
    return v in (False, 0, None, "", "off", "false", "0")


def load_pretrained_asr(vc_asr: torch.nn.Module, path: str) -> None:
    """Load a frozen ASR's weights from a reference torch checkpoint
    directory (the lexicographically last ``*.ckpt``, as the JAX package
    picks it) or, as the JAX package's ``load_sub_params``, from the
    ``state.params.vc_asr`` parameters of its own checkpoint (a file, or the
    newest in a directory); BatchNorm statistics keep their init on that
    path, as in the JAX package. An empty ``path`` does nothing."""
    if not path:
        return
    ckpts = (sorted(glob.glob(os.path.join(path, "*.ckpt"))) if os.path.isdir(path)
             else [path] if os.path.isfile(path) else [])
    if not ckpts:
        print(f"| WARNING: no checkpoint at {path}; keeping the ASR's init.")
        return
    if not is_torch_file(ckpts[-1]):
        ckpt = newest_checkpoint(path) if os.path.isdir(path) else path
        if ckpt is None:
            print(f"| WARNING: no model_ckpt_steps_*.ckpt in {path}; keeping the "
                  "ASR's init.")
            return
        node = msgpack_ckpt.load(ckpt)
        for k in ("state", "params", "vc_asr"):
            node = node.get(k, node) if isinstance(node, dict) else node
        copy_parameters(vc_asr, vcasr_from_jax(node))
        print(f"| Loaded the ASR's parameters from the JAX checkpoint {ckpt}")
        return
    sd = load_state_dict(ckpts[-1], "model")
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    if not any(k.startswith("vc_asr.") for k in sd):
        sd = {f"vc_asr.{k}": v for k, v in sd.items()}
    load_into(vc_asr, {k[len("vc_asr."):]: v for k, v in sd.items()
                       if k.startswith("vc_asr.")}, "VCASR")
    print(f"| Loaded the ASR from {ckpts[-1]}")


class SVBVAEMleTask(BaseTask):
    """Global latent + MLE-trained z mapping: the flagship
    (reference: SVBVAEMleTask:543, vae_global_mle_eng.yaml)."""

    num_optimizers = 3
    variant = "mle"

    def __init__(self):
        super().__init__()
        self.device = resolve_device(hparams.get("device"))
        self.seed = int(hparams.get("seed", 1234))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.zero_noise = bool(hparams.get("zero_noise", False))
        self.vocoder = None
        self.mel_disc = None
        # the host stream of the training batches' speaker-embedding column
        self._np_rng = np.random.RandomState(self.seed)
        # where a training step's random draws run; a CPU generator gives a
        # run on the card the draws of a CPU run
        self.rand_device = self.device
        self.disc_start_frames_wins = None  # pins the discriminator's windows
        self._train_ds = None
        self._ppg_cache = None  # built at the first cached batch; {} streams
        self._pending_disc = None
        self.cdt = compute_dtype()
        self.vocoder_calls = 0

    def build_model(self):
        """The SVB VAE from the seed, in eval mode without gradients (the
        inference path); ``build_train`` makes it trainable."""
        hp = hparams
        with torch.random.fork_rng(devices=[]):  # seeded random init
            torch.manual_seed(self.seed)
            model = SVBVAE(
                dict_size=self._dict_size(),
                hidden_size=hp["hidden_size"],
                num_mel_bins=hp["audio_num_mel_bins"],
                latent_size=hp["latent_size"],
                fvae_hidden=hp["fvae_enc_dec_hidden"],
                fvae_kernel=hp["fvae_kernel_size"],
                fvae_enc_layers=hp["fvae_enc_n_layers"],
                fvae_dec_layers=hp["fvae_dec_n_layers"],
                frames_multiple=hp["frames_multiple"],
                mel_strides=tuple(hp["mel_strides"]),
                asr_enc_layers=hp["asr_enc_layers"],
                asr_last_norm=hp["asr_last_norm"],
                variant=self.variant)
        self.model = model.to(self.device).eval().requires_grad_(False)
        num_params(self.model, model_name="Generator")
        return self.model

    def restore(self) -> int:
        ckpt = newest_checkpoint(hparams["work_dir"]) if hparams.get("work_dir") else None
        if ckpt is None:
            print(f"| WARNING: no checkpoint in '{hparams.get('work_dir')}'; "
                  "running SVBVAE with seeded random init.")
            return 0
        load_into(self.model, load_state_dict(ckpt, "model", self._from_jax), "SVBVAE")
        print(f"| Restored ckpt: {ckpt}")
        self.model.to(self.device)
        return int(ckpt.rsplit("steps_", 1)[1].split(".")[0])

    # ------------------------------------------------------------------
    # training set-up
    def build_train(self):
        """Discriminator, optimizers and schedules; the frozen ASR stays
        without gradients (reference: svb_vae_task.py:290-434)."""
        hp = hparams
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed + 1)
            self.mel_disc = Discriminator(
                time_lengths=(32, 64, 128)[: hp["disc_win_num"]],
                freq_length=hp["audio_num_mel_bins"],
                hidden_size=hp["mel_disc_hidden_size"], norm_type=hp["disc_norm"],
                reduction=hp["disc_reduction"],
                cond_size=hp["hidden_size"] if hp.get("use_cond_disc") else 0
            ).to(self.device)
        self.model.requires_grad_(True)
        self.model.vc_asr.requires_grad_(False)
        # the frozen ASR's warm start (reference: svb_vae_task.py:558)
        load_pretrained_asr(self.model.vc_asr, hp.get("pretrain_asr_ckpt") or "")
        maps = self.model.mapping_keys
        skip = ("vc_asr.",) + tuple(f"{k}." for k in maps)
        self.gen_params = [p for n, p in self.model.named_parameters()
                           if not n.startswith(skip)]
        self.map_params = [p for k in maps for p in getattr(self.model, k).parameters()]
        self.disc_params = list(self.mel_disc.parameters())
        b1, b2 = hp["optimizer_adam_beta1"], hp["optimizer_adam_beta2"]
        wd = hp.get("weight_decay", 0.0) or 0.0
        disc_p = hp.get("discriminator_optimizer_params") or {}

        def adamw(params, eps, weight_decay):
            return torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), eps=eps,
                                     weight_decay=weight_decay)
        self.opt_gen = adamw(self.gen_params, 1e-8, wd)
        self.opt_disc = adamw(self.disc_params, disc_p.get("eps", 1e-8),
                              disc_p.get("weight_decay", 0.0))
        self.opt_map = adamw(self.map_params, 1e-8, wd)
        self.sched_gen = (rsqrt_schedule(hp["lr"], hp["warmup_updates"], hp["hidden_size"])
                          if hp["scheduler"] == "rsqrt" else (lambda s: hp["lr"]))
        dsp = hp.get("discriminator_scheduler_params") or {"step_size": 60000, "gamma": 0.5}
        self.sched_disc = step_lr_schedule(hp["disc_lr"], dsp["step_size"], dsp["gamma"])
        msp = hp.get("map_scheduler_params") or {"step_size": 60000, "gamma": 0.5}
        self.sched_map = step_lr_schedule(hp["map_lr"], msp["step_size"], msp["gamma"])
        self.loss_and_lambda = parse_mel_losses(hp["mel_loss"])
        self.build_accumulators({"gen": self.gen_params, "disc": self.disc_params,
                                 "map": self.map_params})

    def _from_jax(self, state: dict) -> Dict[str, torch.Tensor]:
        """A JAX package checkpoint's ``state`` -> the model's state_dict."""
        return svbvae_from_jax(state["params"], state.get("batch_stats") or {}, self.variant)

    def warm_start(self, path: str):
        """``load_ckpt``: the SVB model's parameters from another run's
        checkpoint (a file or the newest in a directory), the port's or the
        JAX package's; parameters whose shape differs keep their init, and
        so do the BatchNorm statistics (the JAX trainer's warm start loads
        ``state.params`` only)."""
        ckpt = newest_checkpoint(path) if os.path.isdir(path) else path
        if not ckpt or not os.path.exists(ckpt):
            print(f"| WARNING: no checkpoint at {path}; keeping init.")
            return
        copy_parameters(self.model, load_state_dict(ckpt, "model", self._from_jax))
        print(f"| Warm-started params from {ckpt}")
        if not is_torch_file(ckpt):
            print("| The JAX checkpoint's optimizer states are not carried over: "
                  "the optimizers start fresh.")

    def checkpoint_state(self) -> dict:
        return {
            "state_dict": {"model": self.model.state_dict(),
                           "mel_disc": self.mel_disc.state_dict()},
            "optimizer_states": [self.opt_gen.state_dict(), self.opt_disc.state_dict(),
                                 self.opt_map.state_dict()],
            "emb_column_rng": np_rng_state(self._np_rng),
            "accumulators": self.accumulator_state(),
        }

    def load_checkpoint_state(self, ckpt: dict):
        self.model.load_state_dict(ckpt["state_dict"]["model"])
        if "mel_disc" in ckpt["state_dict"]:
            self.mel_disc.load_state_dict(ckpt["state_dict"]["mel_disc"])
        for opt, st in zip((self.opt_gen, self.opt_disc, self.opt_map),
                           ckpt.get("optimizer_states") or []):
            opt.load_state_dict(st)
        if "emb_column_rng" in ckpt:
            set_np_rng_state(self._np_rng, ckpt["emb_column_rng"])
        self.load_accumulator_state(ckpt)
        # cached PPG rows came from the ASR weights before the restore
        self._ppg_cache = None

    # ------------------------------------------------------------------
    # phases (reference: svb_vae_task.py:587-595)
    def phase_and_ways(self, step: int) -> Tuple[int, Tuple[str, ...]]:
        hp = hparams
        if step <= hp["phase_1_steps"]:
            return 1, tuple(hp["phase_1_concurrent_ways"].split(","))
        if step <= hp["phase_2_steps"]:
            return 2, tuple(hp["phase_2_concurrent_ways"].split(","))
        return 3, tuple(hp["phase_3_concurrent_ways"].split(","))

    def train_phase(self, step: int) -> int:
        return self.phase_and_ways(step)[0]

    def _disc_start(self, step: int) -> bool:
        return bool(hparams["mel_gan"] and step > hparams["disc_start_steps"]
                    and hparams["lambda_mel_adv"] > 0)

    def _val_ways(self, step: int) -> Tuple[str, ...]:
        if step <= hparams["phase_1_steps"]:
            return ("p2p",)
        if step <= hparams["phase_2_steps"]:
            return ("a2a", "p2p")
        return WAYS

    # ------------------------------------------------------------------
    @span("task.prep_batch")
    def _prep_batch(self, batch, train: bool = False):
        """Collated numpy batch -> model inputs on the device. Inference
        takes speaker-embedding column 0, a training batch a random other
        column (reference: svb_vae_task.py:139-143); with ``cache_ppg`` a
        training batch carries the cached content rows. In a data-parallel
        step the batch holds this rank's rows (``BaseTask.training_step``)
        and every rank draws the same column."""
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)
        real = torch.get_default_dtype()
        col = (int(self._np_rng.randint(1, batch["multi_spk_emb"].shape[1]))
               if train else 0)
        b = {
            "mels": dev(batch["mels"], real),
            "prof_mels": dev(batch["prof_mels"], real),
            "pitch": dev(batch["pitch"], torch.long),
            "prof_pitch": dev(batch["prof_pitch"], torch.long),
            "a2p_f0_alignment": dev(batch["a2p_f0_alignment"], torch.long),
            "spk_emb": dev(batch["multi_spk_emb"][:, col], real),
        }
        if train and not _off(hparams.get("cache_ppg", False)):
            rows = self._cached_ppg(batch)
            if rows is not None:
                b["ppg_a"], b["ppg_p"] = rows
        return b

    def _mel_stride(self) -> int:
        return int(np.prod(hparams.get("mel_strides", (2, 1, 1))))

    @torch.no_grad()
    def _build_ppg_cache(self):
        """The frozen ASR's content rows of every train item, each side
        computed alone at its exact length, kept on the device in f32.

        Batches address the cache by their items' ``id``. The members of a
        concatenation (``binary_data_dirs``) emit member-local ids, so two
        members' item 0 would share a row; there the JAX package's device
        cache streams instead (``neuralsvb_tpu/data/device_cache.py:120-133``)
        and the model computes the PPG in the step, at the collate-length
        rel-pos. The port does the same: returns an empty cache."""
        t0 = time.perf_counter()
        cache = {"a": {}, "p": {}}
        ds = self._train_ds
        for i in range(len(ds)):
            s = ds[i]
            if int(s["id"]) != i:
                print("| PPG cache: the train items' ids are not global indices (a "
                      "concatenation of binary_data_dirs); computing the PPG in every "
                      "step instead, as the JAX package's device cache streams")
                return {}
            for side, key in (("a", "mel"), ("p", "prof_mel")):
                mel = torch.as_tensor(s[key], dtype=torch.get_default_dtype(),
                                      device=self.device).T[None]
                cache[side][int(s["id"])] = self.model.extract_ppg(mel, True)[0]
        n = sum(r.numel() for side in cache.values() for r in side.values())
        print(f"| PPG cache: {len(ds)} items, {n * 4 / 1e6:.1f} MB on {self.device}, "
              f"{time.perf_counter() - t0:.2f} s")
        return cache

    def _cached_ppg(self, batch):
        if self._ppg_cache is None:
            self._ppg_cache = self._build_ppg_cache()
        if not self._ppg_cache:
            return None
        stride, H = self._mel_stride(), hparams["hidden_size"]
        out = []
        for side, key in (("a", "mels"), ("p", "prof_mels")):
            T = -(-batch[key].shape[1] // stride)
            rows = torch.zeros(len(batch["id"]), H, T, device=self.device)
            for i, idx in enumerate(batch["id"]):
                r = self._ppg_cache[side][int(idx)]
                rows[i, :, : r.shape[-1]] = r
            out.append(rows)
        return out

    def _run_model(self, b, ways, generator, exact_lengths=None, carry=()):
        """The model on the batch in ``compute_dtype``; ``carry`` names the
        modules whose BatchNorm statistics the step keeps (see
        ``apply_in_dtype``)."""
        return apply_in_dtype(
            self.model, self.cdt, b["mels"], b["prof_mels"], b["pitch"], b["prof_pitch"],
            b["spk_emb"], b["a2p_f0_alignment"], carry=carry,
            disable_map=bool(hparams.get("disable_map", False)),
            generator=generator, zero_noise=self.zero_noise, ways=ways,
            exact_lengths=exact_lengths, ppg_a=b.get("ppg_a"), ppg_p=b.get("ppg_p"))

    @torch.no_grad()
    def forward(self, b):
        return self._run_model(b, WAYS, self.generator)

    def _model_losses(self, out, b, ways) -> Dict[str, torch.Tensor]:
        losses: Dict[str, torch.Tensor] = {}
        for way in ways:
            mel_g = b["prof_mels"] if way in ("p2p", "a2p") else b["mels"]
            if "kl" in out[way]:
                losses[f"{way}_kl"] = nan_guard(out[way]["kl"]) * hparams["lambda_kl"]
            if way in ("a2a", "p2p") or not hparams["cross_way_no_recon_loss"]:
                add_mel_loss(self.loss_and_lambda, out[way]["mel_out"], mel_g, losses,
                             postfix=way)
        return losses

    @span("mel_disc")
    def _adv_loss(self, mel, generator, target: float, carry=()):
        o = apply_in_dtype(self.mel_disc, self.cdt, mel, self.disc_start_frames_wins,
                           generator, carry=carry)
        return None if o["y"] is None else mse(o["y"], target)

    # ------------------------------------------------------------------
    # the three optimizer steps (reference: svb_vae_task.py:549-693)
    @span("update.gen")
    def gen_step(self, b, ways, disc_on: bool, lr: float, generator):
        self.model.train()
        self.mel_disc.eval()
        out = self._run_model(b, ways, generator, carry=("",))
        losses = self._model_losses(out, b, ways)
        if disc_on:
            with no_grad_for(self.disc_params):
                for way in ways:
                    adv = self._adv_loss(out[way]["mel_out"], generator, 1.0)
                    if adv is not None:
                        losses[f"{way}_a"] = adv * hparams["lambda_mel_adv"]
        self.update("gen", self.opt_gen, self.gen_params, sum(losses.values()), lr,
                    hparams.get("generator_grad_norm", 0), hparams.get("clip_grad_value"))
        return losses, {w: out[w]["mel_out"].detach() for w in ways}

    @span("update.disc")
    def disc_step(self, b, ways, fakes, lr: float, generator):
        self.mel_disc.train()
        losses: Dict[str, torch.Tensor] = {}
        for way in ways:
            mel_g = b["prof_mels"] if way in ("p2p", "a2p") else b["mels"]
            real = self._adv_loss(mel_g, generator, 1.0, carry=("",))
            fake = self._adv_loss(fakes[way], generator, 0.0, carry=("",))
            if real is not None:
                losses[f"{way}_r"] = real
            if fake is not None:
                losses[f"{way}_f"] = fake
        self.update("disc", self.opt_disc, self.disc_params,
                    sum(losses.values()) if losses else 0.0, lr,
                    hparams.get("discriminator_grad_norm", 0), hparams.get("clip_grad_value"))
        return losses

    @span("update.map")
    def map_step(self, b, ways, disc_on: bool, lr: float, generator):
        """Eval-mode model with the maps in training mode, on padded
        batches at the collate-length rel-pos (svb_vae_task.py:645-652).
        The a2p term is ``mle`` for the ``mle`` variant and ``kl`` for the
        others (JAX: ``kl_or_mle``); the adversarial term reads the sampled
        decode where the way has one."""
        hp = hparams
        all_ways = tuple(dict.fromkeys(("a2a", "p2p") + tuple(ways)))
        kl_or_mle = "mle" if self.variant == "mle" else "kl"
        self.model.eval()
        for k in self.model.mapping_keys:
            getattr(self.model, k).train()
        self.mel_disc.eval()
        with no_grad_for(self.gen_params + self.disc_params):
            out = self._run_model(b, all_ways, generator, exact_lengths=False,
                                  carry=self.model.mapping_keys)
            losses = self._model_losses(out, b, all_ways)
            for way in ways:
                if way in ("a2a", "p2p"):
                    continue
                if kl_or_mle in out[way]:
                    losses[f"{way}_{kl_or_mle}"] = (nan_guard(out[way][kl_or_mle])
                                                    * hp.get("lambda_mle", 1.0))
                if disc_on and not hp["cross_way_no_disc_loss"]:
                    fake = out[way].get("a2p_sample_recon", out[way]["mel_out"])
                    adv = self._adv_loss(fake, generator, 1.0)
                    if adv is not None:
                        losses[f"{way}_a"] = adv * hp["lambda_mel_adv"]
        self.update("map", self.opt_map, self.map_params, sum(losses.values()), lr,
                    hp.get("generator_grad_norm", 0), hp.get("clip_grad_value"))
        return losses

    def _training_step(self, batch, step: int, optimizer_idx: int):
        """(total loss, logs) of optimizer ``optimizer_idx`` at ``step``, or
        None when it is idle; the generator pass also runs the
        discriminator's, whose result optimizer 1 reports."""
        phase, ways = self.phase_and_ways(step)
        disc_on = self._disc_start(step)
        if optimizer_idx == 0:
            if phase == 3:
                return None
            b = self._prep_batch(batch, train=True)
            g = step_generator(self.seed, step, self.rand_device)
            lr = self.sched_gen(step)
            losses, fakes = self.gen_step(b, ways, disc_on, lr, g)
            self._pending_disc = None
            if disc_on and step % hparams["disc_interval"] == 0:
                lr_d = self.sched_disc(max(step - hparams["disc_start_steps"], 1))
                self._pending_disc = (self.disc_step(b, ways, fakes, lr_d, g), lr_d)
            return sum(losses.values()), dict(losses, lr_0=lr)
        if optimizer_idx == 1:
            if phase == 3 or self._pending_disc is None:
                return None
            losses, lr_d = self._pending_disc
            self._pending_disc = None
            total = sum(losses.values()) if losses else 0.0
            return total, dict(losses, lr_1=lr_d)
        if optimizer_idx == 2 and phase == 3:
            b = self._prep_batch(batch, train=True)
            lr = self.sched_map(step)
            losses = self.map_step(b, ways, disc_on, lr,
                                   step_generator(self.seed, step, self.rand_device))
            return sum(losses.values()), dict(losses, lr_2=lr)
        return None

    # ------------------------------------------------------------------
    def _shards(self, batch) -> bool:
        """Whether ``batch`` runs sharded over the ranks (``shard_infer``
        under a launched world, a batch that divides over it)."""
        return (bool(hparams.get("shard_infer")) and self.n_devices > 1
                and batch["nsamples"] % self.n_devices == 0)

    @torch.no_grad()
    def validation_step(self, batch, batch_idx: int):
        ways = self._val_ways(self.global_step)
        self.model.eval()
        n = batch["nsamples"]
        with ddp.sharded(self.n_devices if self._shards(batch) else 1):
            batch = ddp.local_batch(batch)
            b = self._prep_batch(batch)
            out = self._run_model(b, ways, self.generator)
            losses = self._model_losses(out, b, ways)
        for way in ways:
            if "mle" in out[way]:
                losses[f"{way}_mle"] = out[way]["mle"]
        losses = {k: float(v) for k, v in losses.items()}
        self._vis_validation(out, batch, batch_idx, ways)
        return {"losses": losses, "total_loss": sum(losses.values()), "nsamples": n}

    def _vis_validation(self, out, batch, batch_idx, ways):
        """Vocoded validation audio and the mel ``gt|pred`` figures of the
        first ``num_valid_plots`` batches every ``valid_infer_interval``
        steps (reference: svb_vae_task.py:247-298)."""
        if (self.logger is None
                or self.global_step % hparams["valid_infer_interval"] != 0
                or batch_idx >= hparams.get("num_valid_plots", 0)):
            return
        if self.vocoder is None:
            from ..vocoders.base import get_vocoder_cls
            self.vocoder = get_vocoder_cls(hparams)(dict(hparams), device=self.device)

        def dev(k):
            return torch.as_tensor(batch[k], device=self.device)
        f0s = {"a2a": denorm_f0(dev("f0"), dev("uv"), hparams),
               "p2p": denorm_f0(dev("prof_f0"), dev("prof_uv"), hparams)}
        f0s["a2p"] = f0s["p2p"]
        lens = {"a2a": int(batch["mel_lengths"][0]),
                "p2p": int(batch["prof_mel_lengths"][0])}
        lens["a2p"] = lens["p2p"]
        sr = hparams["audio_sample_rate"]
        for way in ways:
            L = lens[way]
            wav = self.vocoder.spec2wav(out[way]["mel_out"][0, :L], f0=f0s[way][0, :L],
                                        zero_noise=self.zero_noise)
            self.logger.add_audio(f"{way}_wavout_{batch_idx}", wav.cpu().numpy(),
                                  self.global_step, sr)
            if self.logger.writes_figures:
                gt = (batch["prof_mels"] if way != "a2a" else batch["mels"])[0][:L]
                mel = out[way]["mel_out"][0, :L].float().cpu().numpy()
                fig = spec_to_figure(np.concatenate([gt, mel], -1), vmin=hparams["mel_vmin"],
                                     vmax=hparams["mel_vmax"], title=f"{way} gt|pred")
                self.logger.add_figure(f"{way}_gt_{batch_idx}", fig, self.global_step)
        L = lens["a2a"]
        gt_a = self.vocoder.spec2wav(torch.as_tensor(batch["mels"][0, :L], device=self.device),
                                     f0=f0s["a2a"][0, :L], zero_noise=self.zero_noise)
        self.logger.add_audio(f"gt_a_wav_{batch_idx}", gt_a.cpu().numpy(),
                              self.global_step, sr)
        self.vocoder_calls += len(ways) + 1

    # ------------------------------------------------------------------
    def test_start(self):
        from ..vocoders.base import get_vocoder_cls
        self.saving_result_pool = ThreadPool(8)
        self.saving_results_futures = []
        self.vocoder = get_vocoder_cls(hparams)(dict(hparams), device=self.device)
        self.results_id = 0
        self._n_infer_utts = 0
        self.vocoder_calls = 0
        self._rtf = RTFMeter()
        # test_end reports the test loop's launches
        for c in KERNEL_COUNTERS:
            c.launches = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def test_step(self, batch, batch_idx: int):
        t0 = time.perf_counter()
        shards = self._shards(batch)
        if (hparams.get("shard_infer") and self.n_devices > 1 and not shards
                and not ddp.is_main()):
            return {"item_name": batch["item_name"][0]}  # rank 0 runs the ragged batch
        with ddp.sharded(self.n_devices if shards else 1):
            batch = ddp.local_batch(batch)
            # the reference resets the result index at every test_step; a
            # rank's items keep their index in the global batch
            self.results_id = ddp.rank() * batch["nsamples"] if shards else 0
            b = self._prep_batch(batch)
            out = self.forward(b)

        def dev(k):
            return torch.as_tensor(batch[k], device=self.device)
        f0s = {"a2a": denorm_f0(dev("f0"), dev("uv"), hparams),
               "p2p": denorm_f0(dev("prof_f0"), dev("prof_uv"), hparams)}
        f0s["a2p"] = f0s["p2p"]
        gen_dir = os.path.join(
            hparams["work_dir"],
            f"generated_{self.global_step}_{hparams['gen_dir_name']}")
        prefix = "disable_map_" if hparams.get("disable_map") else ""
        voc = self.vocoder
        audio_sec = 0.0
        for i in range(batch["nsamples"]):
            Ta = int(batch["mel_lengths"][i])
            Tp = int(batch["prof_mel_lengths"][i])
            lens = {"a2a": Ta, "p2p": Tp, "a2p": Tp}
            wavs = {
                "gt_a_wavout": voc.spec2wav(b["mels"][i, :Ta], f0=f0s["a2a"][i, :Ta],
                                            zero_noise=self.zero_noise),
                "gt_p_wavout": voc.spec2wav(b["prof_mels"][i, :Tp],
                                            f0=f0s["p2p"][i, :Tp],
                                            zero_noise=self.zero_noise),
            }
            mels = {"gt_a_mel": batch["mels"][i][:Ta],
                    "gt_p_mel": batch["prof_mels"][i][:Tp]}
            for way in WAYS:
                L = lens[way]
                mel = out[way]["mel_out"][i, :L]
                wavs[f"{way}_wavout"] = voc.spec2wav(mel, f0=f0s[way][i, :L],
                                                     zero_noise=self.zero_noise)
                mels[f"{way}_mel"] = mel
            wavs = {k: v.cpu().numpy() for k, v in wavs.items()}
            mels = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in mels.items()}
            base_fn = f"[{self.results_id:06d}][{batch['item_name'][i]}][P]".replace(" ", "_")
            self.results_id += 1
            self._n_infer_utts += 1
            self.vocoder_calls += len(wavs)
            audio_sec += Tp * hparams["hop_size"] / hparams["audio_sample_rate"]
            self.saving_results_futures.append(
                self.saving_result_pool.apply_async(
                    self.save_result, args=[wavs, base_fn, gen_dir, mels, prefix]))
        self._rtf.add(time.perf_counter() - t0, audio_sec)  # .cpu() above synchronized
        return {"item_name": batch["item_name"][0]}

    @staticmethod
    def save_result(wavs_dict, base_fn, gen_dir, mels_dict, prefix=""):
        from ..ops.audio import save_wav
        sr = hparams["audio_sample_rate"]
        for key, wav in wavs_dict.items():
            d = f"{gen_dir}/wavs/{prefix}{key}"
            os.makedirs(d, exist_ok=True)
            save_wav(wav, f"{d}/{base_fn}.wav", sr,
                     norm=hparams.get("out_wav_norm", False))
        for key, mel in mels_dict.items():
            d = f"{gen_dir}/mels/{prefix}{key}"
            os.makedirs(d, exist_ok=True)
            np.save(f"{d}/{base_fn}.npy", mel)

    def test_end(self, outputs):
        self.saving_result_pool.close()
        for f in self.saving_results_futures:
            f.get()
        self.saving_result_pool.join()
        summary = {
            "device": str(self.device), "rank": ddp.rank(), "world": ddp.world_size(),
            "utts": self._n_infer_utts, "vocoder_calls": self.vocoder_calls,
            "audio_sec": self._rtf.audio_sec, "compute_sec": self._rtf.compute_sec,
            "rtf": self._rtf.rtf,
            **{f"{c.__name__}_launches": c.launches for c in KERNEL_COUNTERS},
        }
        if self.device.type == "cuda":
            summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        if hparams.get("profile_infer"):
            m = self._rtf
            print(f"| profile_infer: {self._n_infer_utts} utts "
                  f"({len(outputs)} batches), {m.audio_sec:.1f}s audio in "
                  f"{m.compute_sec:.2f}s wall -> RTF {m.rtf:.5f}")
        print(f"| infer summary: {json.dumps(summary)}")
        return summary

    # ------------------------------------------------------------------
    def train_dataloader(self):
        ds = maybe_concat_dataset(MultiSpkEmbDataset, hparams["train_set_name"], shuffle=True)
        self._train_ds = ds  # the PPG cache's items
        return self.build_dataloader(ds, True, hparams["max_tokens"],
                                     hparams["max_sentences"],
                                     endless=hparams["endless_ds"], n_devices=self.n_devices)

    def val_dataloader(self):
        ds = MultiSpkEmbDataset(hparams["valid_set_name"], shuffle=False)
        max_vt = hparams["max_valid_tokens"]
        max_vs = hparams["max_valid_sentences"]
        return self.build_dataloader(
            ds, False, hparams["max_tokens"] if max_vt == -1 else max_vt,
            hparams["max_sentences"] if max_vs == -1 else max_vs)

    def test_dataloader(self):
        ds = MultiSpkEmbDataset(hparams["test_set_name"], shuffle=False)
        return self.build_dataloader(ds, max_sentences=int(hparams.get("infer_batch_size") or 1),
                                     use_batch_by_size=False)


class SVBVAETask(SVBVAEMleTask):
    """Frame-level latent, mean and scale maps of k3 convs
    (reference: SVBVAETask, svb_vae_task.py:48; JAX: ``variant="local"``)."""

    variant = "local"


class SVBVAEBoostTask(SVBVAEMleTask):
    """Global latent, mean and scale maps (reference: SVBVAEBoostTask:384;
    JAX: ``variant="global"``)."""

    variant = "global"

    def _val_ways(self, step: int) -> Tuple[str, ...]:
        # validates a2p already in phase 2 (reference: svb_vae_task.py:512-517)
        if step <= hparams["phase_1_steps"]:
            return ("p2p",)
        return WAYS


class SVBVAETechMleTask(SVBVAEMleTask):
    """The MLE variant with the technique prior N(tech_id, 1)
    (reference model: TechPriorMleSVBVAE, svb_vae.py:315)."""

    variant = "tech_mle"


class SVBVAESegTechMleTask(SVBVAEMleTask):
    """The technique prior with the attention-aligned PPG
    (reference model: SegTechPriorMleSVBVAE, svb_vae.py:402)."""

    variant = "seg_tech_mle"
