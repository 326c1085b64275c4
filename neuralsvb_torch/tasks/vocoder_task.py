"""HiFiGAN-NSF vocoder training; port of ``VocoderDataset`` and
``HifiGanTask`` of ``neuralsvb_tpu/tasks/vocoder_task.py``.

LSGAN over the multi-period and multi-scale discriminators, an L1 loss on
the log-mel of the generated audio (``ops.stft.log_mel_batch``) and an
optional feature-matching loss, on random ``max_samples`` crops of a
packed split binarized with ``binarization_args.with_wav`` (and ``with_f0``
for NSF). Two optimizers, each Adam (``adam_b1``/``adam_b2``, eps 1e-8, no
weight decay) behind the optax-style clip by global norm (``clip_gradients``:
``generator_grad_norm``, ``discriminator_grad_norm`` over both
discriminators together), learning rates from StepLR schedules. The
generator's ResBlock clusters run forward through the card's ResBlock kernel
(bf16 operands by default) and backward through the plain f32 recompute,
as the JAX ``custom_vjp`` does.

Step s: the generator step, then, once s > ``disc_start_steps``, the
discriminator step on the generator step's detached output and the same
batch. The NSF draws of a step come from a ``torch.Generator`` seeded by
(seed, step), so a resumed run draws what the uninterrupted run draws;
``zero_noise`` makes them zero. Checkpoints hold ``state_dict.model_gen``
(what ``vocoders/hifigan.py`` loads), ``mpd`` and ``msd`` and both
optimizer states.

``mesh_shape: data:N`` trains data-parallel over N ranks started by
``torchrun`` (``parallel/ddp.py``), as the JAX task trains over its
``data`` mesh: the batch budget is ``max_sentences x N``, every rank crops
the same global batch and keeps its rows, the NSF draws are the global
batch's, and the losses' means run over the global batch. A mesh the
launched world cannot honour raises. The JAX vocoder tasks do not read
``accumulate_grad_batches`` (their optimizers have no ``MultiSteps``), and
neither do these.

``BigVGANTask`` trains BigVGAN-v2 (``models/bigvgan.py``) with the same
steps against the multi-period and multi-resolution discriminators, its
losses summed over sub-discriminators as BigVGAN sums them.

``PWGTask`` trains the Parallel WaveGAN generator the same way, with the
multi-resolution STFT loss, one discriminator and RAdam (``PWGTask`` of
the JAX package).

Under a ``torch.profiler`` session a step records the spans
``task.prep_batch``, ``update.gen``, ``update.disc`` and ``mel_loss`` (each
log-mel of the loss) (``utils/profiling.py`` ``span``).
"""

from __future__ import annotations

import functools
import operator
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..data.indexed_dataset import IndexedDataset
from ..hparams import hparams, resolve_device
from ..models.bigvgan import BigVGANGenerator, MultiResolutionDiscriminator
from ..models.hifigan import (HifiGanGenerator, MultiPeriodDiscriminator,
                              MultiScaleDiscriminator, discriminator_loss, feature_loss,
                              generator_loss)
from ..models.stft_loss import DEFAULT_RESOLUTIONS, multi_resolution_stft_loss
from ..ops.stft import log_mel_batch
from ..parallel import ddp
from ..training.optim import RAdam
from ..training.schedulers import step_lr_schedule
from ..utils.profiling import span
from .base_task import BaseTask, no_grad_for, step_generator
from .losses import mse


class VocoderDataset:
    """Random fixed-length wav crops and their mel/f0 windows. One
    ``RandomState(seed)`` draws the shuffle of ``ordered_indices`` and the
    crop starts; an item shorter than the crop is zero-padded from 0."""

    def __init__(self, prefix: str, shuffle: bool = False):
        self.prefix = prefix
        self.ds = IndexedDataset(f"{hparams['binary_data_dir']}/{prefix}")
        self.shuffle = shuffle
        self.rng = np.random.RandomState(hparams.get("seed", 1234))
        self.max_samples = hparams.get("max_samples", 8192)
        self.hop = hparams["hop_size"]

    def __len__(self):
        return len(self.ds)

    def ordered_indices(self):
        idx = np.arange(len(self))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __getitem__(self, index):
        item = self.ds[index]
        wav = np.asarray(item["wav"], np.float32)
        mel = np.asarray(item["mel"], np.float32)
        f0 = np.asarray(item.get("f0", np.zeros(len(mel))), np.float32)
        frames = self.max_samples // self.hop
        T = min(len(mel), len(wav) // self.hop)
        if T <= frames:
            mel_seg = np.pad(mel[:T], ((0, frames - T), (0, 0)))
            f0_seg = np.pad(f0[:T], (0, frames - T))
            wav_seg = np.pad(wav[: T * self.hop], (0, (frames - T) * self.hop))
        else:
            start = self.rng.randint(0, T - frames)
            mel_seg = mel[start:start + frames]
            f0_seg = f0[start:start + frames]
            wav_seg = wav[start * self.hop:(start + frames) * self.hop]
        return {"wav": wav_seg, "mel": mel_seg, "f0": f0_seg}

    def collater(self, samples):
        return {"wavs": np.stack([s["wav"] for s in samples]),
                "mels": np.stack([s["mel"] for s in samples]),
                "f0": np.stack([s["f0"] for s in samples]),
                "nsamples": len(samples)}


class HifiGanTask(BaseTask):
    num_optimizers = 2
    # (loss key suffix, attribute) of each discriminator, in update order
    DISCS = (("p", "mpd"), ("s", "msd"))

    def __init__(self):
        super().__init__()
        self.device = resolve_device(hparams.get("device"))
        self.seed = int(hparams.get("seed", 1234))
        self.generator = torch.Generator(device=self.device)  # validation's NSF draws
        self.generator.manual_seed(self.seed)
        self.zero_noise = bool(hparams.get("zero_noise", False))
        self.vocoder_calls = 0  # generator forwards (train and validation)
        self._pending = None  # the generator step's batch and output, for the disc step

    def build_model(self):
        """Generator and both discriminators from the seed, on the device."""
        hp = hparams
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.model = HifiGanGenerator(
                upsample_rates=tuple(hp["upsample_rates"]),
                upsample_kernel_sizes=tuple(hp["upsample_kernel_sizes"]),
                upsample_initial_channel=hp["upsample_initial_channel"],
                resblock=str(hp["resblock"]),
                resblock_kernel_sizes=tuple(hp["resblock_kernel_sizes"]),
                resblock_dilation_sizes=tuple(tuple(d) for d in hp["resblock_dilation_sizes"]),
                use_pitch_embed=hp["use_pitch_embed"],
                audio_sample_rate=hp["audio_sample_rate"],
                num_mels=hp["audio_num_mel_bins"])
            self.mpd = MultiPeriodDiscriminator()
            self.msd = MultiScaleDiscriminator()
        for m in (self.model, self.mpd, self.msd):
            m.to(self.device)
        return self.model

    def _discs(self):
        """(loss key suffix, discriminator) of each entry of ``DISCS``."""
        return [(k, getattr(self, attr)) for k, attr in self.DISCS]

    @staticmethod
    def _adv(loss, outs):
        """An adversarial loss over a discriminator's outputs ``outs``: the
        mean over its sub-discriminators, as the shared losses give it (the
        NeuralSVB reference)."""
        return loss

    def build_train(self):
        hp = hparams
        b1, b2 = hp.get("adam_b1", 0.8), hp.get("adam_b2", 0.99)
        self.gen_params = list(self.model.parameters())
        self.disc_params = [p for _, d in self._discs() for p in d.parameters()]
        self.opt_gen = torch.optim.Adam(self.gen_params, lr=0.0, betas=(b1, b2), eps=1e-8)
        self.opt_disc = torch.optim.Adam(self.disc_params, lr=0.0, betas=(b1, b2), eps=1e-8)
        gsp = hp.get("generator_scheduler_params") or {"step_size": 600, "gamma": 0.999}
        dsp = hp.get("discriminator_scheduler_params") or gsp
        self.sched_gen = step_lr_schedule(
            (hp.get("generator_optimizer_params") or {}).get("lr", 2e-4),
            gsp["step_size"], gsp["gamma"])
        self.sched_disc = step_lr_schedule(
            (hp.get("discriminator_optimizer_params") or {}).get("lr", 2e-4),
            dsp["step_size"], dsp["gamma"])

    def checkpoint_state(self) -> dict:
        return {"state_dict": {"model_gen": self.model.state_dict(),
                               **{a: getattr(self, a).state_dict() for _, a in self.DISCS}},
                "optimizer_states": [self.opt_gen.state_dict(), self.opt_disc.state_dict()]}

    def load_checkpoint_state(self, ckpt: dict):
        sd = ckpt["state_dict"]
        self.model.load_state_dict(sd["model_gen"])
        for _, a in self.DISCS:
            getattr(self, a).load_state_dict(sd[a])
        for opt, st in zip((self.opt_gen, self.opt_disc), ckpt.get("optimizer_states") or []):
            opt.load_state_dict(st)

    def train_phase(self, step: int) -> str:
        return "gen" if step <= hparams.get("disc_start_steps", 0) else "gen_disc"

    # ------------------------------------------------------------------
    @span("task.prep_batch")
    def _prep_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Moves the batch to the device in the default float dtype."""
        real = torch.get_default_dtype()
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=real, device=self.device)
                for k in ("wavs", "mels", "f0")}

    @span("mel_loss")
    def _mel_fn(self, wav):
        hp = hparams
        return log_mel_batch(wav, sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
                             hop_size=hp["hop_size"], win_size=hp["win_size"],
                             num_mels=hp["audio_num_mel_bins"], fmin=float(hp["fmin"]),
                             fmax=float(hp["fmax"]))

    def _generate(self, b, generator):
        self.vocoder_calls += 1
        return self.model(b["mels"], b["f0"] if hparams["use_pitch_embed"] else None,
                          generator=generator, zero_noise=self.zero_noise)

    @span("update.gen")
    def gen_step(self, b, lr: float, generator):
        """Mel L1 + adversarial (+ feature matching) losses of the generator
        and its update; the discriminators take no gradient. Returns
        (losses, detached output)."""
        hp = hparams
        self.model.train()
        y_hat = self._generate(b, generator)
        with torch.no_grad():
            mel_ref = self._mel_fn(b["wavs"])
        losses = {"mel": ddp.global_mean((self._mel_fn(y_hat) - mel_ref).abs())
                  * hp.get("lambda_mel", 5.0)}
        with no_grad_for(self.disc_params):
            fake = [(k, d(y_hat)) for k, d in self._discs()]
            lam_adv = hp.get("lambda_adv", 1.0)
            for k, (out, _) in fake:
                losses[f"a_{k}"] = self._adv(generator_loss(out), out) * lam_adv
            if hp.get("use_fm_loss", False):
                with torch.no_grad():
                    real = [d(b["wavs"])[1] for _, d in self._discs()]
                fm = [feature_loss(r, f) for r, (_, (_, f)) in zip(real, fake)]
                losses["fm"] = functools.reduce(operator.add, fm)
        self.update("gen", self.opt_gen, self.gen_params, sum(losses.values()), lr,
                    hp.get("generator_grad_norm", 10))
        return losses, y_hat.detach()

    @span("update.disc")
    def disc_step(self, b, y_hat, lr: float):
        """LSGAN losses of both discriminators on real and generated audio
        and their update."""
        outs = [(k, d(b["wavs"])[0], d(y_hat)[0]) for k, d in self._discs()]
        losses = {}
        for k, real, fake in outs:
            r, f = discriminator_loss(real, fake)
            losses[f"r_{k}"], losses[f"f_{k}"] = self._adv(r, real), self._adv(f, fake)
        self.update("disc", self.opt_disc, self.disc_params, sum(losses.values()), lr,
                    hparams.get("discriminator_grad_norm", 1))
        return losses

    def _training_step(self, batch, step: int, optimizer_idx: int):
        """(total loss, logs) of optimizer ``optimizer_idx`` at ``step``, or
        None when it is idle."""
        if optimizer_idx == 0:
            b = self._prep_batch(batch)
            lr = self.sched_gen(step)
            losses, y_hat = self.gen_step(b, lr, step_generator(self.seed, step, self.device))
            self._pending = (b, y_hat)
            return sum(losses.values()), dict(losses, lr_0=lr)
        if optimizer_idx == 1 and self._pending is not None:
            b, y_hat = self._pending
            self._pending = None
            if step <= hparams.get("disc_start_steps", 0):
                return None
            lr = self.sched_disc(step)
            losses = self.disc_step(b, y_hat, lr)
            return sum(losses.values()), dict(losses, lr_1=lr)
        return None

    @torch.no_grad()
    def validation_step(self, batch, batch_idx: int):
        self.model.eval()
        b = self._prep_batch(batch)
        y_hat = self._generate(b, self.generator)
        mel_l1 = float((self._mel_fn(y_hat) - self._mel_fn(b["wavs"])).abs().mean())
        return {"losses": {"mel": mel_l1}, "total_loss": mel_l1,
                "nsamples": batch["nsamples"]}

    # ------------------------------------------------------------------
    def train_dataloader(self):
        ds = VocoderDataset(hparams["train_set_name"], shuffle=True)
        return self.build_dataloader(ds, True, None, hparams.get("max_sentences", 24),
                                     endless=hparams["endless_ds"], use_batch_by_size=False,
                                     n_devices=self.n_devices)

    def val_dataloader(self):
        ds = VocoderDataset(hparams["valid_set_name"], shuffle=False)
        return self.build_dataloader(ds, False, None, 1, use_batch_by_size=False)


class PWGTask(HifiGanTask):
    """Parallel WaveGAN vocoder training; port of ``PWGTask`` of
    ``neuralsvb_tpu/tasks/vocoder_task.py``.

    The generator step's loss is the multi-resolution STFT loss
    (``stft_loss_scales`` or the reference's three resolutions: ``sc``,
    ``mag``) plus ``lambda_adv * mse(D(y_hat), 1)`` (``a``). As in the JAX
    package the adversarial term is there from step 0, against a
    discriminator that trains only once the step exceeds
    ``disc_start_steps``; its step is ``mse(D(y), 1) + mse(D(y_hat), 0)``
    (``r``, ``f``). The mel is edge-padded by the top-level
    ``aux_context_window`` and the noise ``z ~ N(0, 1)`` of the crop's length
    comes from the step's ``torch.Generator``. Both optimizers are optax's
    RAdam (``training/optim.py``), or Adam with ``vocoder_optimizer: adam``,
    betas (0.9, 0.999), behind the optax-style clip by global norm.
    Checkpoints hold ``state_dict.model_gen`` (what ``vocoders/pwg.py``
    loads) and ``disc``."""

    @staticmethod
    def _stft_scales():
        scales = hparams.get("stft_loss_scales")
        return [tuple(s) for s in scales] if scales else DEFAULT_RESOLUTIONS

    def build_model(self):
        """Generator and discriminator from the seed, on the device. The
        generator reads ``generator_params.upsample_scales`` and the
        top-level ``aux_context_window``, the keys of the JAX ``PWGTask``."""
        from ..models.pwg import ParallelWaveGANDiscriminator, ParallelWaveGANGenerator
        hp = hparams
        gp = hp.get("generator_params") or {}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.model = ParallelWaveGANGenerator(
                layers=gp.get("layers", 30), stacks=gp.get("stacks", 3),
                residual_channels=gp.get("residual_channels", 64),
                gate_channels=gp.get("gate_channels", 128),
                skip_channels=gp.get("skip_channels", 64),
                aux_channels=hp["audio_num_mel_bins"],
                aux_context_window=hp.get("aux_context_window", 2),
                upsample_scales=tuple(gp.get("upsample_scales", (4, 4, 4, 2))))
            self.disc = ParallelWaveGANDiscriminator()
        if self.model.hop != hp["hop_size"]:
            raise ValueError(f"upsample_scales give hop {self.model.hop}, "
                             f"hop_size is {hp['hop_size']}")
        self.model.to(self.device)
        self.disc.to(self.device)
        return self.model

    def build_train(self):
        hp = hparams
        self.gen_params = list(self.model.parameters())
        self.disc_params = list(self.disc.parameters())
        opt = (torch.optim.Adam if hp.get("vocoder_optimizer", "radam") == "adam"
               else RAdam)
        self.opt_gen = opt(self.gen_params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.opt_disc = opt(self.disc_params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        gsp = hp.get("generator_scheduler_params") or {"step_size": 200000, "gamma": 0.5}
        dsp = hp.get("discriminator_scheduler_params") or gsp
        self.sched_gen = step_lr_schedule(
            (hp.get("generator_optimizer_params") or {}).get("lr", 1e-4),
            gsp["step_size"], gsp["gamma"])
        self.sched_disc = step_lr_schedule(
            (hp.get("discriminator_optimizer_params") or {}).get("lr", 5e-5),
            dsp["step_size"], dsp["gamma"])

    def checkpoint_state(self) -> dict:
        return {"state_dict": {"model_gen": self.model.state_dict(),
                               "disc": self.disc.state_dict()},
                "optimizer_states": [self.opt_gen.state_dict(), self.opt_disc.state_dict()]}

    def load_checkpoint_state(self, ckpt: dict):
        sd = ckpt["state_dict"]
        self.model.load_state_dict(sd["model_gen"])
        self.disc.load_state_dict(sd["disc"])
        for opt, st in zip((self.opt_gen, self.opt_disc), ckpt.get("optimizer_states") or []):
            opt.load_state_dict(st)

    # ------------------------------------------------------------------
    def noise(self, wavs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """z ~ N(0, 1) [B, 1, N] for the crops ``wavs`` [B, N] (a
        data-parallel step's rows of the global batch's draw)."""
        return ddp.draw_rows(lambda s: torch.randn(s, generator=generator, device=self.device,
                                                   dtype=wavs.dtype),
                             (wavs.shape[0], 1, wavs.shape[1]))

    def _generate(self, b, generator):
        self.vocoder_calls += 1
        ctx = self.model.aux_context_window
        c = F.pad(b["mels"].transpose(1, 2), (ctx, ctx), mode="replicate")
        return self.model(self.noise(b["wavs"], generator), c)

    @span("update.gen")
    def gen_step(self, b, lr: float, generator):
        hp = hparams
        self.model.train()
        y_hat = self._generate(b, generator)
        sc, mag = multi_resolution_stft_loss(y_hat, b["wavs"], self._stft_scales())
        losses = {"sc": sc, "mag": mag}
        with no_grad_for(self.disc_params):
            losses["a"] = mse(self.disc(y_hat), 1.0) * hp.get("lambda_adv", 4.0)
        self.update("gen", self.opt_gen, self.gen_params, sum(losses.values()), lr,
                    hp.get("generator_grad_norm", 10))
        return losses, y_hat.detach()

    @span("update.disc")
    def disc_step(self, b, y_hat, lr: float):
        losses = {"r": mse(self.disc(b["wavs"]), 1.0), "f": mse(self.disc(y_hat), 0.0)}
        self.update("disc", self.opt_disc, self.disc_params, sum(losses.values()), lr,
                    hparams.get("discriminator_grad_norm", 1))
        return losses

    @torch.no_grad()
    def validation_step(self, batch, batch_idx: int):
        self.model.eval()
        b = self._prep_batch(batch)
        y_hat = self._generate(b, self.generator)
        sc, mag = multi_resolution_stft_loss(y_hat, b["wavs"], self._stft_scales())
        losses = {"sc": float(sc), "mag": float(mag)}
        return {"losses": losses, "total_loss": sum(losses.values()),
                "nsamples": batch["nsamples"]}


class BigVGANTask(HifiGanTask):
    """BigVGAN-v2 vocoder training (``BigVGANGenerator`` with its AMP
    blocks, ``MultiPeriodDiscriminator`` over ``mpd_reshapes`` and
    ``MultiResolutionDiscriminator`` over ``resolutions``).

    ``HifiGanTask``'s steps, spans, Adams, clips and crop loader with the
    multi-scale discriminator replaced by the MRD: the generator's loss is
    the mel L1 (x ``lambda_mel``) plus, per discriminator, the LSGAN loss
    and feature matching (``use_fm_loss``), each summed over its
    sub-discriminators as BigVGAN's ``loss.py`` sums them (``a_p``, ``a_r``,
    ``fm``); the discriminators' step gives ``r_p``, ``f_p``, ``r_r``,
    ``f_r``. The generator is conditioned on the mel alone (no NSF
    source). Checkpoints hold ``model_gen``, ``mpd`` and ``mrd``."""

    DISCS = (("p", "mpd"), ("r", "mrd"))

    @staticmethod
    def _adv(loss, outs):
        """Summed over the sub-discriminators, as BigVGAN's ``loss.py``
        sums them."""
        return loss * len(outs)

    def build_model(self):
        """Generator and both discriminators from the seed, on the device;
        the generator's convolutions start at BigVGAN's N(0, 0.01) init
        (``conv_pre`` keeps PyTorch's)."""
        hp = hparams
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.model = BigVGANGenerator(
                num_mels=hp["audio_num_mel_bins"],
                upsample_rates=tuple(hp["upsample_rates"]),
                upsample_kernel_sizes=tuple(hp["upsample_kernel_sizes"]),
                upsample_initial_channel=hp["upsample_initial_channel"],
                resblock_kernel_sizes=tuple(hp["resblock_kernel_sizes"]),
                resblock_dilation_sizes=tuple(tuple(d) for d in hp["resblock_dilation_sizes"]))
            for name, m in self.model.named_modules():
                if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)) \
                        and name != "conv_pre":
                    torch.nn.init.normal_(m.weight, 0.0, 0.01)
            self.mpd = MultiPeriodDiscriminator(tuple(hp.get("mpd_reshapes", (2, 3, 5, 7, 11))))
            self.mrd = MultiResolutionDiscriminator(tuple(tuple(r) for r in hp["resolutions"]))
        if self.model.hop != hp["hop_size"]:
            raise ValueError(f"upsample_rates give hop {self.model.hop}, "
                             f"hop_size is {hp['hop_size']}")
        for m in (self.model, self.mpd, self.mrd):
            m.to(self.device)
        return self.model

    def _generate(self, b, generator):
        self.vocoder_calls += 1
        return self.model(b["mels"])
