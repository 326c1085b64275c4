"""One HiFiGAN-NSF training step in plain PyTorch: the reference that the
``fit_loop`` kind holds the program's first steps against.

The step of the configuration (``HifiGanTask`` of the port, the reference
recipe's ``hifigan_nsf.yaml``): the generator's update on the L1 of the
log-mels (x ``lambda_mel``) and the LSGAN losses of the multi-period and
multi-scale discriminators (x ``lambda_adv``), the discriminators frozen;
then, past ``disc_start_steps``, the discriminators' update on the real
crops and the detached generated ones. Each update: gradients clipped by
their global norm (scaled by max / norm only when norm > max), then Adam
at the StepLR rate of the step. The NSF draws of step s come from a
generator seeded by ``SeedSequence([seed + 1, s])``, the program's rule."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .hifigan import (HifiGanGenerator, MultiPeriodDiscriminator, MultiScaleDiscriminator,
                      discriminator_loss, generator_loss)
from .mel import log_mel_batch


def step_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed + 1, step]).generate_state(1)[0]))
    return g


def clip_by_global_norm(params: List[torch.Tensor], max_norm: float) -> None:
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class HifiGanStep:
    """The generator and both discriminators with their two Adams; call
    ``step(batch, s)`` with a collated batch (numpy ``wavs``, ``mels``,
    ``f0``) at step ``s``."""

    def __init__(self, hp: dict, gen_kwargs: dict, device):
        self.hp, self.device = hp, device
        self.seed = int(hp["seed"])
        self.gen = HifiGanGenerator(**gen_kwargs).to(device)
        self.mpd = MultiPeriodDiscriminator().to(device)
        self.msd = MultiScaleDiscriminator().to(device)
        b = (hp["adam_b1"], hp["adam_b2"])
        self.gen_params = list(self.gen.parameters())
        self.disc_params = list(self.mpd.parameters()) + list(self.msd.parameters())
        self.opt_gen = torch.optim.Adam(self.gen_params, lr=0.0, betas=b, eps=1e-8)
        self.opt_disc = torch.optim.Adam(self.disc_params, lr=0.0, betas=b, eps=1e-8)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"gen": self.gen, "mpd": self.mpd, "msd": self.msd}

    def restart_draws(self, steps: int, batch) -> None:
        """Nothing to do: a step's draws come from its step number alone."""

    def _lr(self, which: str, step: int) -> float:
        hp = self.hp
        gsp = hp["generator_scheduler_params"]
        sp = gsp if which == "gen" else (hp.get("discriminator_scheduler_params") or gsp)
        lr = hp[f"{'generator' if which == 'gen' else 'discriminator'}_optimizer_params"]["lr"]
        return lr * sp["gamma"] ** (max(step, 0) // sp["step_size"])

    def _mel(self, wav):
        hp = self.hp
        return log_mel_batch(wav, sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
                             hop_size=hp["hop_size"], win_size=hp["win_size"],
                             num_mels=hp["audio_num_mel_bins"], fmin=float(hp["fmin"]),
                             fmax=float(hp["fmax"]))

    @staticmethod
    def _update(opt, params, total, lr, max_norm):
        opt.zero_grad(set_to_none=True)
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if max_norm > 0:
            clip_by_global_norm(params, float(max_norm))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    def step(self, batch, step: int) -> Dict[str, float]:
        hp, dev = self.hp, self.device
        b = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32, device=dev)
             for k in ("wavs", "mels", "f0")}
        g = step_generator(self.seed, step, dev)
        self.gen.train()
        y_hat = self.gen(b["mels"], b["f0"], generator=g)
        with torch.no_grad():
            mel_ref = self._mel(b["wavs"])
        losses = {"mel": (self._mel(y_hat) - mel_ref).abs().mean() * hp["lambda_mel"]}
        for p in self.disc_params:
            p.requires_grad_(False)
        losses["a_p"] = generator_loss(self.mpd(y_hat)[0]) * hp["lambda_adv"]
        losses["a_s"] = generator_loss(self.msd(y_hat)[0]) * hp["lambda_adv"]
        for p in self.disc_params:
            p.requires_grad_(True)
        if hp.get("use_fm_loss"):
            raise NotImplementedError("use_fm_loss: the configuration runs without it")
        total0 = sum(losses.values())
        self._update(self.opt_gen, self.gen_params, total0, self._lr("gen", step),
                     hp["generator_grad_norm"])
        out = {"total_loss_0": float(total0.detach())}
        if step > hp["disc_start_steps"]:
            y = y_hat.detach()
            rp, fp = discriminator_loss(self.mpd(b["wavs"])[0], self.mpd(y)[0])
            rs, fs = discriminator_loss(self.msd(b["wavs"])[0], self.msd(y)[0])
            total1 = rp + fp + rs + fs
            self._update(self.opt_disc, self.disc_params, total1, self._lr("disc", step),
                         hp["discriminator_grad_norm"])
            out["total_loss_1"] = float(total1.detach())
        return out
