"""One BigVGAN-v2 training step in plain PyTorch: the reference that the
``fit_loop_bigvgan`` kind holds the program's first steps against.

The step of the configuration (``BigVGANTask`` of the port): the
generator's update on the L1 of the log-mels (x ``lambda_mel``), the LSGAN
losses of the multi-period and multi-resolution discriminators (x
``lambda_adv``) and their feature matching, each summed over the
sub-discriminators, the discriminators frozen; then the discriminators'
update on the real crops and the detached generated ones (both train from
step 0). Each update: gradients clipped by their global norm (scaled by
max / norm only when norm > max), then Adam at the step's rate
(``lr x gamma ** (step // step_size)``). The generator draws nothing."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .bigvgan import (BigVGAN, MultiPeriodDiscriminator, MultiResolutionDiscriminator,
                      discriminator_loss, feature_loss, generator_loss)
from .mel import log_mel_batch
from .vocoder_step import clip_by_global_norm


class BigVGANStep:
    """The generator, MPD and MRD with their two Adams; call
    ``step(batch, s)`` with a collated batch (numpy ``wavs``, ``mels``) at
    step ``s``."""

    def __init__(self, hp: dict, gen_kwargs: dict, device):
        self.hp, self.device = hp, device
        self.generator = BigVGAN(**gen_kwargs).to(device)
        self.mpd = MultiPeriodDiscriminator(tuple(hp["mpd_reshapes"])).to(device)
        self.mrd = MultiResolutionDiscriminator(
            tuple(tuple(r) for r in hp["resolutions"])).to(device)
        b = (hp["adam_b1"], hp["adam_b2"])
        self.gen_params = list(self.generator.parameters())
        self.disc_params = list(self.mpd.parameters()) + list(self.mrd.parameters())
        self.opt_gen = torch.optim.Adam(self.gen_params, lr=0.0, betas=b, eps=1e-8)
        self.opt_disc = torch.optim.Adam(self.disc_params, lr=0.0, betas=b, eps=1e-8)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"gen": self.generator, "mpd": self.mpd, "mrd": self.mrd}

    def restart_draws(self, steps: int, batch) -> None:
        """Nothing to do: the step draws nothing."""

    def _lr(self, which: str, step: int) -> float:
        hp = self.hp
        name = "generator" if which == "gen" else "discriminator"
        sp = hp[f"{name}_scheduler_params"]
        return hp[f"{name}_optimizer_params"]["lr"] * sp["gamma"] ** (max(step, 0)
                                                                      // sp["step_size"])

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
             for k in ("wavs", "mels")}
        discs = (self.mpd, self.mrd)
        self.generator.train()
        y_hat = self.generator(b["mels"])
        with torch.no_grad():
            mel_ref = self._mel(b["wavs"])
        total0 = (self._mel(y_hat) - mel_ref).abs().mean() * hp["lambda_mel"]
        for p in self.disc_params:
            p.requires_grad_(False)
        fake = [d(y_hat) for d in discs]
        for out, _ in fake:
            total0 = total0 + generator_loss(out) * hp["lambda_adv"]
        if hp.get("use_fm_loss"):
            with torch.no_grad():
                real = [d(b["wavs"])[1] for d in discs]
            for r, (_, f) in zip(real, fake):
                total0 = total0 + feature_loss(r, f)
        for p in self.disc_params:
            p.requires_grad_(True)
        self._update(self.opt_gen, self.gen_params, total0, self._lr("gen", step),
                     hp["generator_grad_norm"])
        out = {"total_loss_0": float(total0.detach())}
        if step > hp["disc_start_steps"]:
            y = y_hat.detach()
            total1 = 0
            for d in discs:
                r, f = discriminator_loss(d(b["wavs"])[0], d(y)[0])
                total1 = total1 + r + f
            self._update(self.opt_disc, self.disc_params, total1, self._lr("disc", step),
                         hp["discriminator_grad_norm"])
            out["total_loss_1"] = float(total1.detach())
        return out
