"""One phase-2 training step of the flagship (``SVBVAEMleTask``, the
reference recipe's ``vae_global_mle_eng.yaml``) in plain PyTorch: the
reference that the ``fit_loop`` kind holds the program's first steps
against.

The generator update on the ways of phase 2 (a2a, p2p): per way the KL
(x ``lambda_kl``) and the mel losses of ``mel_loss`` against that side's
mel, plus, once the discriminator is on, its LSGAN loss toward 1 (x
``lambda_mel_adv``) with the discriminator frozen and in eval mode; then
the multi-window discriminator's update on the side's real mel (toward 1)
and the detached generated one (toward 0), in training mode. Each update:
gradients clipped by value (``clip_grad_value``) and by their global norm,
then AdamW at the step's rate (rsqrt warm-up for the generator, StepLR
after ``disc_start_steps`` for the discriminator). The frozen ASR never
trains and its content rows come from a cache computed per item at its
exact length. The step's draws (the FVAE's samples, the windows and the
dropout of the discriminator) come from a generator seeded by
``SeedSequence([seed + 1, step])``; the speaker-embedding column of a batch
from ``RandomState(seed)``, one draw per step: the program's rules."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .disc import Discriminator
from .ssim import ssim
from .svb_vae import SVBVAE
from .vocoder_step import step_generator


def _weights(target):
    return (target.abs().sum(-1, keepdim=True) > 0).to(target.dtype).expand_as(target)


def l1_mel_loss(out, target):
    w = _weights(target)
    return ((out - target).abs() * w).sum() / w.sum()


def ssim_mel_loss(out, target, bias: float = 6.0):
    w = _weights(target)
    s = ssim(out[:, None] + bias, target[:, None] + bias, size_average=False)
    return ((1 - s) * w).sum() / w.sum()


MEL_LOSSES = {"l1": l1_mel_loss, "ssim": ssim_mel_loss}


def nan_guard(x):
    return torch.where(torch.isfinite(x), x, x.detach())


class SVBStep:
    """The SVB model, its discriminator and their AdamWs; ``step(batch,
    s)`` runs step ``s`` on a collated batch (numpy), ``ppg(items)`` fills
    the content cache from the split's items."""

    def __init__(self, hp: dict, svb_kwargs: dict, device):
        self.hp, self.device = hp, device
        self.seed = int(hp["seed"])
        self.model = SVBVAE(**svb_kwargs).to(device)
        self.disc = Discriminator(time_lengths=(32, 64, 128)[: hp["disc_win_num"]],
                                  freq_length=hp["audio_num_mel_bins"],
                                  hidden_size=hp["mel_disc_hidden_size"],
                                  norm_type=hp["disc_norm"],
                                  reduction=hp["disc_reduction"]).to(device)
        self.model.requires_grad_(True)
        self.model.vc_asr.requires_grad_(False)
        skip = ("vc_asr.",) + tuple(f"{k}." for k in self.model.mapping_keys)
        self.gen_params = [p for n, p in self.model.named_parameters() if not n.startswith(skip)]
        self.disc_params = list(self.disc.parameters())
        b = (hp["optimizer_adam_beta1"], hp["optimizer_adam_beta2"])
        dp = hp.get("discriminator_optimizer_params") or {}
        self.opt_gen = torch.optim.AdamW(self.gen_params, lr=0.0, betas=b, eps=1e-8,
                                         weight_decay=hp.get("weight_decay") or 0.0)
        self.opt_disc = torch.optim.AdamW(self.disc_params, lr=0.0, betas=b,
                                          eps=dp.get("eps", 1e-8),
                                          weight_decay=dp.get("weight_decay", 0.0))
        self.losses = {}
        for part in hp["mel_loss"].split("|"):
            name, _, lbd = part.partition(":")
            self.losses[name] = float(lbd) if lbd else 1.0
        self.col_rng = np.random.RandomState(self.seed)
        self.cache = {"a": {}, "p": {}}

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"model": self.model, "mel_disc": self.disc}

    def restart_draws(self, steps: int, batch) -> None:
        """The column draws as they stand after ``steps`` steps on batches
        like ``batch`` (one draw per step)."""
        self.col_rng = np.random.RandomState(self.seed)
        for _ in range(steps):
            self.col_rng.randint(1, batch["multi_spk_emb"].shape[1])

    @torch.no_grad()
    def ppg(self, items) -> None:
        self.model.eval()
        for i, it in enumerate(items):
            for side, key in (("a", "mel"), ("p", "prof_mel")):
                mel = torch.as_tensor(it[key], device=self.device).T[None]
                self.cache[side][i] = self.model.extract_ppg(mel, True)[0]

    def _lr_gen(self, step):
        hp = self.hp
        if hp["scheduler"] != "rsqrt":
            return hp["lr"]
        s = max(float(step), 0.0)
        w = hp["warmup_updates"]
        return max(hp["lr"] * min(s / w, 1.0) * max(float(w), s) ** -0.5
                   * hp["hidden_size"] ** -0.5, 1e-7)

    def _lr_disc(self, step):
        hp = self.hp
        sp = hp.get("discriminator_scheduler_params") or {"step_size": 60000, "gamma": 0.5}
        s = max(step - hp["disc_start_steps"], 1)
        return hp["disc_lr"] * sp["gamma"] ** (s // sp["step_size"])

    def _update(self, opt, params, total, lr, max_norm):
        opt.zero_grad(set_to_none=True)
        if torch.is_tensor(total) and total.requires_grad:
            total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        cv = float(self.hp.get("clip_grad_value") or 0)
        if cv > 0:
            for p in params:
                p.grad.clamp_(-cv, cv)
        if max_norm > 0:
            grads = [p.grad for p in params]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
            for g in grads:
                g.mul_(scale)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    def _adv(self, mel, g, target):
        o = self.disc(mel, None, g)
        return None if o["y"] is None else ((o["y"] - target) ** 2).mean()

    def step(self, batch, step: int) -> Dict[str, float]:
        hp, dev = self.hp, self.device
        ways = tuple(hp["phase_2_concurrent_ways"].split(","))
        col = int(self.col_rng.randint(1, batch["multi_spk_emb"].shape[1]))

        def t(k, dt):
            return torch.as_tensor(np.asarray(batch[k]), dtype=dt, device=dev)
        b = {"mels": t("mels", torch.float32), "prof_mels": t("prof_mels", torch.float32),
             "pitch": t("pitch", torch.long), "prof_pitch": t("prof_pitch", torch.long),
             "align": t("a2p_f0_alignment", torch.long),
             "spk_emb": torch.as_tensor(np.asarray(batch["multi_spk_emb"])[:, col],
                                        dtype=torch.float32, device=dev)}
        stride = math.prod(hp["mel_strides"])
        ppg = []
        for side, key in (("a", "mels"), ("p", "prof_mels")):
            T = -(-b[key].shape[1] // stride)
            rows = torch.zeros(len(batch["id"]), hp["hidden_size"], T, device=dev)
            for i, idx in enumerate(batch["id"]):
                r = self.cache[side][int(idx)]
                rows[i, :, : r.shape[-1]] = r
            ppg.append(rows)
        g = step_generator(self.seed, step, dev)
        disc_on = bool(hp["mel_gan"] and step > hp["disc_start_steps"]
                       and hp["lambda_mel_adv"] > 0)
        # the generator's update
        self.model.train()
        self.disc.eval()
        out = self.model(b["mels"], b["prof_mels"], b["pitch"], b["prof_pitch"], b["spk_emb"],
                         b["align"], generator=g, ways=ways, ppg_a=ppg[0], ppg_p=ppg[1])
        losses = {}
        for way in ways:
            target = b["prof_mels"] if way in ("p2p", "a2p") else b["mels"]
            if "kl" in out[way]:
                losses[f"{way}_kl"] = nan_guard(out[way]["kl"]) * hp["lambda_kl"]
            for name, lbd in self.losses.items():
                losses[f"{name}{way}"] = MEL_LOSSES[name](out[way]["mel_out"], target) * lbd
        if disc_on:
            for p in self.disc_params:
                p.requires_grad_(False)
            for way in ways:
                adv = self._adv(out[way]["mel_out"], g, 1.0)
                if adv is not None:
                    losses[f"{way}_a"] = adv * hp["lambda_mel_adv"]
            for p in self.disc_params:
                p.requires_grad_(True)
        total0 = sum(losses.values())
        self._update(self.opt_gen, self.gen_params, total0, self._lr_gen(step),
                     hp.get("generator_grad_norm", 0))
        res = {"total_loss_0": float(total0.detach())}
        if disc_on and step % hp["disc_interval"] == 0:
            self.disc.train()
            dl = {}
            for way in ways:
                target = b["prof_mels"] if way in ("p2p", "a2p") else b["mels"]
                for name, mel, tv in (("r", target, 1.0),
                                      ("f", out[way]["mel_out"].detach(), 0.0)):
                    v = self._adv(mel, g, tv)
                    if v is not None:
                        dl[f"{way}_{name}"] = v
            total1 = sum(dl.values()) if dl else torch.zeros((), device=dev)
            self._update(self.opt_disc, self.disc_params, total1, self._lr_disc(step),
                         hp.get("discriminator_grad_norm", 0))
            res["total_loss_1"] = float(total1.detach())
        return res
