"""Mel reconstruction and adversarial losses of the SVB training steps; port
of ``neuralsvb_tpu/tasks/svb_vae_task.py:49-98`` (reference:
svb_vae_task.py:665-672, tts.py:127-131, fs2.py:34-44). Mels are
``[B, T, 80]``; padded frames are all-zero and carry no weight."""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.ssim import ssim
from ..parallel import ddp


def nan_guard(x: torch.Tensor) -> torch.Tensor:
    """A non-finite loss keeps its value but passes no gradient."""
    return torch.where(torch.isfinite(x), x, x.detach())


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at exactly 0 is 1, as ``jnp.abs``'s (torch's is
    0). An unmasked L1 over zero-padded frames of a model with zero biases
    (flax's init) meets exact zeros."""
    return torch.where(x >= 0, x, -x)


def weights_nonzero_speech(target: torch.Tensor) -> torch.Tensor:
    """[B, T, 80] -> same-shape 0/1 weights of the nonzero frames."""
    w = (target.abs().sum(-1, keepdim=True) > 0).to(target.dtype)
    return w.expand_as(target)


# every masked mean divides by the global batch's weight in a data-parallel
# step (``ddp.all_sum`` is the identity otherwise)
def l1_mel_loss(out, target):
    w = weights_nonzero_speech(target)
    return ddp.all_sum(((out - target).abs() * w).sum()) / ddp.all_sum(w.sum())


def ssim_mel_loss(out, target, bias: float = 6.0):
    w = weights_nonzero_speech(target)
    s = ssim(out[:, None] + bias, target[:, None] + bias, size_average=False)
    return ddp.all_sum(((1 - s) * w).sum()) / ddp.all_sum(w.sum())


def parse_mel_losses(spec: str) -> Dict[str, float]:
    """'ssim:0.5|l1:0.5' -> {'ssim': 0.5, 'l1': 0.5}."""
    out = {}
    for part in spec.split("|"):
        if not part:
            continue
        name, _, lbd = part.partition(":")
        out[name] = float(lbd) if lbd else 1.0
    return out


MEL_LOSSES = {"l1": l1_mel_loss, "ssim": ssim_mel_loss}


def add_mel_loss(loss_and_lambda: Dict[str, float], out, target,
                 losses: Dict[str, torch.Tensor], postfix: str = "") -> None:
    for name, lbd in loss_and_lambda.items():
        if name not in MEL_LOSSES:
            raise NotImplementedError(f"mel loss {name!r}")
        losses[f"{name}{postfix}"] = MEL_LOSSES[name](out, target) * lbd


def mse(x: torch.Tensor, target_value: float) -> torch.Tensor:
    return ddp.global_mean((x - target_value) ** 2)
