"""Optimizers with optax's arithmetic where ``torch.optim`` differs.

``RAdam`` is ``optax.scale_by_radam`` followed by the step ``-lr * u``, the
rule of the JAX package's ``PWGTask`` (``neuralsvb_tpu/tasks/vocoder_task.py``,
after ``clip_by_global_norm``). ``torch.optim.RAdam`` is not the same
function: it adds ``eps`` to ``sqrt(v)`` before the bias correction (so
``eps / sqrt(1 - b2^t)`` sits on ``sqrt(v_hat)``), and it rectifies when
``rho_t > 5`` where optax does when ``rho_t >= 5``. With ``b2 = 0.999``,
``rho_t`` first reaches 5 at step 6 (4.996 at step 5, 5.994 at step 6).

``MultiSteps`` is ``optax.MultiSteps`` (gradient accumulation,
``accumulate_grad_batches``) in front of any of the port's optimizer chains.
"""

from __future__ import annotations

import numpy as np
import torch

RHO_THRESHOLD = 5.0  # optax's default: rectify when rho_t >= 5


class MultiSteps:
    """``optax.MultiSteps(chain, every_k_schedule=k)`` with optax's default
    ``use_grad_mean``: the gradients of ``k`` micro-steps are averaged as a
    running mean (``acc += (g - acc) / (n + 1)``, optax's Welford update),
    and the inner chain (clip, Adam, decoupled decay) runs once, on the
    mean, at the k-th micro-step. Between, it emits no update: the caller
    skips the optimizer's step, so parameters and the Adam count stay as
    they are (a torch ``AdamW.step()`` on a zero gradient would still decay
    the weights and advance the count)."""

    def __init__(self, params, every_k: int):
        self.every_k = int(every_k)
        self.params = list(params)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def accumulate(self) -> bool:
        """Fold the parameters' ``.grad`` into the running mean. At the k-th
        micro-step the mean replaces ``.grad`` and the state resets: returns
        True, the chain's turn to step."""
        n = self.mini_step
        grads = [p.grad for p in self.params]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(self.acc, delta)
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return False
        torch._foreach_copy_(grads, self.acc)
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, st: dict) -> None:
        self.mini_step = int(st["mini_step"])
        with torch.no_grad():
            for a, b in zip(self.acc, st["acc"]):
                a.copy_(b)


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as optax computes it, without weight decay.

    Per step t (from 1): ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
    ``m_hat = m / (1 - b1^t)``, ``v_hat = v / (1 - b2^t)``,
    ``rho = rho_inf - 2 t b2^t / (1 - b2^t)``; the update is
    ``r m_hat / (sqrt(v_hat) + eps)`` with optax's rectification ``r`` when
    ``rho >= RHO_THRESHOLD``, else ``m_hat``; the parameter moves by ``-lr``
    times it."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            # one count per group: an optax chain steps every leaf together
            t = self.state[params[0]]["step"] + 1
            for p in params:
                self.state[p]["step"] = t
            grads = [p.grad for p in params]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_lerp_(m, grads, 1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            # the step's scalars in float32, as optax computes them: near
            # t = 1, 1 - b2^t loses digits, and float64 would move the
            # update by about 1e-4 of itself
            t32, one = np.float32(t), np.float32(1.0)
            b2t = np.float32(b2) ** t32
            bc1, bc2 = one - np.float32(b1) ** t32, one - b2t
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            rho = np.float32(rho_inf - 2 * t32 * b2t / bc2)
            lr = group["lr"]
            if rho >= RHO_THRESHOLD:
                r = np.sqrt(np.float32((rho - 4.0) * (rho - 2.0) * rho_inf
                                       / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho)))
                denom = torch._foreach_div(v, float(bc2))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_addcdiv_(params, m, denom, value=-lr * float(r) / float(bc1))
            else:
                torch._foreach_add_(params, m, alpha=-lr / float(bc1))
        return None
