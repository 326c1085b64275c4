"""Learning-rate schedules as plain Python floats of the step; port of
``neuralsvb_tpu/training/schedulers.py`` (reference:
utils/common_schedulers.py:4-51 and torch's StepLR)."""

from __future__ import annotations


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int):
    """Linear warmup, then rsqrt decay, times hidden^-0.5; floored at 1e-7."""
    def fn(step) -> float:
        step = max(float(step), 0.0)
        warmup = min(step / warmup_updates, 1.0)
        rsqrt_decay = max(float(warmup_updates), step) ** -0.5
        return max(lr * warmup * rsqrt_decay * hidden_size ** -0.5, 1e-7)
    return fn


def step_lr_schedule(lr: float, step_size: int, gamma: float):
    """torch StepLR: lr * gamma ** (step // step_size)."""
    def fn(step) -> float:
        return lr * gamma ** (max(int(step), 0) // step_size)
    return fn
