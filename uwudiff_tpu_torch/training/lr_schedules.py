"""LR schedules (``uwudiff_tpu/training/lr_schedules.py``).

``GradualWarmupScheduler(multiplier=1)`` into ``CosineAnnealingLR``,
stepped per batch, as ``step -> lr`` callables. The step lives on the
host; the arithmetic is fp32, as the JAX package's, so both give the
same learning rate to fp32 rounding.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cosine_annealing", "gradual_warmup", "warmup_cosine_schedule"]


def cosine_annealing(base_lr: float, T_max: int, eta_min: float = 0.0):
    """torch ``CosineAnnealingLR``: eta_min + (base-eta_min) * (1+cos(pi*t/T_max))/2."""

    def schedule(step) -> float:
        t = np.float32(step)
        cos = np.cos(np.float32(np.pi) * t / np.float32(T_max))
        return float(np.float32(eta_min) + np.float32(base_lr - eta_min) * (np.float32(1) + cos) / np.float32(2))

    return schedule


def gradual_warmup(base_lr: float, warm_up_period: int, after=None):
    """Linear 0 -> base_lr over ``warm_up_period`` steps, then ``after``
    (shifted so that it starts at 0)."""

    def schedule(step) -> float:
        step = np.float32(step)
        if step <= warm_up_period:
            return float(np.float32(base_lr) * min(step, np.float32(warm_up_period)) / np.float32(warm_up_period))
        return base_lr if after is None else after(step - warm_up_period)

    return schedule


def warmup_cosine_schedule(
    base_lr: float,
    warm_up_period: int = 1000,
    T_max: int = 100_000,
    eta_min: float = 1e-7,
    use_warm_up: bool = True,
):
    """The trainer default: warmup into cosine annealing."""
    after = cosine_annealing(base_lr, T_max, eta_min)
    if not use_warm_up:
        return after
    return gradual_warmup(base_lr, warm_up_period, after)
