"""k-diffusion sigma-parameterization wrapper (``uwudiff_tpu/sampling/wrapper.py``).

An eps-predicting discrete-schedule model is driven in continuous sigma
space via ``c_in = 1/sqrt(sigma^2+1)``, ``c_out = -sigma`` and the
log-linear sigma<->t interpolation of :class:`NoiseSchedule`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.utils import append_dims

__all__ = ["KDiffusionDenoiser", "to_d", "get_ancestral_step"]


def to_d(x, sigma, denoised):
    """Karras ODE derivative; ``sigma`` is a number or a [B] tensor."""
    if isinstance(sigma, (int, float, np.floating)):
        return (x - denoised) / float(sigma)
    return (x - denoised) / append_dims(sigma, x.dim())


def get_ancestral_step(sigma, sigma_next, eta: float = 1.0):
    """Ancestral split of a step into (sigma_down, sigma_up) for host
    scalars, in fp32 as the JAX package computes it; safe at
    ``sigma_next == 0``."""
    f = np.float32
    sigma, sigma_next = f(sigma), f(sigma_next)
    var = sigma_next**2 * (sigma**2 - sigma_next**2) / max(sigma**2, f(1e-20))
    sigma_up = min(sigma_next, f(eta) * f(math.sqrt(max(var, f(0.0)))))
    sigma_down = f(math.sqrt(max(sigma_next**2 - sigma_up**2, f(0.0))))
    return sigma_down, sigma_up


@dataclasses.dataclass(frozen=True)
class KDiffusionDenoiser:
    """``model_fn(x_scaled, t, **kwargs) -> eps``; calling returns the
    denoised sample ``x + eps * c_out`` (sigma_data = 1; the inversion
    mode's ``sigma_cond`` comes with the samplers that use it)."""

    model_fn: Callable
    schedule: NoiseSchedule

    def __call__(self, x, sigma, **kwargs):
        c_out, c_in = -sigma, 1.0 / (sigma**2 + 1.0).sqrt()
        t = self.schedule.sigma_to_t(sigma)
        eps = self.model_fn(x * append_dims(c_in, x.dim()), t, **kwargs)
        return x + eps * append_dims(c_out, x.dim())
