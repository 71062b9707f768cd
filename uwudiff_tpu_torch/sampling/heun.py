"""Heun sampler (``uwudiff_tpu/sampling/heun.py``): k-diffusion's
``sample_heun``, an Euler predictor and a trapezoidal corrector (two model
calls a step, one on the final step to sigma = 0), with Karras churn.
Host-side ladder and branches, as in ``sampling/euler.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from uwudiff_tpu_torch.sampling.dpm2 import _churn, churn_noise
from uwudiff_tpu_torch.sampling.noise import noise_source
from uwudiff_tpu_torch.sampling.wrapper import host_sigmas, to_d

__all__ = ["sample_heun"]


def sample_heun(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    s_noise: float = 1.0,
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    del image_to_noise
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    n_steps = len(sigmas) - 1
    s_in = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        sigma_hat = _churn(sigma, n_steps, s_churn, s_tmin, s_tmax)
        x = churn_noise(x, noise, sigma, sigma_hat, s_noise)
        denoised, _ = model(x, s_in * float(sigma_hat))
        d = to_d(x, sigma_hat, denoised)
        dt = float(sigma_next - sigma_hat)
        x_euler = x + d * dt
        if sigma_next == 0:
            x = x_euler
            continue
        denoised_2, _ = model(x_euler, s_in * float(sigma_next))
        x = x + (d + to_d(x_euler, sigma_next, denoised_2)) / 2 * dt
    return x
