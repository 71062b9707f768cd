"""DPM-Solver-2 samplers (``uwudiff_tpu/sampling/dpm2.py``): the log-space
sigma midpoint, Karras churn (``s_churn``/``s_tmin``/``s_tmax``/``s_noise``),
``single_call`` (the previous step's second-stage derivative stands in for
a fresh first-stage model call) and the CFG++ variant. The final step to
sigma = 0 is one Euler step. Host-side ladder and branches, as in
``sampling/euler.py``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.sampling.noise import noise_source
from uwudiff_tpu_torch.sampling.wrapper import host_sigmas, to_d

__all__ = ["sample_dpm2", "sample_dpm2_cfgpp"]

f32 = np.float32


def _churn(sigma, n_steps, s_churn, s_tmin, s_tmax) -> np.float32:
    """Karras's churned sigma_hat = sigma * (1 + gamma), in fp32."""
    in_window = f32(s_tmin) <= sigma <= f32(s_tmax)
    gamma = f32(min(s_churn / n_steps, 2**0.5 - 1)) if in_window else f32(0.0)
    return f32(sigma * (gamma + f32(1.0)))


def churn_noise(x, noise, sigma, sigma_hat, s_noise):
    """Raise x from sigma to sigma_hat with a draw over (sigma, sigma_hat);
    no draw when the churn is off."""
    up = f32(math.sqrt(max(sigma_hat**2 - sigma**2, f32(0.0))))
    if up == 0:
        return x
    return x + (noise(x.shape, sigma, sigma_hat) * float(s_noise)) * float(up)


def _log_midpoint(sigma_hat, sigma_next) -> np.float32:
    return np.exp((np.log(sigma_hat) + np.log(max(sigma_next, f32(1e-20)))) / f32(2.0))


def sample_dpm2(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    s_noise: float = 1.0,
    single_call: bool = False,
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    del image_to_noise
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    n_steps = len(sigmas) - 1
    s_in = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    d_cached = None
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        sigma_hat = _churn(sigma, n_steps, s_churn, s_tmin, s_tmax)
        x = churn_noise(x, noise, sigma, sigma_hat, s_noise)
        if sigma_next == 0:  # the last step: Euler
            denoised, _ = model(x, s_in * float(sigma_hat))
            x = x + to_d(x, sigma_hat, denoised) * float(sigma_next - sigma_hat)
            continue
        if single_call and d_cached is not None:
            d = d_cached
        else:
            denoised, _ = model(x, s_in * float(sigma_hat))
            d = to_d(x, sigma_hat, denoised)
        sigma_mid = _log_midpoint(sigma_hat, sigma_next)
        x_2 = x + d * float(sigma_mid - sigma_hat)
        denoised_2, _ = model(x_2, s_in * float(sigma_mid))
        d_cached = to_d(x_2, sigma_mid, denoised_2)
        x = x + d_cached * float(sigma_next - sigma_hat)
    return x


def sample_dpm2_cfgpp(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    s_churn: float = 0.0,
    s_tmin: float = 0.0,
    s_tmax: float = float("inf"),
    s_noise: float = 1.0,
    single_call: bool = False,
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    """CFG++ DPM-2: each stage anchors on the guided estimate and steps with
    the unconditional derivative; the last step returns the guided
    estimate."""
    del image_to_noise
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    n_steps = len(sigmas) - 1
    s_in = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    cached = None
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        sigma_hat = _churn(sigma, n_steps, s_churn, s_tmin, s_tmax)
        x = churn_noise(x, noise, sigma, sigma_hat, s_noise)
        if sigma_next == 0:
            x, _ = model(x, s_in * float(sigma_hat))
            continue
        if single_call and cached is not None:
            cfg_denoised, uncond_d = cached
        else:
            cfg_denoised, uncond = model(x, s_in * float(sigma_hat))
            uncond_d = to_d(x, sigma_hat, uncond)
        sigma_mid = _log_midpoint(sigma_hat, sigma_next)
        x_2 = cfg_denoised + uncond_d * float(sigma_mid)
        cfg_denoised_2, uncond_2 = model(x_2, s_in * float(sigma_mid))
        uncond_d_2 = to_d(x_2, sigma_mid, uncond_2)
        x = cfg_denoised_2 + uncond_d_2 * float(sigma_next)
        cached = (cfg_denoised_2, uncond_d_2)
    return x
