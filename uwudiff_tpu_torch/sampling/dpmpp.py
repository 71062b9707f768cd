"""DPM-Solver++ samplers (``uwudiff_tpu/sampling/dpmpp.py``), in log-sigma
time ``t = -ln(sigma)``:

- ``2m``: multistep second order, one model call a step (the previous
  step's estimate as history);
- ``2m_sde``: 2M with an exponentially decayed noise injection
  (``solver_type`` "midpoint" or "heun"), one call a step;
- ``2s_ancestral``: singlestep second order to the ancestral sigma_down,
  then noise up by sigma_up, two calls a step;
- ``sde``: the singlestep solver with the ancestral split at both the
  midpoint and the full step, two calls and two draws a step, over
  (sigma, sigma_mid) and (sigma, sigma_next);
- ``3m_sde``: multistep third order with two steps of history, one call
  a step.

The first step (no history) and the final step (sigma_next = 0) take the
first-order update, or return the denoised estimate, as k-diffusion does.
The JAX loops evaluate both sides of those gates and select; here the
gates are host ``if``s over the fp32 host ladder, so a gate's unused side
costs nothing: 2s_ancestral and sde make one call on the final step.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.sampling.noise import noise_source
from uwudiff_tpu_torch.sampling.wrapper import get_ancestral_step, host_sigmas, log_sigma_time, to_d

__all__ = [
    "sample_dpmpp_2m",
    "sample_dpmpp_2m_sde",
    "sample_dpmpp_2s_ancestral",
    "sample_dpmpp_3m_sde",
    "sample_dpmpp_sde",
]

f32 = np.float32


def _s_in(x):
    return torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)


def sample_dpmpp_2m(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    generator: torch.Generator | None = None,  # unused (deterministic)
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    del generator, image_to_noise
    sigmas = host_sigmas(sigmas)
    s_in = _s_in(x)
    old_denoised = None
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        denoised, _ = model(x, s_in * float(sigma))
        t = log_sigma_time(sigma)
        h = log_sigma_time(sigma_next) - t
        d = denoised
        if i > 0 and sigma_next != 0:
            r = (t - log_sigma_time(sigmas[i - 1])) / h
            d = float(f32(1.0) + f32(1.0) / (f32(2.0) * r)) * denoised - float(f32(1.0) / (f32(2.0) * r)) * old_denoised
        x = float(sigma_next / sigma) * x - float(np.expm1(-h)) * d
        old_denoised = denoised
    return x


def sample_dpmpp_2m_sde(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    eta: float = 1.0,
    s_noise: float = 1.0,
    solver_type: str = "midpoint",
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    """At ``eta = 0`` and "midpoint" this is :func:`sample_dpmpp_2m`."""
    if solver_type not in ("midpoint", "heun"):
        raise ValueError(f"solver_type {solver_type!r}: 'midpoint' or 'heun'")
    del image_to_noise
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    s_in = _s_in(x)
    old_denoised = None
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        denoised, _ = model(x, s_in * float(sigma))
        if sigma_next == 0:  # k-diffusion returns the denoised estimate
            x = denoised
            continue
        t = log_sigma_time(sigma)
        h = log_sigma_time(sigma_next) - t
        eta_h = f32(eta) * h
        x_new = float(sigma_next / sigma * np.exp(-eta_h)) * x - float(np.expm1(-h - eta_h)) * denoised
        if i > 0:
            r = (t - log_sigma_time(sigmas[i - 1])) / h
            if solver_type == "midpoint":
                c = f32(0.5) * -np.expm1(-h - eta_h) / r
            else:
                c = (np.expm1(-h - eta_h) / (-h - eta_h) + f32(1.0)) / r
            x_new = x_new + float(c) * (denoised - old_denoised)
        if eta:
            scale = sigma_next * f32(math.sqrt(-np.expm1(f32(-2.0) * eta_h))) * f32(s_noise)
            x_new = x_new + noise(x.shape, sigma, sigma_next) * float(scale)
        x, old_denoised = x_new, denoised
    return x


def sample_dpmpp_2s_ancestral(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    eta: float = 1.0,
    s_noise: float = 1.0,
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    """The midpoint at r = 1/2 in log-sigma time; the final step (sigma_down
    = 0) is first-order Euler."""
    del image_to_noise
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    s_in = _s_in(x)
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        denoised, _ = model(x, s_in * float(sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        if sigma_down == 0:
            x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        else:
            t = log_sigma_time(sigma)
            h = log_sigma_time(sigma_down) - t
            sigma_mid = np.exp(-(t + f32(0.5) * h))
            x_mid = float(sigma_mid / sigma) * x - float(np.expm1(f32(-0.5) * h)) * denoised
            denoised_mid, _ = model(x_mid, s_in * float(sigma_mid))
            x = float(sigma_down / sigma) * x - float(np.expm1(-h)) * denoised_mid
        if sigma_up != 0:
            x = x + noise(x.shape, sigma, sigma_next) * float(f32(s_noise) * sigma_up)
    return x


def sample_dpmpp_sde(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    eta: float = 1.0,
    s_noise: float = 1.0,
    r: float = 1.0 / 2.0,
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    """Each substep goes to its ancestral split's sigma_down, then adds
    sigma_up of noise: to the midpoint ``t + r h``, then the full step with
    ``D = (1 - 1/2r) denoised + 1/2r model(x_mid)``."""
    del image_to_noise
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    s_in = _s_in(x)
    fac = 1.0 / (2.0 * r)
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        denoised, _ = model(x, s_in * float(sigma))
        if sigma_next == 0:  # k-diffusion's Euler branch is the denoised estimate
            x = denoised
            continue
        t = log_sigma_time(sigma)
        h = log_sigma_time(sigma_next) - t
        sigma_mid = np.exp(-(t + f32(r) * h))
        sd1, su1 = get_ancestral_step(sigma, sigma_mid, eta)
        x_mid = float(sd1 / sigma) * x - float(np.expm1(t - log_sigma_time(sd1))) * denoised
        if su1 != 0:
            x_mid = x_mid + noise(x.shape, sigma, sigma_mid) * float(f32(s_noise) * su1)
        denoised_mid, _ = model(x_mid, s_in * float(sigma_mid))
        sd2, su2 = get_ancestral_step(sigma, sigma_next, eta)
        denoised_d = (1.0 - fac) * denoised + fac * denoised_mid
        x = float(sd2 / sigma) * x - float(np.expm1(t - log_sigma_time(sd2))) * denoised_d
        if su2 != 0:
            x = x + noise(x.shape, sigma, sigma_next) * float(f32(s_noise) * su2)
    return x


def sample_dpmpp_3m_sde(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    eta: float = 1.0,
    s_noise: float = 1.0,
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    """First step first-order, second second-order, then third-order with
    ``h_eta = h (eta + 1)``, ``phi_2 = expm1(-h_eta)/h_eta + 1``,
    ``phi_3 = phi_2/h_eta - 1/2``."""
    del image_to_noise
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    s_in = _s_in(x)
    den_1 = den_2 = None
    h_1 = h_2 = f32(1.0)
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        denoised, _ = model(x, s_in * float(sigma))
        h = log_sigma_time(sigma_next) - log_sigma_time(sigma)
        if sigma_next == 0:
            x = denoised
            continue
        h_eta = h * f32(eta + 1.0)
        x_new = float(np.exp(-h_eta)) * x - float(np.expm1(-h_eta)) * denoised
        phi_2 = np.expm1(-h_eta) / h_eta + f32(1.0)
        if i >= 2:
            r0, r1 = h_1 / h, h_2 / h
            d1_0 = (denoised - den_1) / float(r0)
            d1_1 = (den_1 - den_2) / float(r1)
            d1 = d1_0 + (d1_0 - d1_1) * float(r0) / float(r0 + r1)
            d2 = (d1_0 - d1_1) / float(r0 + r1)
            phi_3 = phi_2 / h_eta - f32(0.5)
            x_new = x_new + (float(phi_2) * d1 - float(phi_3) * d2)
        elif i == 1:
            x_new = x_new + float(phi_2) * ((denoised - den_1) / float(h_1 / h))
        if eta:
            scale = sigma_next * f32(math.sqrt(max(-np.expm1(f32(-2.0) * h * f32(eta)), f32(0.0)))) * f32(s_noise)
            x_new = x_new + noise(x.shape, sigma, sigma_next) * float(scale)
        x, den_1, den_2, h_1, h_2 = x_new, denoised, den_1, h, h_1
    return x
