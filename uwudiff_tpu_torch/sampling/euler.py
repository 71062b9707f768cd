"""Euler-ancestral samplers (``uwudiff_tpu/sampling/euler.py``), with the
``image_to_noise`` inversion mode (the model conditioned on the next
step's sigma) and the CFG++ variant (Chung et al. 2024), which anchors
the step on one of the model's two outputs and extrapolates with the
other.

The JAX package runs the steps in ``lax.scan``; here, as in every sampler
of the port, they are a Python loop over the host-side ladder
(``wrapper.host_sigmas``): the branches are host ``if``s on fp32 host
scalars, so no step waits on the device. The model is
``model(x, sigma, sigma_cond=None) -> (denoised, uncond)`` (the CFG
wrappers in ``sampling/cfg.py``); ``noise_sampler(shape, sigma,
sigma_next)`` draws a step's noise, or else ``generator`` does
(``noise.noise_source``). A draw scaled by zero is skipped.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.sampling.noise import noise_source
from uwudiff_tpu_torch.sampling.wrapper import get_ancestral_step, host_sigmas, to_d

__all__ = ["sample_euler_ancestral", "sample_euler_ancestral_cfgpp"]


def _sample(model, x, sigmas, noise_sampler, generator, eta, s_noise, image_to_noise, cfgpp):
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    s_in = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        sigma_cond = sigma_next if image_to_noise else sigma
        denoised, uncond = model(x, s_in * float(sigma), sigma_cond=s_in * float(sigma_cond))
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next, eta)
        if not cfgpp:
            x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        elif image_to_noise:  # CFG++: the guided derivative from the uncond anchor
            x = uncond + to_d(x, sigma, denoised) * float(sigma_down)
        else:
            x = denoised + to_d(x, sigma, uncond) * float(sigma_down)
        # sigma_up == 0 at the final step, so skipping the draw matches the
        # reference's `if sigmas[i+1] > 0` gate
        if sigma_up != 0:
            x = x + noise(x.shape, sigma, sigma_next) * float(np.float32(s_noise) * sigma_up)
    return x


def sample_euler_ancestral(
    model: Callable,
    x: torch.Tensor,
    sigmas,  # host-side ladder (sequence, numpy array or CPU tensor)
    noise_sampler: Callable | None = None,  # (shape, sigma, sigma_next) -> noise
    generator: torch.Generator | None = None,
    eta: float = 1.0,
    s_noise: float = 1.0,
    image_to_noise: bool = False,
) -> torch.Tensor:
    """Euler-ancestral; ``eta = 0`` is the deterministic Euler ODE step."""
    return _sample(model, x, sigmas, noise_sampler, generator, eta, s_noise, image_to_noise, cfgpp=False)


def sample_euler_ancestral_cfgpp(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
    eta: float = 1.0,
    s_noise: float = 1.0,
    image_to_noise: bool = False,
) -> torch.Tensor:
    """CFG++ Euler-ancestral: the step starts from the guided estimate and
    extrapolates with the unconditional derivative (inversion: the other
    way round)."""
    return _sample(model, x, sigmas, noise_sampler, generator, eta, s_noise, image_to_noise, cfgpp=True)
