"""Euler-ancestral sampler (``uwudiff_tpu/sampling/euler.py::sample_euler_ancestral``).

The JAX package runs the steps in ``lax.scan``; here they are a Python
loop over the host-side sigma ladder, so no step waits on the device.
The model is ``model(x, sigma) -> (denoised, uncond)``
(the CFG wrappers in ``sampling/cfg.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.sampling.wrapper import get_ancestral_step, to_d

__all__ = ["sample_euler_ancestral"]


def sample_euler_ancestral(
    model: Callable,
    x: torch.Tensor,
    sigmas,  # host-side ladder (sequence, numpy array or CPU tensor)
    noise_sampler: Callable,  # (shape, sigma, sigma_next) -> noise
) -> torch.Tensor:
    """eta = s_noise = 1; the inversion (``image_to_noise``) and eta
    options of the JAX sampler come with the samplers that use them."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    s_in = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        denoised, _ = model(x, s_in * float(sigma))
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next)
        x = x + to_d(x, sigma, denoised) * float(sigma_down - sigma)
        # sigma_up == 0 at the final step, so the unconditional add matches
        # the reference's `if sigmas[i+1] > 0` gate
        x = x + noise_sampler(x.shape, sigma, sigma_next) * float(sigma_up)
    return x
