"""LCM few-step sampling (Latent Consistency Models, Luo et al. 2023;
``uwudiff_tpu/sampling/lcm.py``).

- :class:`LCMDenoiser` wraps the eps-predicting student as
  ``KDiffusionDenoiser`` does and returns the consistency output
  ``c_skip(t) z + c_out(t) x0_pred`` (``z = x / sqrt(1 + sigma^2)``), the
  boundary scalings those of the distillation;
- :func:`sample_lcm` re-noises the clean estimate fully to each next sigma
  (the final step, sigma = 0, returns it);
- :func:`get_sigmas_lcm` spaces the steps on the distillation DDIM grid
  ``(i+1) k - 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.sampling.noise import noise_source
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser, host_sigmas
from uwudiff_tpu_torch.utils import append_dims

__all__ = ["LCMDenoiser", "boundary_scalings", "get_sigmas_lcm", "sample_lcm"]


def boundary_scalings(timesteps: torch.Tensor, sigma_data: float = 0.5, timestep_scaling: float = 10.0):
    """Consistency-function coefficients ``(c_skip, c_out)``, identity at
    t = 0 (``uwudiff_tpu/training/distill.py::boundary_scalings``)."""
    st = timestep_scaling * timesteps.float()
    return sigma_data**2 / (st**2 + sigma_data**2), st / (st**2 + sigma_data**2).sqrt()


@dataclasses.dataclass(frozen=True)
class LCMDenoiser(KDiffusionDenoiser):
    """The consistency output over an eps-predicting student; pass the
    ``sigma_data_boundary`` and ``timestep_scaling`` it was distilled with."""

    sigma_data_boundary: float = 0.5
    timestep_scaling: float = 10.0

    def __call__(self, x, sigma, sigma_cond=None, **kwargs):
        x0_pred = super().__call__(x, sigma, sigma_cond=sigma_cond, **kwargs)
        t = self.schedule.sigma_to_t(sigma if sigma_cond is None else sigma_cond, quantize=self.quantize)
        c_skip, c_out = boundary_scalings(t, self.sigma_data_boundary, self.timestep_scaling)
        z = x / (append_dims(sigma, x.dim()) ** 2 + 1.0).sqrt()
        return append_dims(c_skip, x.dim()) * z + append_dims(c_out, x.dim()) * x0_pred


def sample_lcm(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    noise_sampler: Callable | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The LCM loop over a descending ladder ending at 0. ``model`` is
    :class:`LCMDenoiser` behind the CFG wrapper at cfg 1 (the guidance is
    distilled into the student)."""
    sigmas = host_sigmas(sigmas)
    noise = noise_source(noise_sampler, generator, x)
    s_in = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        x, _ = model(x, s_in * float(sigma), sigma_cond=s_in * float(sigma))
        if sigma_next != 0:
            x = x + noise(x.shape, sigma, sigma_next) * float(sigma_next)
    return x


def get_sigmas_lcm(num_steps: int, schedule: NoiseSchedule | None = None,
                   num_ddim_timesteps: int = 50) -> np.ndarray:
    """``num_steps`` sigmas evenly from the ``(i+1) k - 1`` timestep grid,
    highest first, and a terminal 0 (fp32, host). ``schedule`` defaults to
    the SDXL training schedule; a student distilled on another binds its
    own."""
    schedule = schedule if schedule is not None else NoiseSchedule.sdxl()
    k = schedule.num_train_timesteps // num_ddim_timesteps
    grid = np.arange(1, num_ddim_timesteps + 1) * k - 1
    idx = np.linspace(num_ddim_timesteps - 1, 0, min(num_steps, num_ddim_timesteps)).round().astype(int)
    sigmas = schedule.sigma_for_timestep(torch.from_numpy(grid[idx])).cpu().numpy()
    return np.concatenate([host_sigmas(sigmas), np.zeros((1,), np.float32)])
