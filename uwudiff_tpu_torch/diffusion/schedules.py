"""Noise schedules (``uwudiff_tpu/diffusion/schedules.py``).

Conventions as in the JAX package: ``alphas_cumprod[t]`` for integer
``t in [0, N)``; ascending ``sigmas = sqrt((1-acp)/acp)``; the inference
ladder indexes the flipped, zero-appended sigmas; ``sigma_to_t`` is the
log-sigma interpolation of k-diffusion's ``DiscreteSchedule``, or with
``quantize`` the nearest grid timestep. The arrays live on the CPU until
:meth:`to`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NoiseSchedule"]


class NoiseSchedule:
    def __init__(self, alphas_cumprod: torch.Tensor, betas: torch.Tensor,
                 prediction_type: str = "epsilon"):
        self.alphas_cumprod = alphas_cumprod
        self.betas = betas
        self.prediction_type = prediction_type
        self.sigmas = torch.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
        self.log_sigmas = torch.log(self.sigmas)

    @classmethod
    def from_betas(cls, betas, prediction_type: str = "epsilon") -> "NoiseSchedule":
        betas = np.asarray(betas, dtype=np.float32)
        # the product in fp64, rounded once: within 1.2e-6 of the exact
        # value where a sequential fp32 cumprod drifts further
        acp = np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)
        return cls(torch.from_numpy(acp), torch.from_numpy(betas), prediction_type)

    @classmethod
    def ddpm(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "epsilon",
    ) -> "NoiseSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64
            ) ** 2
        else:
            raise ValueError(f"Unknown beta schedule {beta_schedule!r}")
        return cls.from_betas(betas, prediction_type=prediction_type)

    @classmethod
    def sdxl(cls, prediction_type: str = "epsilon") -> "NoiseSchedule":
        """The SDXL training schedule (scaled_linear 0.00085..0.012, N=1000)."""
        return cls.ddpm(prediction_type=prediction_type)

    sd15 = sdxl  # SD1.5 uses the same beta schedule

    def to(self, device) -> "NoiseSchedule":
        return NoiseSchedule(
            self.alphas_cumprod.to(device), self.betas.to(device), self.prediction_type
        )

    @property
    def num_train_timesteps(self) -> int:
        return self.alphas_cumprod.shape[0]

    @property
    def sigma_min(self) -> torch.Tensor:
        return self.sigmas[0]

    @property
    def sigma_max(self) -> torch.Tensor:
        return self.sigmas[-1]

    @property
    def sigmas_descending(self) -> torch.Tensor:
        return torch.cat([self.sigmas.flip(0), self.sigmas.new_zeros(1)])

    def sigma_to_t(self, sigma: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        """Fractional timestep by log-sigma interpolation; with ``quantize``
        the integer timestep whose log-sigma is nearest."""
        log_sigma = torch.log(torch.clamp(sigma, min=1e-10))
        if quantize:
            return (log_sigma[..., None] - self.log_sigmas).abs().argmin(dim=-1).reshape(sigma.shape)
        dists = log_sigma[..., None] - self.log_sigmas
        # low_idx: last grid point with log_sigma >= grid, clamped to N-2
        low_idx = torch.clamp((dists >= 0).sum(dim=-1) - 1, 0, self.log_sigmas.shape[0] - 2)
        high_idx = low_idx + 1
        low, high = self.log_sigmas[low_idx], self.log_sigmas[high_idx]
        w = torch.clamp((low - log_sigma) / (low - high), 0.0, 1.0)
        return ((1 - w) * low_idx + w * high_idx).reshape(sigma.shape)

    def t_to_sigma(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        low_idx = torch.floor(t).long()
        high_idx = torch.ceil(t).long()
        w = t - torch.floor(t)
        log_sigma = (1 - w) * self.log_sigmas[low_idx] + w * self.log_sigmas[high_idx]
        return torch.exp(log_sigma)

    def sigma_for_timestep(self, timesteps: torch.Tensor) -> torch.Tensor:
        """sigma for integer timesteps."""
        return self.sigmas[timesteps]

    def snr_for_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        """snr = sigma^-2: ``alphas_cumprod/(1 - alphas_cumprod)`` at integer
        timesteps, extended to continuous sigmas."""
        return sigma**-2

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target ``sqrt(acp)*noise - sqrt(1 - acp)*x0``."""
        acp = self.alphas_cumprod[timesteps].reshape(timesteps.shape + (1,) * (x0.dim() - timesteps.dim()))
        return acp.sqrt() * noise - (1.0 - acp).sqrt() * x0

    def sample_sigmas_descending(self, num_steps: int) -> torch.Tensor:
        """``sigmas_descending`` at ``linspace(0, N, steps+1)`` truncated to
        int (ends at sigma = 0)."""
        n = self.num_train_timesteps
        idx = torch.linspace(0, n, num_steps + 1).to(torch.int64)
        return self.sigmas_descending.cpu()[idx]
