"""k-diffusion sigma-parameterization wrappers (``uwudiff_tpu/sampling/wrapper.py``).

An eps-predicting discrete-schedule model is driven in continuous sigma
space via ``c_in = 1/sqrt(sigma^2 + sigma_data^2)``, ``c_out = -sigma`` and
the log-linear sigma<->t interpolation of :class:`NoiseSchedule`
(``quantize``: the nearest grid timestep). :class:`VDenoiser` drives a
v-prediction model, :class:`RFDenoiser` a rectified-flow (velocity) one,
Flux's, the same way; :class:`EDMDenoiser` an EDM-trained network, with
no DDPM schedule. ``sigma_cond`` conditions the model on another sigma
than the one the input is scaled by: inversion passes the next step's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.utils import append_dims

__all__ = [
    "EDMDenoiser",
    "KDiffusionDenoiser",
    "RFDenoiser",
    "VDenoiser",
    "denoiser_for_loss",
    "get_ancestral_step",
    "host_sigmas",
    "log_sigma_time",
    "to_d",
]


def denoiser_for_loss(loss) -> type:
    """The sampling wrapper of a training loss's parameterization:
    ``RectifiedFlowLoss`` -> :class:`RFDenoiser`; v-prediction ->
    :class:`VDenoiser`; eps or sample prediction -> :class:`KDiffusionDenoiser`.
    :class:`EDMDenoiser` takes no schedule and is built explicitly."""
    from uwudiff_tpu_torch.diffusion.losses import RectifiedFlowLoss

    if isinstance(loss, RectifiedFlowLoss):
        return RFDenoiser
    if getattr(loss, "prediction_type", None) == "v_prediction":
        return VDenoiser
    return KDiffusionDenoiser


def host_sigmas(sigmas) -> np.ndarray:
    """A sampler's ladder as fp32 host scalars (a sequence, numpy array or
    tensor): the samplers branch and do their scalar arithmetic on the host,
    in fp32 as the JAX package's compiled loops do, so no step waits on the
    device."""
    if isinstance(sigmas, torch.Tensor):
        sigmas = sigmas.detach().cpu().numpy()
    return np.asarray(sigmas, dtype=np.float32)


def log_sigma_time(sigma) -> np.float32:
    """``t = -ln(sigma)`` in fp32, guarded at ``sigma = 0``."""
    return -np.log(max(np.float32(sigma), np.float32(1e-20)))


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
    denoised sample ``x + eps * c_out``, the model conditioned on
    ``sigma_cond`` (default ``sigma``)."""

    model_fn: Callable
    schedule: NoiseSchedule
    quantize: bool = False
    sigma_data: float = 1.0

    def _model_out(self, x, sigma, sigma_cond, **kwargs):
        """The network's output on the scaled input, conditioned on
        ``sigma_cond`` (default ``sigma``)."""
        c_in = 1.0 / (sigma**2 + self.sigma_data**2).sqrt()
        t = self.schedule.sigma_to_t(sigma if sigma_cond is None else sigma_cond, quantize=self.quantize)
        return self.model_fn(x * append_dims(c_in, x.dim()), t, **kwargs)

    def __call__(self, x, sigma, sigma_cond=None, **kwargs):
        eps = self._model_out(x, sigma, sigma_cond, **kwargs)
        return x + eps * append_dims(-sigma, x.dim())


@dataclasses.dataclass(frozen=True)
class VDenoiser(KDiffusionDenoiser):
    """Sigma-space wrapper of a v-prediction network (``DiffusionLoss(
    prediction_type="v_prediction")``: the model sees the VP-scaled latent
    and predicts ``v = sqrt(abar) n - sqrt(1 - abar) x0``), so
    ``x0 = x / (1 + sigma^2) - sigma / sqrt(1 + sigma^2) * v``."""

    def __call__(self, x, sigma, sigma_cond=None, **kwargs):
        v = self._model_out(x, sigma, sigma_cond, **kwargs)
        sig = append_dims(sigma, x.dim())
        return 1.0 / (sig**2 + 1.0) * x + -sig / (sig**2 + 1.0).sqrt() * v


@dataclasses.dataclass(frozen=True)
class RFDenoiser(KDiffusionDenoiser):
    """Sigma-space wrapper of a rectified-flow network (``RectifiedFlowLoss``'s
    convention: the model sees ``x / sqrt(1 + sigma^2)`` at fractional DDPM
    timesteps and predicts the velocity ``v = noise - x0``), so in
    k-diffusion space ``x0 = (x - sigma * v) / (1 + sigma)``."""

    def __call__(self, x, sigma, sigma_cond=None, **kwargs):
        v = self._model_out(x, sigma, sigma_cond, **kwargs)
        sig = append_dims(sigma, x.dim())
        return (x - sig * v) / (1.0 + sig)


@dataclasses.dataclass(frozen=True)
class EDMDenoiser:
    """Sigma-space wrapper of an EDM-trained network (Karras et al. 2022):
    ``model_fn(x_scaled, c_noise, **kwargs) -> F``, and calling returns
    ``c_skip x + c_out F(c_in x, ln(sigma) / 4)``; ``sigma_cond`` is
    accepted and unused. Pairs with ``get_sigmas.karras_sigmas``."""

    model_fn: Callable
    sigma_data: float = 0.5
    sigma_min: float = 0.002
    sigma_max: float = 80.0

    def __call__(self, x, sigma, sigma_cond=None, **kwargs):
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        if sigma.dim() == 0:
            sigma = sigma.expand(x.shape[0])
        sd = self.sigma_data
        denom = sigma**2 + sd**2
        c_skip, c_out, c_in = sd**2 / denom, sigma * sd / denom.sqrt(), 1.0 / denom.sqrt()
        f_out = self.model_fn(x * append_dims(c_in, x.dim()), torch.log(sigma) / 4.0, **kwargs)
        return append_dims(c_skip, x.dim()) * x + append_dims(c_out, x.dim()) * f_out
