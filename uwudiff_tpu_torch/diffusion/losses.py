"""The diffusion training losses (``uwudiff_tpu/diffusion/losses.py``:
``DiffusionLoss``, ``RectifiedFlowLoss``).

DDPM/EDM-sigma loss with epsilon/v/sample/rectified-flow targets, min-SNR
and debiased weights, noise offset, multires noise, input perturbation,
a timestep range, a loss mask and per-sample weights, as in the JAX
package. Its random draws (timesteps, noise, the perturbation) come from
an explicit ``torch.Generator``, or are passed in: JAX's threefry draws
cannot be reproduced, so a caller that must match the JAX package hands
over the draws the JAX side made. ``NNWeightedRFLoss`` and ``EDMLoss``
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.utils import append_dims

__all__ = ["DiffusionLoss", "DiffusionLossAux", "RectifiedFlowLoss"]


class DiffusionLossAux(NamedTuple):
    losses: torch.Tensor  # [B] per-sample loss
    timesteps: torch.Tensor  # [B]
    pred: torch.Tensor
    target: torch.Tensor
    noisy_latent: torch.Tensor


def _mse(pred, target):
    return (pred - target) ** 2


def _l1(pred, target):
    return (pred - target).abs()


def _huber(pred, target, delta: float = 1.0):
    err = pred - target
    abs_err = err.abs()
    return torch.where(abs_err <= delta, 0.5 * err**2, delta * (abs_err - 0.5 * delta))


_LOSS_FNS = {"mse": _mse, "l2": _mse, "l1": _l1, "huber": _huber}


@dataclasses.dataclass(frozen=True)
class DiffusionLoss:
    """``prediction_type`` is what the network outputs, ``target_type`` what
    the loss regresses to; conversion goes through (x0, eps)."""

    schedule: NoiseSchedule
    use_snr_weight: bool = False
    min_snr_gamma: float = 5.0
    use_debiased_estimation: bool = False
    prediction_type: str | None = None
    target_type: str | None = None
    loss_type: str = "mse"
    noise_offset: float = 0.0
    multires_noise_iterations: int = 0
    multires_noise_discount: float = 0.25
    input_perturbation: float = 0.0
    min_timestep: int = 0
    max_timestep: int | None = None

    def __post_init__(self):
        if self.prediction_type is None:
            object.__setattr__(self, "prediction_type", self.schedule.prediction_type)
        if self.target_type is None:
            object.__setattr__(self, "target_type", self.schedule.prediction_type)
        object.__setattr__(self, "_on_device", {})

    def schedule_on(self, device) -> NoiseSchedule:
        """The schedule's arrays on ``device``, copied there once."""
        device = torch.device(device)
        sched = self._on_device.get(device)
        if sched is None:
            sched = self._on_device[device] = self.schedule.to(device)
        return sched

    @property
    def n_diffusion_time_steps(self) -> int:
        return self.schedule.num_train_timesteps

    # --- random draws ---

    def sample_timesteps(self, batch_size: int, generator: torch.Generator, device) -> torch.Tensor:
        """Uniform integer timesteps in ``[min_timestep, max_timestep)``."""
        hi = self.schedule.num_train_timesteps if self.max_timestep is None else self.max_timestep
        if not 0 <= self.min_timestep < hi <= self.schedule.num_train_timesteps:
            raise ValueError(f"bad timestep range [{self.min_timestep}, {hi})")
        return torch.randint(self.min_timestep, hi, (batch_size,), generator=generator, device=device)

    def _normal(self, shape, x, generator):
        return torch.randn(shape, generator=generator, device=x.device, dtype=x.dtype)

    def sample_noise(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Gaussian noise, plus the multires octaves (bilinearly upsampled
        ``h >> i`` grids, ``discount**i``-weighted, renormalised per sample)
        and the per-(sample, channel) noise offset. ``x`` is NHWC."""
        noise = self._normal(x.shape, x, generator)
        if self.multires_noise_iterations and x.dim() == 4:
            b, h, w, c = x.shape
            for i in range(1, self.multires_noise_iterations):
                hn, wn = max(1, h >> i), max(1, w >> i)
                low = self._normal((b, c, hn, wn), x, generator)
                up = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
                noise = noise + self.multires_noise_discount**i * up.permute(0, 2, 3, 1)
                if hn == 1 and wn == 1:
                    break
            std = noise.reshape(b, -1).std(dim=1, unbiased=False)
            noise = noise / append_dims(std, noise.dim()).clamp_min(1e-8)
        if self.noise_offset:
            off_shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
            noise = noise + self.noise_offset * self._normal(off_shape, x, generator)
        return noise

    # --- forward noising, targets, conversions ---

    def noise_latents(self, x, noise, sigmas):
        sigmas = append_dims(sigmas, x.dim())
        scales = 1.0 / torch.sqrt(sigmas**2 + 1.0)
        return (x + noise * sigmas) * scales

    def get_target(self, x0, noise, timesteps):
        if self.target_type == "epsilon":
            return noise
        if self.target_type == "v_prediction":
            return self.schedule_on(x0.device).velocity(x0, noise, timesteps)
        if self.target_type == "sample":
            return x0
        if self.target_type == "rectified_flow":
            return noise - x0
        raise ValueError(f"Unsupported target type {self.target_type}")

    def get_x0_eps_from_pred_with_sigmas(self, xt, model_output, sigmas):
        """``xt`` is the scaled noisy latent."""
        sigmas = append_dims(sigmas, xt.dim())
        scales = 1.0 / torch.sqrt(sigmas**2 + 1.0)
        if self.prediction_type == "sample":
            x0 = model_output
            eps = (xt / scales - x0) / sigmas
        elif self.prediction_type == "epsilon":
            eps = model_output
            x0 = xt / scales - sigmas * eps
        elif self.prediction_type == "v_prediction":
            x0 = scales * (xt - sigmas * model_output)
            eps = (xt / scales - x0) / sigmas
        elif self.prediction_type == "rectified_flow":
            x0 = (xt / scales - sigmas * model_output) / (1 + sigmas)
            eps = (xt / scales + model_output) / (1 + sigmas)
        else:
            raise ValueError(f"Unsupported prediction type {self.prediction_type}")
        return x0, eps

    def get_prediction_for_training(self, xt, model_output, timesteps, sigmas):
        if self.prediction_type == self.target_type:
            return model_output
        x0, eps = self.get_x0_eps_from_pred_with_sigmas(xt, model_output, sigmas)
        return self.get_target(x0, eps, timesteps)

    # --- weights and reductions ---

    def apply_snr_weight(self, losses, sigmas):
        """Min-SNR weighting, from sigma (snr = sigma^-2)."""
        if self.prediction_type != self.target_type or self.prediction_type not in (
            "epsilon", "v_prediction"
        ):
            raise ValueError("min-SNR weighting needs matching epsilon or v targets")
        snr = self.schedule.snr_for_sigma(sigmas)
        clipped = torch.clamp(snr, max=self.min_snr_gamma)
        if self.prediction_type == "v_prediction":
            return losses * (clipped / (snr + 1))
        return losses * (clipped / snr)

    def apply_debiased_estimation(self, losses, sigmas):
        """1/sqrt(SNR) weighting, SNR capped at 1000."""
        if not self.prediction_type == self.target_type == "epsilon":
            raise ValueError("debiased estimation needs epsilon prediction and target")
        snr = torch.clamp(self.schedule.snr_for_sigma(sigmas), max=1000.0)
        return losses / torch.sqrt(snr)

    def _reduce_per_sample(self, losses, loss_mask=None):
        """Per-sample mean; with ``loss_mask`` ([B, h, w] or [B, h, w, 1],
        values in [0, 1]) the masked mean ``sum(m*l) / sum(m)``."""
        b = losses.shape[0]
        if loss_mask is None:
            return losses.reshape(b, -1).mean(dim=1)
        m = loss_mask.to(losses.dtype)
        while m.dim() < losses.dim():
            m = m[..., None]
        m = m.expand(losses.shape)
        num = (losses * m).reshape(b, -1).sum(dim=1)
        den = m.reshape(b, -1).sum(dim=1).clamp_min(1e-6)
        return num / den

    # --- main entry ---

    def __call__(
        self,
        x: torch.Tensor,
        model_fn: Callable[..., torch.Tensor],
        *,
        noise: torch.Tensor | None = None,
        timesteps: torch.Tensor | None = None,
        perturbation: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        sample_weight: torch.Tensor | None = None,
        loss_mask: torch.Tensor | None = None,
        **model_kwargs: Any,
    ) -> tuple[torch.Tensor, DiffusionLossAux]:
        """``(loss, aux)`` for latents ``x`` [B, H, W, C] and
        ``model_fn(noisy_latent, timesteps, **model_kwargs)``. ``noise``
        (the final noise, offsets included), ``timesteps`` and
        ``perturbation`` (the input perturbation's fresh normal draw) are
        drawn from ``generator`` where not given."""
        if noise is None:
            noise = self.sample_noise(x, generator)
        if timesteps is None:
            timesteps = self.sample_timesteps(x.shape[0], generator, x.device)
        sigmas = self.schedule_on(x.device).sigma_for_timestep(timesteps)
        input_noise = noise
        if self.input_perturbation:
            if perturbation is None:
                perturbation = self._normal(x.shape, x, generator)
            input_noise = noise + self.input_perturbation * perturbation
        noisy_latent = self.noise_latents(x, input_noise, sigmas)

        model_output = model_fn(noisy_latent, timesteps, **model_kwargs)

        pred = self.get_prediction_for_training(noisy_latent, model_output, timesteps, sigmas)
        target = self.get_target(x, noise, timesteps)
        losses = self._reduce_per_sample(_LOSS_FNS[self.loss_type](pred, target), loss_mask)
        if self.use_snr_weight:
            losses = self.apply_snr_weight(losses, sigmas)
        if self.use_debiased_estimation:
            losses = self.apply_debiased_estimation(losses, sigmas)
        aux = DiffusionLossAux(losses, timesteps, pred, target, noisy_latent)
        loss = losses.mean() if sample_weight is None else (losses * sample_weight.to(losses.dtype)).mean()
        return loss, aux


@dataclasses.dataclass(frozen=True)
class RectifiedFlowLoss(DiffusionLoss):
    """Rectified-flow loss: the target is ``noise - x0``, a prediction of
    another type is converted through (x0, eps).

    ``time_sampling_type``: ``uniform_time`` draws t ~ U(0, max_time),
    ``logit_normal`` (SD3) t = sigmoid(mean + std * z), z ~ N(0, 1), capped
    at max_time; then sigma = t / (1 - t) and the fractional timestep
    ``sigma_to_t(sigma)``. ``uniform_timestep`` draws integer timesteps as
    ``DiffusionLoss`` does. ``max_time = sigma_max / (1 + sigma_max)``."""

    time_sampling_type: str = "uniform_time"
    rescale_image: bool = False
    rescale_noise: bool = False
    logit_normal_mean: float = 0.0
    logit_normal_std: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "target_type", "rectified_flow")

    def sample_time_draws(self, batch_size: int, generator: torch.Generator, device) -> torch.Tensor:
        """The raw draws the time is made from: U(0, 1) (``uniform_time``),
        N(0, 1) (``logit_normal``) or integer timesteps (``uniform_timestep``)."""
        if self.time_sampling_type == "uniform_timestep":
            return self.sample_timesteps(batch_size, generator, device)
        if self.time_sampling_type == "uniform_time":
            return torch.rand((batch_size,), generator=generator, device=device)
        if self.time_sampling_type == "logit_normal":
            return torch.randn((batch_size,), generator=generator, device=device)
        raise ValueError(f"Unsupported time sampling type: {self.time_sampling_type}")

    def timesteps_and_sigmas(self, draws: torch.Tensor, device):
        """(timesteps, sigmas) from the time draws."""
        sched = self.schedule_on(device)
        if self.time_sampling_type == "uniform_timestep":
            timesteps = draws.long()
            return timesteps, sched.sigma_for_timestep(timesteps)
        sigma_max = sched.sigmas[-1]
        max_time = sigma_max / (1 + sigma_max)
        if self.time_sampling_type == "uniform_time":
            time = draws.float() * max_time
        elif self.time_sampling_type == "logit_normal":
            time = torch.minimum(torch.sigmoid(self.logit_normal_mean + self.logit_normal_std * draws.float()),
                                 max_time)
        else:
            raise ValueError(f"Unsupported time sampling type: {self.time_sampling_type}")
        sigmas = time / (1 - time)
        return sched.sigma_to_t(sigmas), sigmas

    def get_x0_and_noises(self, x, noise):
        """A 5-D ``[B, 2, ...]`` input carries a paired (sample, noise)."""
        if x.dim() == 5:
            x, noise = x[:, 0], x[:, 1]
        if self.rescale_image:
            x = x / append_dims(x.reshape(x.shape[0], -1).std(dim=1, unbiased=False), x.dim()) * 0.937
        if self.rescale_noise:
            noise = noise / append_dims(noise.reshape(noise.shape[0], -1).std(dim=1, unbiased=False), noise.dim())
        return x, noise

    def __call__(
        self,
        x: torch.Tensor,
        model_fn: Callable[..., torch.Tensor],
        *,
        noise: torch.Tensor | None = None,
        time_draws: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        sample_weight: torch.Tensor | None = None,
        loss_mask: torch.Tensor | None = None,
        **model_kwargs: Any,
    ) -> tuple[torch.Tensor, DiffusionLossAux]:
        """``(loss, aux)``. ``noise`` and ``time_draws`` (see
        :meth:`sample_time_draws`) are drawn from ``generator`` where not
        given; a paired 5-D ``x`` brings its own noise."""
        if noise is None and x.dim() != 5:
            noise = self._normal(x.shape, x, generator)
        x, noise = self.get_x0_and_noises(x, noise)
        if time_draws is None:
            time_draws = self.sample_time_draws(x.shape[0], generator, x.device)
        timesteps, sigmas = self.timesteps_and_sigmas(time_draws, x.device)
        noisy_latent = self.noise_latents(x, noise, sigmas)

        model_output = model_fn(noisy_latent, timesteps, **model_kwargs)

        target = noise - x
        pred_x0, pred_eps = self.get_x0_eps_from_pred_with_sigmas(noisy_latent, model_output, sigmas)
        pred = pred_eps - pred_x0
        losses = self._reduce_per_sample(_LOSS_FNS[self.loss_type](pred, target), loss_mask)
        aux = DiffusionLossAux(losses, timesteps, pred, target, noisy_latent)
        loss = losses.mean() if sample_weight is None else (losses * sample_weight.to(losses.dtype)).mean()
        return loss, aux
