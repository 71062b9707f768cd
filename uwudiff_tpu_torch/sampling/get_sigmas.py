"""Inference sigma ladders (``uwudiff_tpu/sampling/get_sigmas.py``).

The rectified-flow ladders warp a uniform grid on the RF time axis
(uniform, sigmoid, sigmoid-scale, static and dynamic shift), mapped back
to sigma by ``sigma = t / (1 - t)`` and flipped to descending order. The
k-diffusion ladders (Karras, exponential, polyexponential, beta, Align
Your Steps) are descending with a terminal 0, in fp32. The JAX package
computes them in numpy on the host; so does the port, with the same
operations, so the ladders agree bit for bit.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np

__all__ = [
    "ays_sigmas",
    "beta_sigmas",
    "dynamic_shift_time",
    "exponential_sigmas",
    "get_sigmas_for_rf",
    "karras_sigmas",
    "mu_for_image_seq_len",
    "polyexponential_sigmas",
    "shift_time",
    "sigmoid_time",
    "sigmoid_time_scale",
    "uniform_time",
]


def _sigma_to_time(sigma):
    return sigma / (1.0 + sigma)


def _time_to_sigma(time):
    return time / (1.0 - time)


def _expit(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _logit(p: float) -> float:
    return float(np.log(p) - np.log1p(-p))


def get_sigmas_for_rf(num_steps: int, max_sigma: float, min_sigma: float = 0.0,
                      time_disc_func: Callable | None = None) -> np.ndarray:
    """Descending ladder of ``num_steps + 1`` sigmas: ``time_disc_func(
    min_time, max_time, num_steps)`` (default :func:`uniform_time`) gives an
    ascending time grid, mapped through ``t -> t / (1 - t)`` and reversed."""
    disc = uniform_time if time_disc_func is None else time_disc_func
    times = disc(_sigma_to_time(min_sigma), _sigma_to_time(max_sigma), num_steps)
    return _time_to_sigma(np.asarray(times)[::-1]).copy()


def uniform_time(min_time: float, max_time: float, num_steps: int) -> np.ndarray:
    """Evenly spaced times: the plain RF discretization."""
    return np.linspace(min_time, max_time, num_steps + 1)


def sigmoid_time(min_time: float, max_time: float, num_steps: int, rho: float = 10) -> np.ndarray:
    """Times uniform in (1/rho)-scaled logit space, so steps cluster near 0
    and 1; ``min_time`` is floored at 1e-5 (a finite logit) and the first
    time pinned to that floor."""
    floor = max(min_time, 1e-5)
    grid = np.linspace(_logit(floor) / rho, _logit(max_time) / rho, num_steps + 1)
    times = _expit(rho * grid)
    times[0] = floor
    return times


def sigmoid_time_scale(min_time: float, max_time: float, num_steps: int, rho: float = 10) -> np.ndarray:
    """A sigmoid over a unit window centred at 0, renormalised to [0, 1] and
    mapped onto [min_time, max_time]: the endpoints exact, ``rho`` the
    interior's curvature."""
    ramp = _expit(rho * np.linspace(-0.5, 0.5, num_steps + 1))
    ramp = (ramp - ramp[0]) / (ramp[-1] - ramp[0])
    return min_time + (max_time - min_time) * ramp


def _warped_ramp(min_time: float, max_time: float, num_steps: int, warp) -> np.ndarray:
    """A uniform unit ramp through ``warp`` (which fixes 0 and 1), mapped
    affinely onto [min_time, max_time]."""
    u = warp(np.linspace(0.0, 1.0, num_steps + 1))
    return min_time + (max_time - min_time) * u


def shift_time(min_time: float, max_time: float, num_steps: int, shift: float = 3.0) -> np.ndarray:
    """SD3's static shift ``u' = shift*u / (1 + (shift-1)*u)`` of the
    uniform grid (``shift=1`` is :func:`uniform_time`)."""
    return _warped_ramp(min_time, max_time, num_steps, lambda u: shift * u / (1.0 + (shift - 1.0) * u))


def dynamic_shift_time(min_time: float, max_time: float, num_steps: int, mu: float = 1.0) -> np.ndarray:
    """Flux's resolution-dependent shift ``u' = e^mu / (e^mu + (1/u - 1))``,
    ``mu`` from :func:`mu_for_image_seq_len`; at ``mu = ln(shift)`` it is
    :func:`shift_time`."""

    def warp(u: np.ndarray) -> np.ndarray:
        out = np.zeros_like(u)
        nz = u > 0.0
        out[nz] = np.exp(mu) / (np.exp(mu) + (1.0 / u[nz] - 1.0))
        return out

    return _warped_ramp(min_time, max_time, num_steps, warp)


def mu_for_image_seq_len(seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
                         base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """The dynamic shift's ``mu``, linear in the image token count through
    (256, 0.5) and (4096, 1.15)."""
    slope = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    return float(base_shift + slope * (seq_len - base_seq_len))


def _with_zero(sigmas) -> np.ndarray:
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def karras_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0) -> np.ndarray:
    """Karras et al. 2022: ``sigma^(1/rho)`` linear between the endpoints."""
    ramp = np.linspace(0, 1, num_steps)
    inv_rho_min, inv_rho_max = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return _with_zero((inv_rho_max + ramp * (inv_rho_min - inv_rho_max)) ** rho)


def exponential_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0) -> np.ndarray:
    """Evenly spaced in log-sigma."""
    return _with_zero(np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_steps)))


def polyexponential_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                           rho: float = 1.0) -> np.ndarray:
    """The unit ramp raised to ``rho`` before the log-space interpolation
    (``rho = 1`` is :func:`exponential_sigmas`)."""
    ramp = np.linspace(1.0, 0.0, num_steps) ** rho
    return _with_zero(np.exp(ramp * (np.log(sigma_max) - np.log(sigma_min)) + np.log(sigma_min)))


def beta_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0, alpha: float = 0.6,
                beta: float = 0.6, schedule=None) -> np.ndarray:
    """Beta(alpha, beta) quantiles of a uniform grid as timestep fractions
    (Lee et al. 2024), which cluster steps at both ends: with ``schedule``
    (a ``NoiseSchedule``) they index its trained sigma table, else they
    interpolate log-linearly between ``sigma_min`` and ``sigma_max``."""
    from scipy.stats import beta as beta_dist

    frac = beta_dist.ppf(1.0 - np.linspace(0.0, 1.0, num_steps, endpoint=False), alpha, beta)
    if schedule is not None:
        idx = np.rint(frac * (int(schedule.num_train_timesteps) - 1)).astype(np.int64)
        return _with_zero(schedule.sigmas.cpu().numpy()[idx])
    return _with_zero(np.exp(frac * (np.log(sigma_max) - np.log(sigma_min)) + np.log(sigma_min)))


# Align Your Steps (Sabour et al. 2024): the published 10-step ladders;
# other step counts interpolate the table log-linearly over a unit ramp
_AYS_TABLES = {
    "sd15": [14.615, 6.475, 3.861, 2.697, 1.886, 1.396, 0.963, 0.652, 0.399, 0.152, 0.029],
    "sdxl": [14.615, 6.315, 3.771, 2.181, 1.342, 0.862, 0.555, 0.380, 0.234, 0.113, 0.029],
}


def ays_sigmas(num_steps: int = 10, model: str = "sdxl") -> np.ndarray:
    """The Align-Your-Steps ladder of ``model`` ("sd15" or "sdxl")."""
    table = np.asarray(_AYS_TABLES[model], np.float64)
    if num_steps + 1 != len(table):
        xq = np.linspace(0.0, 1.0, num_steps + 1)
        table = np.exp(np.interp(xq, np.linspace(0.0, 1.0, len(table)), np.log(table)))
    return _with_zero(table)
