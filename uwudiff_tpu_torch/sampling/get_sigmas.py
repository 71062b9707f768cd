"""Rectified-flow sigma ladders (``uwudiff_tpu/sampling/get_sigmas.py``).

Each ladder is a warp of a uniform grid on the RF time axis, mapped back
to sigma by ``sigma = t / (1 - t)`` and flipped to descending order. The
JAX package computes them in numpy on the host; so does the port, with
the same operations, so the ladders agree bit for bit. The sigmoid, Karras,
exponential, beta and AYS ladders come with the samplers that use them.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np

__all__ = ["dynamic_shift_time", "get_sigmas_for_rf", "mu_for_image_seq_len", "shift_time", "uniform_time"]


def _sigma_to_time(sigma):
    return sigma / (1.0 + sigma)


def _time_to_sigma(time):
    return time / (1.0 - time)


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
