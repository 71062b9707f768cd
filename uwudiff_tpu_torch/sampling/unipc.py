"""UniPC (Zhao et al. 2023), the order-2 ``bh2`` variant
(``uwudiff_tpu/sampling/unipc.py``): one model call a step, each call both
the corrector's input for the step that arrived (UniC) and the predictor's
base for the next (UniP). In k-diffusion space with ``lambda = -ln(sigma)``
and data prediction:

    predictor:  x_next = (s_n/s_c) x - expm1(-h) m0 - expm1(-h)/2 D1,
                D1 = (m_prev - m0) / rk,  rk = (lambda_prev - lambda_cur)/h
    corrector:  x_cur = (s_c/s_l) x_last - phi1 m_last - B_h (rho0 D1s + rho1 (m0 - m_last))

The first step predicts at order 1 with no corrector, the second corrects
at order 1, the final step (sigma -> 0) predicts at order 1. Host-side
ladder and gates, in fp32, as in ``sampling/euler.py``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.sampling.wrapper import host_sigmas, log_sigma_time

__all__ = ["sample_unipc"]

f32 = np.float32


def sample_unipc(
    model: Callable,
    x: torch.Tensor,
    sigmas,
    generator: torch.Generator | None = None,  # unused (deterministic)
    image_to_noise: bool = False,  # unused, as in the JAX package
) -> torch.Tensor:
    del generator, image_to_noise
    sigmas = host_sigmas(sigmas)
    s_in = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    x_last = m_last = m_last2 = None
    lam_last = lam_last2 = log_sigma_time(sigmas[0])
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        lam_cur = log_sigma_time(sigma)
        m0, _ = model(x, s_in * float(sigma))
        if i == 0:
            x_cur = x
        else:  # UniC: correct the arrival at sigma with the new evaluation
            h_c = lam_cur - lam_last
            hh_c = -h_c
            b_h_c = phi1_c = np.expm1(hh_c)
            b1 = (phi1_c / hh_c - f32(1.0)) / b_h_c
            b2 = ((phi1_c / hh_c - f32(1.0)) / hh_c - f32(0.5)) * f32(2.0) / b_h_c
            d1_t = m0 - m_last
            if i == 1:
                corr = 0.5 * d1_t
            else:
                rk_c = (lam_last2 - lam_last) / h_c
                rho0 = (b1 - b2) / (f32(1.0) - rk_c)
                corr = float(rho0) * ((m_last2 - m_last) / float(rk_c)) + float(b1 - rho0) * d1_t
            x_cur = float(sigma / np.exp(-lam_last)) * x_last - float(phi1_c) * m_last - float(b_h_c) * corr
        # UniP: predict sigma -> sigma_next
        h = log_sigma_time(sigma_next) - lam_cur
        phi1 = np.expm1(-h)
        x_next = float(sigma_next / sigma) * x_cur - float(phi1) * m0
        if i > 0 and sigma_next != 0:
            x_next = x_next - float(phi1 * f32(0.5)) * ((m_last - m0) / float((lam_last - lam_cur) / h))
        x, x_last, m_last2, m_last = x_next, x_cur, m_last, m0
        lam_last2, lam_last = lam_last, lam_cur
    return x
