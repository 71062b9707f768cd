"""Image-to-image and mask inpainting on top of every sampler
(``uwudiff_tpu/sampling/img2img.py``).

SDEdit img2img re-noises the init latent to an intermediate sigma and
samples from there (:func:`img2img_sigmas` keeps the last ``strength`` of
the ladder). Inpainting pins the denoised prediction to the init latent
where the mask is 0 (:func:`masked_model_wrapper`; the mask is 1 where the
model repaints, in-between values blend) and the result to it at the end.
Both are a truncated ladder and a model-output blend, so no sampler needs
its own code. Latents live in the unscaled k-diffusion space
``x = x0 + sigma * eps``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.sampling.cfg import build_cfg_fn, encode_cfg_inputs
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral
from uwudiff_tpu_torch.sampling.noise import lane_seed, seeded_generator
from uwudiff_tpu_torch.sampling.sampling import _UNPORTED
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser
from uwudiff_tpu_torch.utils import truncate_or_pad_to_length, vae_image_postprocess

__all__ = ["image_to_image_sampling", "img2img_sigmas", "masked_model_wrapper"]


def img2img_sigmas(schedule: NoiseSchedule, num_steps: int, strength: float,
                   get_sigma_func: Callable | None = None) -> np.ndarray:
    """The last ``strength`` (in (0, 1]) of the ladder, at least one step,
    still ending at 0: 1.0 is txt2img from pure noise, less starts lower and
    stays nearer the init image."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    if get_sigma_func is None:
        sigmas = schedule.sample_sigmas_descending(num_steps).numpy()
    else:
        sigmas = np.asarray(get_sigma_func(num_steps), np.float32)
    n = sigmas.shape[0] - 1
    keep = max(1, min(n, int(round(n * strength))))
    return sigmas[n - keep:]


def masked_model_wrapper(model: Callable, init_latent: torch.Tensor, mask) -> Callable:
    """Both outputs of ``model(x, sigma, sigma_cond=None) -> (denoised,
    uncond)`` pinned to ``init_latent`` where ``mask`` is 0 (so the CFG++
    samplers stay consistent)."""
    mask = torch.as_tensor(mask, dtype=init_latent.dtype, device=init_latent.device)

    def blend(d):
        return None if d is None else mask * d + (1.0 - mask) * init_latent

    def wrapped(x, sigma, sigma_cond=None, **kwargs):
        denoised, uncond = model(x, sigma, sigma_cond=sigma_cond, **kwargs)
        return blend(denoised), blend(uncond)

    return wrapped


@torch.inference_mode()
def image_to_image_sampling(
    unet_fn: Callable,  # (x, t, ctx, mask, added_cond) -> eps, or (params, x, ...) with unet_params
    te,  # TextEncodingPipeline; the sampling runs on its device
    init_image,  # [N, H, W, 3] in [-1, 1], or None when init_latent is given
    prompt,
    neg_prompt,
    vae_encode: Callable | None = None,  # (images, generator) -> raw latents
    vae_decode: Callable | None = None,
    train_schedule: NoiseSchedule | None = None,
    init_latent: torch.Tensor | None = None,  # pre-encoded, normalised
    strength: float = 0.6,
    num_steps: int = 16,
    get_sigma_func: Callable | None = None,
    inpaint_mask=None,  # latent resolution, broadcastable to the latents; 1 = repaint
    cfg_scale: float = 3.0,
    seed: int = 42,
    vae_std: float | None = None,
    vae_mean: float | None = None,
    vae_downscale: int = 8,  # latent -> pixel factor, for the time ids
    internal_sampling_func: Callable | None = None,
    return_latents: bool = False,
    jit_compile: bool = True,
    unet_params=None,
    denoiser_cls: type = KDiffusionDenoiser,
    prompt_weighting: bool = False,
    long_prompt: bool = False,
    cfg_interval: tuple[float, float] | None = None,
    noise: torch.Tensor | None = None,  # the SDEdit start noise; default drawn from seed
):
    """SDEdit img2img, or inpainting with ``inpaint_mask``; the contract of
    :func:`~uwudiff_tpu_torch.sampling.sampling.diffusion_sampling`. Give
    ``init_image`` and ``vae_encode``, or a normalised ``init_latent``. The
    encoder's draw, the start noise and the sampler's draws come from three
    generators derived from ``seed`` (or ``noise`` is given). Returns the
    latents (fp32, on the device) with ``return_latents`` or no
    ``vae_decode``, else a list of uint8 HWC numpy images."""
    del jit_compile  # eager
    for name, value in (("prompt_weighting", prompt_weighting), ("long_prompt", long_prompt)):
        unset, item = _UNPORTED[name]
        if value != unset:
            raise NotImplementedError(f"image_to_image_sampling: {name} is not ported yet (ROADMAP.md, {item})")
    if train_schedule is None:
        raise ValueError("train_schedule is required")
    internal_sampling_func = internal_sampling_func or sample_euler_ancestral
    vae_std = vae_std if vae_std is not None else 1.0
    vae_mean = vae_mean or 0.0
    device = te.device
    gen_enc, gen_noise, gen_samp = (seeded_generator(lane_seed(seed, 3, k), device) for k in range(3))
    if init_latent is None:
        if init_image is None or vae_encode is None:
            raise ValueError("need init_image and vae_encode, or a pre-encoded init_latent")
        init_latent = (vae_encode(torch.as_tensor(init_image, device=device), gen_enc) - vae_mean) / vae_std
    num_samples = init_latent.shape[0]

    prompt = [prompt] if isinstance(prompt, str) else list(prompt)
    neg_prompt = [neg_prompt] if isinstance(neg_prompt, str) else list(neg_prompt)
    prompt = truncate_or_pad_to_length(prompt, num_samples, "cycling")
    neg_prompt = truncate_or_pad_to_length(neg_prompt, num_samples, "cycling")
    h_lat, w_lat = init_latent.shape[1:3]
    enc = encode_cfg_inputs(prompt, neg_prompt, w_lat * vae_downscale, h_lat * vae_downscale, te)
    sigmas = img2img_sigmas(train_schedule, num_steps, strength, get_sigma_func=get_sigma_func)

    def eps_fn(x, t, encoder_hidden_states=None, encoder_attention_mask=None, added_cond=None):
        args = (x, t, encoder_hidden_states, encoder_attention_mask, added_cond)
        return unet_fn(unet_params, *args) if unet_params is not None else unet_fn(*args)

    wrapper = denoiser_cls(model_fn=eps_fn, schedule=train_schedule.to(device))
    model = build_cfg_fn(wrapper, enc, cfg_scale, cfg_interval=cfg_interval)
    if inpaint_mask is not None:
        model = masked_model_wrapper(model, init_latent, inpaint_mask)
    if noise is None:
        noise = torch.randn(init_latent.shape, generator=gen_noise, device=device, dtype=init_latent.dtype)
    x = init_latent + noise * float(sigmas[0])  # SDEdit's start: x0 + sigma_start * eps
    latents = internal_sampling_func(model, x, sigmas, generator=gen_samp)
    if inpaint_mask is not None:  # the kept region exactly the init latent at sigma = 0
        m = torch.as_tensor(inpaint_mask, dtype=latents.dtype, device=device)
        latents = m * latents + (1.0 - m) * init_latent
    latents = latents * vae_std + vae_mean
    if return_latents or vae_decode is None:
        return latents
    return [vae_image_postprocess(img) for img in vae_decode(latents).cpu().numpy()]
