"""Latent-space Euler sampling with image->noise inversion
(``uwudiff_tpu/sampling/euler_latent.py``).

The ladder is the training grid's: ``num_steps`` sigmas at an ascending
linspace of indices into the descending table, then 0; inversion walks it
upwards from the smallest nonzero sigma, the model conditioned on each
step's next sigma, after adding that smallest sigma of noise. The steps
are deterministic (eta 0), with CFG, CFG++ or one conditional pass
(``cfg_scale`` 1 without CFG++, or 0: the negative prompt alone).
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.sampling.cfg import cfg_wrapper, cond_text_wrapper
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral, sample_euler_ancestral_cfgpp
from uwudiff_tpu_torch.sampling.noise import seeded_generator
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser

__all__ = ["euler_latent_sigmas", "euler_latent_sampling"]


def euler_latent_sigmas(schedule: NoiseSchedule, num_steps: int, image_to_noise: bool = False) -> torch.Tensor:
    """The fp32 host ladder: descending and ending at 0, or (inversion)
    ascending from the smallest nonzero sigma."""
    table = schedule.sigmas_descending.cpu()
    idx = torch.linspace(0, schedule.num_train_timesteps - 1, num_steps).to(torch.int64)
    sigmas = table[:-1][idx]
    if image_to_noise:
        return torch.cat([table[-2:-1], sigmas.flip(0)])
    return torch.cat([sigmas, table[-1:]])


@torch.inference_mode()
def euler_latent_sampling(
    x_init: torch.Tensor,  # [B, h, w, C] latents (or images to invert)
    unet_fn: Callable,  # (x, t, ctx, mask, added_cond) -> eps
    te,  # TextEncodingPipeline
    schedule: NoiseSchedule,
    prompt,
    neg_prompt,
    image_to_noise: bool = False,
    cfg_scale: float = 3.0,
    use_cfgpp: bool = False,
    num_steps: int = 16,
    time_ids=None,
    seed: int = 42,
    vae_downscale: int = 8,
    denoiser_cls: type = KDiffusionDenoiser,
    noise: torch.Tensor | None = None,  # inversion's start noise; default drawn from seed
) -> torch.Tensor:
    """Latents ``[B, h, w, C]`` on ``x_init``'s device: x_init inverted to
    noise (``image_to_noise``) or noise sampled to an image latent."""
    prompt = [prompt] if isinstance(prompt, str) else list(prompt)
    neg_prompt = [neg_prompt] if isinstance(neg_prompt, str) else list(neg_prompt)
    if not len(prompt) == len(neg_prompt) == x_init.shape[0]:
        raise ValueError(f"{len(prompt)} prompts, {len(neg_prompt)} negative prompts, {x_init.shape[0]} latents")

    def eps_fn(x, t, **kwargs):
        return unet_fn(x, t, kwargs.get("encoder_hidden_states"), kwargs.get("encoder_attention_mask"),
                       kwargs.get("added_cond"))

    model = denoiser_cls(model_fn=eps_fn, schedule=schedule.to(x_init.device))
    height, width = x_init.shape[1] * vae_downscale, x_init.shape[2] * vae_downscale
    if cfg_scale == 0.0:
        cfg_fn = cond_text_wrapper(neg_prompt, width, height, model, te, time_ids)
    elif cfg_scale == 1.0 and not use_cfgpp:
        cfg_fn = cond_text_wrapper(prompt, width, height, model, te, time_ids)
    else:
        cfg_fn = cfg_wrapper(prompt, neg_prompt, width, height, model, te, cfg_scale, time_ids)

    sigmas = euler_latent_sigmas(schedule, num_steps, image_to_noise)
    if image_to_noise:
        if noise is None:
            noise = torch.randn(x_init.shape, generator=seeded_generator(seed, x_init.device),
                                device=x_init.device, dtype=x_init.dtype)
        x_init = x_init + float(sigmas[0]) * noise
    sampler = sample_euler_ancestral_cfgpp if use_cfgpp and cfg_scale != 0.0 else sample_euler_ancestral
    return sampler(cfg_fn, x_init, sigmas, image_to_noise=image_to_noise, eta=0.0)
