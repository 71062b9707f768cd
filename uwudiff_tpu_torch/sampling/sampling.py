"""End-to-end text-to-image sampling (``uwudiff_tpu/sampling/sampling.py``).

:func:`diffusion_sampling` is the JAX package's generic entry point: any
model (the UNet, the MMDiT, Flux) behind a sigma-space wrapper
(``denoiser_cls``), any sampler of ``sampling/`` (``internal_sampling_func``,
default Euler-ancestral) on the training schedule's ladder, a second
schedule's (``sample_schedule``) or a caller's (``get_sigma_func``: the
ladders of ``sampling/get_sigmas.py``, ``lcm.get_sigmas_lcm``), CFG (only
inside ``cfg_interval`` if given) or a single conditional pass at
``cfg_scale == 1``, skip-layer guidance (``unet_skip_fn`` with
``slg_scale``, optionally only inside ``slg_interval``), per-sample seeds
(``sampling/noise.py``), the latents optionally rescaled to unit std per
sample, de-normalised by
``vae_std``/``vae_mean`` and decoded by ``vae_decode``. Flux's call:
``denoiser_cls=RFDenoiser``, ``cfg_scale=1.0``, the dynamic-shift RF
ladder, 16 latent channels.

The JAX function compiles the sigma loop into one program; the port runs
it eagerly (``jit_compile`` is accepted and has no effect). Arguments of
modules not ported yet raise ``NotImplementedError``.

:func:`class_conditional_sampling` is the DiT family's entry point: class
labels instead of prompts (one sample a label), the learned null class as
CFG's unconditional branch (``cfg.py::build_class_cfg_fn``), the same
samplers, ladders, denoisers and decode.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.sampling.cfg import build_cfg_fn, build_class_cfg_fn, build_slg_cfg_fn, encode_cfg_inputs
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral
from uwudiff_tpu_torch.sampling.noise import (
    batch_fallback_generator,
    expand_seeds,
    make_per_sample_noise_sampler,
    per_sample_init_noise,
    supports_noise_sampler,
)
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser
from uwudiff_tpu_torch.utils import resolve_device, truncate_or_pad_to_length, vae_image_postprocess

__all__ = ["class_conditional_sampling", "diffusion_sampling"]

# argument -> (its value that asks for nothing, the ROADMAP item that ports it)
_UNPORTED = {
    "latent_sharding": (None, "Queue 1 item 17"),
}


@torch.inference_mode()
def diffusion_sampling(
    unet_fn: Callable,  # (x, t, ctx, mask, added_cond) -> model output, or (params, x, ...) with unet_params
    te,  # TextEncodingPipeline; the sampling runs on its device
    vae_decode: Callable | None,  # latents -> [-1, 1] images [B, H, W, 3], or None
    train_schedule: NoiseSchedule,
    prompt,
    neg_prompt,
    num_steps: int = 16,
    sample_schedule: NoiseSchedule | None = None,
    get_sigma_func: Callable | None = None,
    num_samples: int = 1,
    padding_mode: str = "cycling",
    cfg_scale: float = 3.0,
    cfg_rescale: float = 0.0,
    seed=42,
    width: int = 1024,
    height: int = 1024,
    rescale: bool = False,
    vae_std: float | None = None,
    vae_mean: float | None = None,
    latent_channels: int = 4,
    vae_downscale: int = 8,
    internal_sampling_func: Callable | None = None,
    return_latents: bool = False,
    jit_compile: bool = True,
    unet_params=None,
    denoiser_cls: type = KDiffusionDenoiser,
    prompt_weighting: bool = False,
    long_prompt: bool = False,
    cfg_interval: tuple[float, float] | None = None,
    unet_skip_fn: Callable | None = None,
    slg_scale: float = 0.0,
    slg_interval: tuple[float, float] | None = None,
    latent_sharding=None,
):
    """Encode, sample and decode one batch of ``num_samples``. Returns the
    latents ``[B, h, w, latent_channels]`` (fp32, on the device) with
    ``return_latents`` or no ``vae_decode``, else a list of uint8 HWC numpy
    images. ``seed`` is an int (sample j uses seed + j) or one per sample.
    ``train_schedule`` may lie on the device already; with it there and a
    ``get_sigma_func``, nothing here waits for the device. The sampler gets
    the per-sample ``noise_sampler`` where it takes one
    (``supports_noise_sampler``), and a seed-derived ``generator`` always.
    ``unet_skip_fn`` (called as ``unet_fn`` is: the same weights with blocks
    bypassed, e.g. ``functools.partial(mmdit, skip_layers=(7, 8, 9))``) with
    a non-zero ``slg_scale`` adds skip-layer guidance
    (:func:`build_slg_cfg_fn`); with ``slg_scale == 0`` it is unused."""
    del jit_compile  # eager
    given = dict(latent_sharding=latent_sharding)
    for name, (unset, item) in _UNPORTED.items():
        if given[name] != unset:
            raise NotImplementedError(f"diffusion_sampling: {name} is not ported yet (ROADMAP.md, {item})")
    device = te.device

    prompt = [prompt] if isinstance(prompt, str) else list(prompt)
    neg_prompt = [neg_prompt] if isinstance(neg_prompt, str) else list(neg_prompt)
    if len(prompt) != len(neg_prompt):
        raise ValueError(f"{len(prompt)} prompts for {len(neg_prompt)} negative prompts")
    prompt = truncate_or_pad_to_length(prompt, num_samples, padding_mode)
    neg_prompt = truncate_or_pad_to_length(neg_prompt, num_samples, padding_mode)
    enc = encode_cfg_inputs(prompt, neg_prompt, width, height, te, prompt_weighting=prompt_weighting,
                            long_prompt=long_prompt)

    schedule = train_schedule.to(device)

    def bind(fn):
        def model_fn(x, t, encoder_hidden_states=None, encoder_attention_mask=None, added_cond=None):
            args = (x, t, encoder_hidden_states, encoder_attention_mask, added_cond)
            return fn(unet_params, *args) if unet_params is not None else fn(*args)

        return denoiser_cls(model_fn=model_fn, schedule=schedule)

    if slg_scale and unet_skip_fn is not None:
        cfg_fn = build_slg_cfg_fn(bind(unet_fn), bind(unet_skip_fn), enc, cfg_scale, slg_scale, cfg_rescale,
                                  slg_interval=slg_interval)
    else:
        cfg_fn = build_cfg_fn(bind(unet_fn), enc, cfg_scale, cfg_rescale, cfg_interval=cfg_interval)
    return _sample_and_decode(cfg_fn, device, num_samples, num_steps, train_schedule, sample_schedule,
                              get_sigma_func, seed, (height // vae_downscale, width // vae_downscale, latent_channels),
                              internal_sampling_func, rescale, vae_std, vae_mean, vae_decode, return_latents)


def _sample_and_decode(cfg_fn, device, num_samples, num_steps, train_schedule, sample_schedule, get_sigma_func, seed,
                       shape, internal_sampling_func, rescale, vae_std, vae_mean, vae_decode, return_latents):
    """What the two entry points share after the guided model fn: the ladder
    (the caller's ``get_sigma_func``, else ``sample_schedule``'s or the
    training schedule's), the per-sample seeds' init noise scaled to the
    first sigma, the sampler (with the per-sample ``noise_sampler`` where it
    takes one and a seed-derived ``generator``), ``rescale``, the latents'
    de-normalisation and the decode."""
    internal_sampling_func = internal_sampling_func or sample_euler_ancestral
    vae_std = vae_std if vae_std is not None else 1.0
    vae_mean = vae_mean or 0.0
    if get_sigma_func is None:
        schedule = sample_schedule if sample_schedule is not None else train_schedule
        sigmas = schedule.sample_sigmas_descending(num_steps).numpy()
    else:
        sigmas = np.asarray(get_sigma_func(num_steps), np.float32)
    seeds = expand_seeds(seed, num_samples)
    init_x = per_sample_init_noise(seeds, shape, device) * float(np.sqrt(np.float32(1.0) + sigmas[0] ** 2))
    kw = {"noise_sampler": make_per_sample_noise_sampler(seeds, device)} if supports_noise_sampler(
        internal_sampling_func) else {}
    latents = internal_sampling_func(cfg_fn, init_x, sigmas, generator=batch_fallback_generator(seeds, device), **kw)
    if rescale:
        latents = latents / latents.reshape(latents.shape[0], -1).std(dim=1, unbiased=False)[:, None, None, None]
    latents = latents * vae_std
    if vae_mean:
        latents = latents + vae_mean
    if return_latents or vae_decode is None:
        return latents
    return [vae_image_postprocess(img) for img in vae_decode(latents).cpu().numpy()]


@torch.inference_mode()
def class_conditional_sampling(
    unet_fn: Callable,  # (x, t, class_labels) -> model output, or (params, x, t, class_labels) with unet_params
    train_schedule: NoiseSchedule,
    class_labels,  # [N] ints: one sample a label
    null_label: int,  # the null class of CFG and label dropout (the DiT's num_classes)
    vae_decode: Callable | None = None,
    num_steps: int = 16,
    sample_schedule: NoiseSchedule | None = None,
    get_sigma_func: Callable | None = None,
    cfg_scale: float = 4.0,
    cfg_rescale: float = 0.0,
    seed=42,
    width: int = 256,
    height: int = 256,
    rescale: bool = False,
    vae_std: float | None = None,
    vae_mean: float | None = None,
    latent_channels: int = 4,
    vae_downscale: int = 8,
    internal_sampling_func: Callable | None = None,
    return_latents: bool = False,
    jit_compile: bool = True,
    unet_params=None,
    denoiser_cls: type = KDiffusionDenoiser,
    latent_sharding=None,
    device="cuda",
):
    """Sample one batch, a sample per label, on ``device``. Returns the
    latents ``[N, h, w, latent_channels]`` (fp32, on the device) with
    ``return_latents`` or no ``vae_decode``, else a list of uint8 HWC numpy
    images. ``seed`` is an int (sample j uses seed + j) or one per sample,
    drawn as :func:`diffusion_sampling` draws (the JAX function draws one
    batch from one key instead; the tests feed its draws to the port)."""
    del jit_compile  # eager
    if latent_sharding is not None:
        raise NotImplementedError("class_conditional_sampling: latent_sharding is not ported yet"
                                  " (ROADMAP.md, Queue 1 item 17)")
    device = resolve_device(device)
    labels = torch.as_tensor(np.asarray(class_labels, np.int64).reshape(-1), device=device)

    def model_fn(x, t, class_labels=None):
        args = (x, t, class_labels)
        return unet_fn(unet_params, *args) if unet_params is not None else unet_fn(*args)

    cfg_fn = build_class_cfg_fn(denoiser_cls(model_fn=model_fn, schedule=train_schedule.to(device)), labels,
                                null_label, cfg_scale, cfg_rescale)
    return _sample_and_decode(cfg_fn, device, labels.shape[0], num_steps, train_schedule, sample_schedule,
                              get_sigma_func, seed, (height // vae_downscale, width // vae_downscale, latent_channels),
                              internal_sampling_func, rescale, vae_std, vae_mean, vae_decode, return_latents)
