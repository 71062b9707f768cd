"""Serving: a text-to-image pipeline and a continuous-batching server
(``uwudiff_tpu/serving.py``), and the Flux stack.

``Txt2ImgPipeline`` binds the UNet, the text encoders, the VAE, a sampler
(default Euler-ancestral) and a sigma-space wrapper on one device;
``sample_device`` enqueues a whole request batch (encode and CFG sampling
through the generic entry point ``sampling.diffusion_sampling``, then a
uint8 decode, tiled with ``vae_tiling``) without waiting on the device, so
``BatchingServer``'s fetch thread copies one batch's images to the host
while the dispatcher enqueues the next. Any other ``diffusion_sampling``
argument (a ladder's ``get_sigma_func``, ``cfg_interval``, ``rescale``)
goes to ``sample_device`` or a call of the pipeline as a keyword and on to
``diffusion_sampling``; a request's ``prompt_weighting`` and
``long_prompt`` too; skip-layer guidance (``unet_skip_fn``, ``slg_scale``,
``slg_interval``) the same way. ``sdxl_pipeline`` builds SDXL with random
weights or from one single-file checkpoint and CLIP's vocabulary files;
``sd3_pipeline`` builds SD3-medium (the MMDiT, CLIP-L + CLIP-bigG + T5-XXL,
the 16-channel VAE, the shifted RF ladder) with random weights or from its
per-component diffusers-layout files and its tokenizer files; both take
``quantize_weights=`` and serve LoRA/LoKr adapters.

``Txt2ImgPipeline(quantize_weights=True)`` holds the denoiser's weights as
int8 plus fp32 scales on the device, each dequantized where it is used
(``ops/quantize.py``); the text encoders and the VAE stay as they are.
``register_adapter`` / ``set_adapter`` swap LoRA/LoKr adapters
(``training/adapters.py``, kohya files through ``training/kohya_lora.py``)
by writing the merged (under int8: requantized) values into the tensors
the denoiser already holds, so no tensor is reallocated and every
``data_ptr`` stays; ``Request.adapter`` routes a request to one, the
server grouping by it. Latent sharding is not ported (ROADMAP.md, Queue 1
item 17).

``flux_txt2img`` builds ``flux_dev`` with T5-XXL, CLIP-L and the
16-channel decoder, random or from their files; :class:`FluxTxt2Img`
serves it through the generic entry point ``sampling.diffusion_sampling``
as the JAX package does (``tests/test_flux.py``): ``RFDenoiser``, cfg 1 with the distilled
guidance embedded, the dynamic-shift RF ladder.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
from torch import nn

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.ops.quantize import (
    Q8_SUFFIX,
    SCALE_SUFFIX,
    is_quantizable,
    quantize_leaf,
    quantize_module_,
    scale_dims,
)
from uwudiff_tpu_torch.sampling.get_sigmas import (
    dynamic_shift_time,
    get_sigmas_for_rf,
    mu_for_image_seq_len,
    shift_time,
)
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral
from uwudiff_tpu_torch.sampling.sampling import diffusion_sampling
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser, RFDenoiser
from uwudiff_tpu_torch.utils import resolve_device, truncate_or_pad_to_length, vae_image_postprocess

__all__ = ["BatchingServer", "FluxTxt2Img", "Request", "SDXL_PAD_TOKENS", "ServerOverloaded", "Txt2ImgPipeline",
           "flux_txt2img", "sd3_pipeline", "sdxl_pipeline"]


def _cycled_prompts(prompt, neg_prompt, n: int):
    """Each prompt list cycled to ``n`` on its own (``diffusion_sampling``
    wants them of one length)."""
    prompt = [prompt] if isinstance(prompt, str) else list(prompt)
    neg_prompt = [neg_prompt] if isinstance(neg_prompt, str) else list(neg_prompt)
    return truncate_or_pad_to_length(prompt, n, "cycling"), truncate_or_pad_to_length(neg_prompt, n, "cycling")


class Txt2ImgPipeline:
    def __init__(
        self,
        unet,  # (x, t, encoder_hidden_states=, encoder_attention_mask=, added_cond=) -> eps, NHWC
        te_pipeline,  # TextEncodingPipeline
        vae=None,  # AutoencoderKL (decode) or None -> latents only
        schedule: NoiseSchedule | None = None,  # None -> NoiseSchedule.sdxl()
        device="cuda",
        sampler=sample_euler_ancestral,  # any sampler of sampling/ (sampling.SAMPLERS)
        denoiser_cls: type | None = None,  # None -> KDiffusionDenoiser; LCMDenoiser with sampler=sample_lcm, cfg 1
        vae_tiling: int | None = None,  # decode in tiles of this many latents (AutoencoderKL.decode_tiled)
        vae_std: float | None = None,  # None -> 1 / vae.scaling_factor (1 without a VAE)
        vae_mean: float = 0.0,  # the latents' shift (SD3's and Flux's shift_factor)
        get_sigma_func=None,  # the default ladder, num_steps -> sigmas; None -> the schedule's
        quantize_weights: bool = False,  # the denoiser's weights held as int8 + fp32 scales (ops/quantize.py)
    ):
        self.device = resolve_device(device)
        self.unet = unet
        # the base value of every weight an adapter has touched: on the
        # weight's device in bf16 (read at the weight's first swap); under
        # int8, of every quantized weight, read before it is quantized and
        # kept on the host (pinned), so the card holds only the int8 form
        self._base: dict[str, torch.Tensor] = {}
        self._quantized: set[str] = set()
        if quantize_weights:
            self._base = {name: _host_copy(p) for name, p in unet.named_parameters() if is_quantizable(p)}
            self._quantized = set(quantize_module_(unet))
        self._adapters: dict = {}
        self._active_adapter: tuple | None = None  # the names set_adapter last merged; None: the base
        self._adapted: set[str] = set()  # the weights that hold a merge now
        self.te = te_pipeline
        self.vae = vae
        self.sampler = sampler
        self.denoiser_cls = denoiser_cls or KDiffusionDenoiser
        self.vae_tiling = vae_tiling
        self._host_schedule = schedule if schedule is not None else NoiseSchedule.sdxl()
        self.schedule = self._host_schedule.to(self.device)
        # latents are normalised as in training: (x - vae_mean) / vae_std
        if vae_std is None:
            vae_std = 1.0 / vae.scaling_factor if vae is not None else 1.0
        self.vae_std, self.vae_mean = vae_std, vae_mean
        self.get_sigma_func = get_sigma_func
        self.vae_downscale = vae.downscale if vae is not None else 8
        self.latent_channels = vae.latent_channels if vae is not None else 4
        self._sigma_cache: dict[int, np.ndarray] = {}

    def sigmas(self, num_steps: int) -> np.ndarray:
        """Host-cached fp32 sigma ladder for ``num_steps``: ``get_sigma_func``'s,
        else the schedule's."""
        sig = self._sigma_cache.get(num_steps)
        if sig is None:
            if self.get_sigma_func is not None:
                sig = np.asarray(self.get_sigma_func(num_steps), np.float32)
            else:
                sig = self._host_schedule.sample_sigmas_descending(num_steps).numpy()
            self._sigma_cache[num_steps] = sig
        return sig

    def decode(self, latents):
        """[-1, 1] images of ``latents``, tiled with ``vae_tiling``."""
        if self.vae_tiling:
            return self.vae.decode_tiled(latents, tile=self.vae_tiling)
        return self.vae.decode(latents)

    def __call__(self, prompt, neg_prompt="", num_steps: int = 16, num_samples: int = 1,
                 cfg_scale: float = 3.0, width: int = 1024, height: int = 1024, seed=42,
                 return_latents: bool = False, cfg_rescale: float = 0.0, **kwargs):
        """Blocking: a list of uint8 HWC images, or the latents array, on
        the host. ``kwargs`` go to :func:`diffusion_sampling`."""
        out, is_images = self.sample_device(
            prompt, neg_prompt, num_steps=num_steps, num_samples=num_samples,
            cfg_scale=cfg_scale, width=width, height=height, seed=seed,
            return_latents=return_latents, cfg_rescale=cfg_rescale, **kwargs,
        )
        host = out.cpu().numpy()
        return [vae_image_postprocess(img) for img in host] if is_images else host

    @torch.inference_mode()
    def sample_device(self, prompt, neg_prompt="", num_steps: int = 16, num_samples: int = 1,
                      cfg_scale: float = 3.0, width: int = 1024, height: int = 1024, seed=42,
                      return_latents: bool = False, cfg_rescale: float = 0.0, **kwargs):
        """The request path, asynchronous: returns ``(device tensor,
        is_images)`` without waiting for the device. ``seed`` is an int
        (sample j uses seed+j) or a per-sample sequence. The latents come
        from :func:`diffusion_sampling`, with ``kwargs`` (by default on the
        cached ladder, so nothing waits); the decode is rounded to uint8
        on the device."""
        kwargs.setdefault("get_sigma_func", self.sigmas)
        latents = diffusion_sampling(
            self.unet, self.te, None, self.schedule, *_cycled_prompts(prompt, neg_prompt, num_samples),
            num_steps=num_steps, num_samples=num_samples, cfg_scale=cfg_scale, cfg_rescale=cfg_rescale,
            seed=seed, width=width, height=height, vae_std=self.vae_std, vae_mean=self.vae_mean,
            latent_channels=self.latent_channels,
            vae_downscale=self.vae_downscale, internal_sampling_func=self.sampler, denoiser_cls=self.denoiser_cls,
            return_latents=True, **kwargs,
        )
        if return_latents or self.vae is None:
            return latents, False
        images = self.decode(latents)
        return ((images.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8), True

    def warmup(self, widths_heights_batches, num_steps: int = 16):
        """Run each (width, height, batch) signature once (allocator and
        cuDNN algorithm caches warm before the first request)."""
        for w, h, b in widths_heights_batches:
            self(prompt="warmup", num_steps=num_steps, num_samples=b, width=w, height=h,
                 return_latents=self.vae is None)

    # -- adapter hot-swap --

    def register_adapter(self, name: str, adapter) -> "Txt2ImgPipeline":
        """Register a ``training.adapters.LycorisAdapter`` (``create``d, ``load``ed
        from an ``.npz`` or from a kohya file by ``kohya_lora.load_kohya_lora``)
        for swapping by name; its factors move to the pipeline's device."""
        self._adapters[name] = adapter.to(self.device)
        return self

    def set_adapter(self, adapter=None) -> "Txt2ImgPipeline":
        """Serve ``adapter``: ``None`` (the base), a registered name, a
        ``LycorisAdapter``, or a sequence of those merged in order. Swapping
        to the names already served is free; an adapter object always
        re-merges. Each weight an adapter touched before or touches now is
        rewritten from its base value, merged in order (under int8
        requantized), with ``copy_`` into the tensor the denoiser holds."""
        items = [] if adapter is None else list(adapter) if isinstance(adapter, (list, tuple)) else [adapter]
        names = tuple(a if isinstance(a, str) else f"<adapter@{id(a):x}>" for a in items)
        if items and all(isinstance(a, str) for a in items) and names == self._active_adapter:
            return self
        if not items and self._active_adapter is None:
            return self
        adapters = [self._adapters[a] if isinstance(a, str) else a for a in items]  # unknown names raise here
        touched = set().union(*(a.port_names for a in adapters))
        unknown = touched - self._quantized - dict(self.unet.named_parameters()).keys()
        if unknown:
            raise KeyError(f"adapter weights the denoiser lacks: {sorted(unknown)[:5]}")
        # a swap that fails part way leaves its weights to the next one to rewrite
        self._adapted |= touched
        self._active_adapter = _SWAPPING
        # Every write is queued on the current stream, the one sampling runs
        # on: the previous group's kernels that read these weights are ahead
        # of it there (the server's fetch thread copies that group's output
        # without a sync), so the write needs no sync, and a side stream
        # would race them.
        with torch.no_grad():
            for name in sorted(self._adapted):
                value = self._base_value(name)
                for a in adapters:
                    value = a.merge({name: value})[name]
                self._write(name, value)
        self._adapted = touched
        self._active_adapter = names or None
        return self

    def _base_value(self, name: str) -> torch.Tensor:
        base = self._base.get(name)
        if base is None:  # not touched before: the weight holds its base value
            base = self._base[name] = self.unet.get_parameter(name).detach().clone()
        return base.to(self.device, non_blocking=True)

    def _write(self, name: str, value: torch.Tensor) -> None:
        if name in self._quantized:
            owner_name, _, attr = name.rpartition(".")
            owner = self.unet.get_submodule(owner_name)
            q, scale = quantize_leaf(value, scale_dims(self.unet, name, value.ndim))
            getattr(owner, attr + Q8_SUFFIX).copy_(q)
            getattr(owner, attr + SCALE_SUFFIX).copy_(scale)
        else:
            self.unet.get_parameter(name).copy_(value)


_SWAPPING = object()  # set_adapter's marker while it writes: equal to no adapter names and not None


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host, pinned where ``t`` is on the card (so the
    copies back are asynchronous). Detached: a ``copy_`` from a parameter
    under grad mode would record a graph that keeps the parameter, and its
    card memory, alive."""
    t = t.detach()
    if t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.clone()


# CLIP-L pads with its EOS, SDXL's second tokenizer (the published tokenizer_2) with "!"
SDXL_PAD_TOKENS = (None, "!")


def sdxl_pipeline(device="cuda", dtype=torch.bfloat16, seed: int = 0, ckpt_path: str | None = None,
                  tokenizer_files=None, load_timings: dict | None = None, **pipeline_kw) -> Txt2ImgPipeline:
    """The SDXL serving stack at full width on ``device`` in ``dtype``: the
    ``sdxl`` UNet, ``clip_l`` + ``clip_bigg`` (``layer_idx=-2``, pooled from
    bigG), the ``sdxl`` VAE (encoder and decoder), ``NoiseSchedule.sdxl()``.
    The weights are random from ``seed``, or with ``ckpt_path`` read from one
    single-file A1111-layout checkpoint (``model.diffusion_model.*``,
    ``first_stage_model.*``, ``conditioner.embedders.{0,1}.*``): the file is
    read and split once (``loader.read_single_file``), the modules are built
    on ``meta`` and allocated on ``device`` without drawing weights, and each
    component is imported strictly (bigG's projection width is the file's).
    The tokenizers hash words, or with ``tokenizer_files`` (one ``(vocab.json, merges.txt)`` pair for each
    tower) are ``CLIPBPETokenizer``s padding as SDXL's do.
    ``load_timings`` gains the load's ``read``, ``map`` and ``copy`` seconds;
    ``pipeline_kw`` go to :class:`Txt2ImgPipeline` (``sampler``,
    ``denoiser_cls``, ``vae_tiling``, ``quantize_weights``)."""
    from uwudiff_tpu_torch.loader import read_single_file
    from uwudiff_tpu_torch.models import (
        AutoencoderKL,
        CLIPBPETokenizer,
        ConcatTextEncoders,
        SimpleTokenizer,
        TextEncodingPipeline,
        UNet2DConditionModel,
    )

    dev = resolve_device(device)
    bigg = {"preset": "clip_bigg"}
    build = dev
    if ckpt_path is not None:
        parts = read_single_file(ckpt_path, load_timings)
        tes = parts.get("text_encoders", [])
        if len(tes) != 2 or "unet" not in parts or "vae" not in parts:
            raise ValueError(f"{ckpt_path!r} is not an SDXL checkpoint: components {sorted(parts)},"
                             f" {len(tes)} text encoder(s)")
        if "text_projection.weight" in tes[1]:
            bigg["projection_dim"] = int(tes[1]["text_projection.weight"].shape[0])
        build = torch.device("meta")
    torch.manual_seed(seed)
    unet = UNet2DConditionModel.from_config("sdxl", device=build, dtype=dtype)
    te = ConcatTextEncoders.from_config(
        [({"preset": "clip_l"}, {"use_pooled": False, "layer_idx": -2}),
         (bigg, {"use_pooled": True, "layer_idx": -2})],
        device=build, dtype=dtype,
    )
    vae = AutoencoderKL.from_config("sdxl", device=build, dtype=dtype)
    if ckpt_path is not None:
        from uwudiff_tpu_torch.models import import_torch as it

        for module in (unet, te, vae):
            module.to_empty(device=dev)
        clip_l, clip_bigg = te.text_models
        for module, key_map, part in ((unet, it.unet_key_map, parts["unet"]), (vae, it.vae_key_map, parts["vae"]),
                                      (clip_l, it.clip_text_key_map, tes[0]),
                                      (clip_bigg, it.clip_text_key_map, tes[1])):
            module.loaded_keys = it.import_params(module, part, key_map, strict=True, timings=load_timings)
    if tokenizer_files is None:
        tokenizers = [SimpleTokenizer(), SimpleTokenizer()]
    else:
        tokenizers = [CLIPBPETokenizer(vocab, merges, pad_token=pad)
                      for (vocab, merges), pad in zip(tokenizer_files, SDXL_PAD_TOKENS, strict=True)]
    te_pipe = TextEncodingPipeline(te, tokenizers, device=dev)
    return Txt2ImgPipeline(unet, te_pipe, vae, NoiseSchedule.sdxl(), device=dev, **pipeline_kw)


class MaxLengthPadding:
    """A tokenizer whose every call pads to its ``model_max_length``, as SD3's
    and Flux's T5 prompts are padded (diffusers' ``max_sequence_length``):
    one context length for every batch. The padded keys are masked, so the
    output does not depend on it."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def __getattr__(self, name):
        return getattr(self.tokenizer, name)

    def __call__(self, text, padding=True, **kwargs):
        del padding
        return self.tokenizer(text, padding="max_length", **kwargs)


def _text_tokenizers(tokenizer_files, clip_pads, t5_tokens: int):
    """``CLIPBPETokenizer``s over ``(vocab.json, merges.txt)`` pairs, padding
    with ``clip_pads``, then a ``T5SPTokenizer`` over a ``spiece.model`` (or
    ``tokenizer.json``) padding to ``t5_tokens``; hash tokenizers of the same
    lengths without ``tokenizer_files``."""
    from uwudiff_tpu_torch.models import CLIPBPETokenizer, SimpleTokenizer, T5SPTokenizer

    if tokenizer_files is None:
        return [SimpleTokenizer() for _ in clip_pads] + [SimpleTokenizer(model_max_length=t5_tokens)]
    *clip_files, t5_file = tokenizer_files
    return ([CLIPBPETokenizer(vocab, merges, pad_token=pad)
             for (vocab, merges), pad in zip(clip_files, clip_pads, strict=True)]
            + [MaxLengthPadding(T5SPTokenizer(t5_file, model_max_length=t5_tokens))])


def _load_components(modules: dict, component_files: dict, device, timings: dict | None):
    """Each ``name -> (module built on meta, importer)`` allocated on
    ``device`` and filled strictly from ``component_files[name]``, a
    diffusers-layout file read once through ``loader.apply_load_config``
    (each leaf a view of the mapped file, copied once)."""
    from uwudiff_tpu_torch.loader import ModelLoadConfig, apply_load_config

    missing = sorted(set(modules) - set(component_files))
    if missing:
        raise ValueError(f"component_files lacks {missing} (has {sorted(component_files)})")
    for name, (module, importer) in modules.items():
        module.to_empty(device=device)
        apply_load_config(module, ModelLoadConfig(component_files[name], importer=importer), timings)


# stabilityai/stable-diffusion-3-medium-diffusers' vae/config.json: the SDXL
# decoder's widths at 16 latent channels, scaling_factor 1.5305 (vae_std =
# 1 / it), shift_factor 0.0609
SD3_VAE = dict(block_out_channels=(128, 256, 512, 512), layers_per_block=2, latent_channels=16,
               scaling_factor=1.5305)
SD3_VAE_SHIFT = 0.0609
SD3_T5_TOKENS = 256  # configs/demo_training_latent_sd3.yaml's T5 bucket (diffusers' max_sequence_length)
SD3_SHIFT = 3.0  # configs/sampling/demo_sampling_mmdit.yaml's shift_time
SD3_MAX_SIGMA = 14.6146  # the RF ladder's top: the SDXL schedule's largest sigma


def sd3_sigmas(num_steps: int) -> np.ndarray:
    """SD3's ladder: ``get_sigmas_for_rf`` warped by ``shift_time(shift=3.0)``."""
    return get_sigmas_for_rf(num_steps, SD3_MAX_SIGMA, time_disc_func=functools.partial(shift_time, shift=SD3_SHIFT))


def sd3_pipeline(device="cuda", dtype=torch.bfloat16, seed: int = 0, component_files: dict | None = None,
                 tokenizer_files=None, load_timings: dict | None = None, **pipeline_kw) -> Txt2ImgPipeline:
    """SD3-medium served at full width on ``device`` in ``dtype``
    (``configs/sampling/demo_sampling_mmdit.yaml``'s stack at the
    ``sd3_medium`` preset, with ``demo_training_latent_sd3.yaml``'s T5
    bucket): the ``sd3_medium`` MMDiT; CLIP-L and CLIP-bigG pooled
    (``layer_idx=-2``) in bucket 0 and T5-XXL at 256 tokens with its key mask
    in bucket 1 (``training.bench_setup.SD3_TEXT_ENCODERS``,
    ``zero_for_padding=False``, ``pad_context_to=4096``); the 16-channel
    VAE with its shift; ``NoiseSchedule.sdxl()``, ``RFDenoiser`` and
    :func:`sd3_sigmas`. Skip-layer guidance goes on a call:
    ``pipe(prompt, unet_skip_fn=functools.partial(pipe.unet, skip_layers=(7,
    8, 9)), slg_scale=2.5, slg_interval=(lo, hi))``.

    The weights are random from ``seed`` (the MMDiT's zero-initialised
    leaves drawn by ``fill_zero_initialised``), or with ``component_files``
    read from diffusers-layout files: ``{"transformer": ..., "text_encoder":
    CLIP-L, "text_encoder_2": CLIP-bigG, "text_encoder_3": T5-XXL, "vae":
    ...}``, each read once into modules built on ``meta``. The tokenizers
    hash words, or with ``tokenizer_files`` (``[(vocab.json, merges.txt),
    (vocab.json, merges.txt), spiece.model]``) are ``CLIPBPETokenizer``s
    padding as SDXL's and a ``T5SPTokenizer``. ``load_timings`` gains the
    load's ``read``, ``map`` and ``copy`` seconds; ``pipeline_kw`` go to
    :class:`Txt2ImgPipeline` (``quantize_weights=True``: the MMDiT as int8)."""
    from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders, MMDiT, TextEncodingPipeline
    from uwudiff_tpu_torch.training.bench_setup import SD3_TEXT_ENCODERS, fill_zero_initialised

    dev = resolve_device(device)
    build = dev if component_files is None else torch.device("meta")
    torch.manual_seed(seed)
    mmdit = MMDiT.from_config("sd3_medium", device=build, dtype=dtype)
    te = ConcatTextEncoders.from_config(SD3_TEXT_ENCODERS, device=build, dtype=dtype, zero_for_padding=False,
                                        pad_context_to=4096)
    vae = AutoencoderKL.from_config(SD3_VAE, device=build, dtype=dtype)
    if component_files is None:
        fill_zero_initialised(mmdit)
    else:
        clip_l, clip_bigg, t5 = te.text_models
        _load_components({"transformer": (mmdit, "mmdit"), "text_encoder": (clip_l, "clip"),
                          "text_encoder_2": (clip_bigg, "clip"), "text_encoder_3": (t5, "t5"), "vae": (vae, "vae")},
                         component_files, dev, load_timings)
    te_pipe = TextEncodingPipeline(te, _text_tokenizers(tokenizer_files, SDXL_PAD_TOKENS, SD3_T5_TOKENS), device=dev)
    pipeline_kw.setdefault("denoiser_cls", RFDenoiser)
    return Txt2ImgPipeline(mmdit, te_pipe, vae, NoiseSchedule.sdxl(), device=dev, vae_mean=SD3_VAE_SHIFT,
                           get_sigma_func=sd3_sigmas, **pipeline_kw)


# black-forest-labs/FLUX.1-dev's vae/config.json: the SDXL decoder's widths at
# 16 latent channels, scaling_factor 0.3611 (vae_std = 1 / it), shift_factor 0.1159
FLUX_VAE = dict(block_out_channels=(128, 256, 512, 512), layers_per_block=2, latent_channels=16,
                scaling_factor=0.3611)
FLUX_VAE_SHIFT = 0.1159
# CLIP-L in the pooled-only slot (its pooled vector only), T5-XXL's sequence in
# bucket 1 with its key mask (configs/sampling/demo_sampling_flux.yaml's stack)
FLUX_TEXT_ENCODERS = [
    ({"model_type": "clip", "preset": "clip_l"}, {"use_pooled": True, "pooled_only": True}),
    ({"model_type": "t5", "preset": "t5_xxl"}, {"concat_bucket": 1, "need_mask": True}),
]
FLUX_T5_TOKENS = 512  # flux_dev's published max_sequence_length
FLUX_MAX_SIGMA = 14.6146  # the RF ladder's top: the SDXL schedule's largest sigma (demo_sampling_flux.yaml)


@dataclasses.dataclass
class FluxTxt2Img:
    """Flux txt2img on one device through :func:`diffusion_sampling`:
    ``RFDenoiser`` over ``NoiseSchedule.sdxl()``'s timesteps, cfg 1 (the
    guidance is the model's embedded ``default_guidance``), Euler-ancestral
    on ``get_sigmas_for_rf`` warped by ``dynamic_shift_time`` at
    ``mu_for_image_seq_len`` of the request's image tokens."""

    model: nn.Module  # models.Flux
    te: object  # TextEncodingPipeline
    vae: nn.Module  # AutoencoderKL with 16 latent channels

    def sigmas(self, num_steps: int, width: int, height: int) -> np.ndarray:
        patch = self.vae.downscale * self.model.patch_size
        disc = functools.partial(dynamic_shift_time, mu=mu_for_image_seq_len((height // patch) * (width // patch)))
        return get_sigmas_for_rf(num_steps, FLUX_MAX_SIGMA, time_disc_func=disc)

    def __call__(self, prompt, num_steps: int = 4, num_samples: int = 1, seed=42, width: int = 1024,
                 height: int = 1024, return_latents: bool = False):
        """uint8 HWC images (numpy), or with ``return_latents`` the latents
        on the device."""
        prompt = [prompt] if isinstance(prompt, str) else list(prompt)
        return diffusion_sampling(
            self.model, self.te, self.vae.decode, NoiseSchedule.sdxl(), prompt, [""] * len(prompt),
            num_steps=num_steps, num_samples=num_samples, cfg_scale=1.0, seed=seed, width=width, height=height,
            denoiser_cls=RFDenoiser, get_sigma_func=lambda n: self.sigmas(n, width, height),
            vae_std=1.0 / self.vae.scaling_factor, vae_mean=FLUX_VAE_SHIFT, latent_channels=self.model.in_channels,
            vae_downscale=self.vae.downscale, return_latents=return_latents,
        )


def flux_txt2img(device="cuda", dtype=torch.bfloat16, seed: int = 0, component_files: dict | None = None,
                 tokenizer_files=None, load_timings: dict | None = None,
                 flux_config: str | dict = "flux_dev") -> FluxTxt2Img:
    """The Flux serving stack on ``device`` in ``dtype``: ``flux_config``
    (default ``flux_dev``, 11.9 B parameters, made in bf16 with no fp32
    copy; a preset name or a config dict), CLIP-L pooled-only,
    T5-XXL at 512 tokens, the 16-channel decoder. The weights are random
    from ``seed`` (the transformer's zero-initialised leaves stay zero: a
    fresh model outputs zeros; ``training.bench_setup.fill_zero_initialised``
    draws them), or with ``component_files`` read from diffusers-layout
    files (``{"transformer": ..., "text_encoder": CLIP-L, "text_encoder_2":
    T5-XXL, "vae": ...}``) into modules built on ``meta`` (each module's
    every leaf from its file; keys the module lacks are left). The
    tokenizers hash words, or with ``tokenizer_files`` (``[(vocab.json,
    merges.txt), spiece.model]``) are a ``CLIPBPETokenizer`` and a
    ``T5SPTokenizer``. ``load_timings`` gains the load's seconds."""
    from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders, Flux, TextEncodingPipeline

    dev = resolve_device(device)
    build = dev if component_files is None else torch.device("meta")
    torch.manual_seed(seed)
    model = Flux.from_config(flux_config, device=build, dtype=dtype)
    te = ConcatTextEncoders.from_config(FLUX_TEXT_ENCODERS, device=build, dtype=dtype)
    vae = AutoencoderKL.from_config(FLUX_VAE, device=build, dtype=dtype)
    if component_files is not None:
        clip_l, t5 = te.text_models
        _load_components({"transformer": (model, "flux"), "text_encoder": (clip_l, "clip"),
                          "text_encoder_2": (t5, "t5"), "vae": (vae, "vae")}, component_files, dev, load_timings)
    tokenizers = _text_tokenizers(tokenizer_files, (None,), FLUX_T5_TOKENS)
    return FluxTxt2Img(model, TextEncodingPipeline(te, tokenizers, device=dev), vae)


@dataclasses.dataclass
class Request:
    prompt: str
    neg_prompt: str = ""
    width: int = 1024
    height: int = 1024
    num_steps: int = 16
    cfg_scale: float = 3.0
    seed: int = 0
    return_latents: bool = False
    # A1111 (word:1.3) emphasis in prompt and neg_prompt (models/prompt_weights.py)
    prompt_weighting: bool = False
    # prompts past CLIP's 77 positions in windows (models/long_prompt.py);
    # the context's length depends on it
    long_prompt: bool = False
    # a registered adapter's name, or names merged in order; None: the base
    adapter: str | tuple[str, ...] | None = None


class ServerOverloaded(RuntimeError):
    """Admission rejected: the server's unresolved-request load is at
    ``max_queue`` (the HTTP-429 analogue); clients back off and retry."""


class BatchingServer:
    """Continuous request batching over a ``Txt2ImgPipeline``.

    One dispatcher thread drains the queue, groups compatible requests
    (same resolution bucket, step count, cfg scale, output kind, prompt
    weighting, long-prompt setting and adapters; the seed is not in the key,
    since each lane draws from its own seed)
    into batches of up to ``max_batch``, runs one pipeline call per
    group, and a fetch thread resolves each request's Future with its
    own image. Requests snap to the nearest configured bucket. A group
    of n requests runs at the smallest size of the batch-size ladder
    that holds it (default ``(1, max_batch)``), padded with copies of
    its last request. At most ``max_queue`` requests (default
    ``8*max_batch``; ``None`` = unbounded) may be unresolved at once;
    beyond that ``submit`` raises :class:`ServerOverloaded`. A group with
    adapters, or after one, swaps them in (``Txt2ImgPipeline.set_adapter``)
    before it samples; an unknown adapter name fails that group alone.
    """

    def __init__(
        self,
        pipeline,
        buckets=((1024, 1024),),
        max_batch: int = 4,
        max_wait_s: float = 0.05,
        batch_sizes: tuple[int, ...] | None = None,
        max_queue: int | str | None = "default",
    ):
        self.pipeline = pipeline
        self.buckets = [tuple(b) for b in buckets]
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = 8 * max_batch if max_queue == "default" else max_queue
        self._load_lock = threading.Lock()
        self._inflight = 0
        sizes = batch_sizes if batch_sizes is not None else (1, max_batch)
        self.batch_sizes = tuple(sorted({min(int(s), max_batch) for s in sizes} | {max_batch}))
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._running = False
        self._fetch_queue: queue.Queue = queue.Queue()
        self._fetch_thread: threading.Thread | None = None

    # -- lifecycle --

    def start(self, warmup_steps: int | None = None):
        if warmup_steps:
            self.pipeline.warmup(
                [(w, h, b) for (w, h) in self.buckets for b in self.batch_sizes],
                num_steps=warmup_steps,
            )
        self._running = True
        self._fetch_thread = threading.Thread(target=self._fetch_loop, daemon=True)
        self._fetch_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._fetch_thread is not None:
            self._fetch_queue.put(None)
            self._fetch_thread.join()
            self._fetch_thread = None

    # -- client API --

    def nearest_bucket(self, w: int, h: int) -> tuple[int, int]:
        # relative (log-space) area + aspect distance, unit-free
        return min(
            self.buckets,
            key=lambda b: abs(math.log((b[0] * b[1]) / (w * h)))
            + abs(math.log((b[0] / b[1]) / (w / h))),
        )

    def load(self) -> int:
        """Unresolved requests right now (queued + grouped + on device)."""
        with self._load_lock:
            return self._inflight

    def _dec_inflight(self, _fut):
        with self._load_lock:
            self._inflight -= 1

    def submit(self, request: Request) -> Future:
        fut: Future = Future()
        if self.max_queue is not None:
            with self._load_lock:
                if self._inflight >= self.max_queue:
                    raise ServerOverloaded(
                        f"server at max_queue={self.max_queue} unresolved requests; "
                        "retry with backoff"
                    )
                self._inflight += 1
            fut.add_done_callback(self._dec_inflight)
        self._queue.put((request, fut))
        return fut

    # -- dispatcher --

    def _group_key(self, r: Request):
        w, h = self.nearest_bucket(r.width, r.height)
        adapter = (r.adapter,) if isinstance(r.adapter, str) else tuple(r.adapter) if r.adapter is not None else None
        return (w, h, r.num_steps, r.cfg_scale, r.return_latents, r.prompt_weighting, r.long_prompt, adapter)

    def _loop(self):
        pending: list = []
        while self._running or pending:
            if not pending:
                item = self._queue.get()
                if item is None:
                    break
                pending.append(item)
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    self._running = False
                    break
                pending.append(item)
            key0 = self._group_key(pending[0][0])
            group = [p for p in pending if self._group_key(p[0]) == key0][: self.max_batch]
            pending = [p for p in pending if p not in group]
            self._run_group(key0, group)

        # drained by shutdown: fail the leftovers instead of hanging their waiters
        leftovers = pending
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        for _, fut in leftovers:
            if not fut.done():
                fut.set_exception(RuntimeError("BatchingServer stopped"))

    def _run_group(self, key, group):
        w, h, steps, cfg, return_latents, prompt_weighting, long_prompt, adapter = key
        reqs = [r for r, _ in group]
        futs = [f for _, f in group]
        n_real = len(reqs)
        size = next((s for s in self.batch_sizes if s >= n_real), self.max_batch)
        pad = size - n_real
        kwargs = dict(
            prompt=[r.prompt for r in reqs] + [reqs[-1].prompt] * pad,
            neg_prompt=[r.neg_prompt for r in reqs] + [reqs[-1].neg_prompt] * pad,
            num_steps=steps,
            num_samples=size,
            cfg_scale=cfg,
            width=w,
            height=h,
            seed=[r.seed for r in reqs] + [reqs[-1].seed] * pad,
            return_latents=return_latents,
            prompt_weighting=prompt_weighting,
            long_prompt=long_prompt,
        )
        try:
            if adapter is not None or getattr(self.pipeline, "_active_adapter", None) is not None:
                self.pipeline.set_adapter(list(adapter) if adapter is not None else None)
            # asynchronous: hand the pending device tensor to the fetch
            # thread and go on to the next group
            out, is_images = self.pipeline.sample_device(**kwargs)
            self._fetch_queue.put((out, is_images, futs))
        except Exception as e:  # surfaced to every caller of the group
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _fetch_loop(self):
        while True:
            item = self._fetch_queue.get()
            if item is None:
                break
            out, is_images, futs = item
            try:
                host = out.cpu().numpy()  # one device->host copy per group
                for i, fut in enumerate(futs):
                    fut.set_result(vae_image_postprocess(host[i]) if is_images else host[i])
            except Exception as e:  # surfaced to every caller of the group
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
