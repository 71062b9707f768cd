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
``diffusion_sampling``. Adapter hot-swap, int8 weights and latent sharding
come with the modules they need.

``flux_txt2img`` builds ``flux_dev`` (or another Flux preset) with T5-XXL,
CLIP-L and the 16-channel decoder; :class:`FluxTxt2Img` serves it through
the generic entry point ``sampling.diffusion_sampling`` as the JAX package
does (``tests/test_flux.py``): ``RFDenoiser``, cfg 1 with the distilled
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
from uwudiff_tpu_torch.sampling.get_sigmas import dynamic_shift_time, get_sigmas_for_rf, mu_for_image_seq_len
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral
from uwudiff_tpu_torch.sampling.sampling import diffusion_sampling
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser, RFDenoiser
from uwudiff_tpu_torch.utils import resolve_device, truncate_or_pad_to_length, vae_image_postprocess

__all__ = ["BatchingServer", "FluxTxt2Img", "Request", "ServerOverloaded", "Txt2ImgPipeline", "flux_txt2img",
           "sdxl_pipeline"]


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
    ):
        self.device = resolve_device(device)
        self.unet = unet
        self.te = te_pipeline
        self.vae = vae
        self.sampler = sampler
        self.denoiser_cls = denoiser_cls or KDiffusionDenoiser
        self.vae_tiling = vae_tiling
        self._host_schedule = schedule if schedule is not None else NoiseSchedule.sdxl()
        self.schedule = self._host_schedule.to(self.device)
        # latents are normalised as in training: x / vae_std, vae_std = 1/scaling_factor
        self.vae_std = 1.0 / vae.scaling_factor if vae is not None else 1.0
        self.vae_downscale = vae.downscale if vae is not None else 8
        self.latent_channels = vae.latent_channels if vae is not None else 4
        self._sigma_cache: dict[int, np.ndarray] = {}

    def sigmas(self, num_steps: int) -> np.ndarray:
        """Host-cached fp32 sigma ladder for ``num_steps``."""
        sig = self._sigma_cache.get(num_steps)
        if sig is None:
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
            seed=seed, width=width, height=height, vae_std=self.vae_std, latent_channels=self.latent_channels,
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


def sdxl_pipeline(device="cuda", dtype=torch.bfloat16, seed: int = 0, **pipeline_kw) -> Txt2ImgPipeline:
    """The SDXL serving stack at full width with random weights from
    ``seed`` (made on ``device``): the ``sdxl`` UNet, ``clip_l`` +
    ``clip_bigg`` (``layer_idx=-2``, pooled from bigG) with hash
    tokenizers, the ``sdxl`` VAE (encoder and decoder), ``NoiseSchedule.sdxl()``;
    ``pipeline_kw`` go to :class:`Txt2ImgPipeline` (``sampler``,
    ``denoiser_cls``, ``vae_tiling``). Real
    weights and the BPE tokenizer wait until their files are in the
    repository."""
    from uwudiff_tpu_torch.models import (
        AutoencoderKL,
        ConcatTextEncoders,
        SimpleTokenizer,
        TextEncodingPipeline,
        UNet2DConditionModel,
    )

    dev = resolve_device(device)
    torch.manual_seed(seed)
    unet = UNet2DConditionModel.from_config("sdxl", device=dev, dtype=dtype)
    te = ConcatTextEncoders.from_config(
        [({"preset": "clip_l"}, {"use_pooled": False, "layer_idx": -2}),
         ({"preset": "clip_bigg"}, {"use_pooled": True, "layer_idx": -2})],
        device=dev, dtype=dtype,
    )
    vae = AutoencoderKL.from_config("sdxl", device=dev, dtype=dtype)
    te_pipe = TextEncodingPipeline(te, [SimpleTokenizer(), SimpleTokenizer()], device=dev)
    return Txt2ImgPipeline(unet, te_pipe, vae, NoiseSchedule.sdxl(), device=dev, **pipeline_kw)


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


def flux_txt2img(device="cuda", dtype=torch.bfloat16, seed: int = 0) -> FluxTxt2Img:
    """The Flux serving stack with random weights from ``seed``, each
    module built on ``device`` in ``dtype``: ``flux_dev`` (11.9 B
    parameters, made in bf16 with no fp32 copy), CLIP-L pooled-only and
    T5-XXL at 512 tokens with hash tokenizers, the 16-channel decoder. The
    transformer's zero-initialised leaves stay zero (a fresh model outputs
    zeros); ``training.bench_setup.fill_zero_initialised`` draws them."""
    from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders, Flux, SimpleTokenizer, TextEncodingPipeline

    dev = resolve_device(device)
    torch.manual_seed(seed)
    model = Flux.from_config("flux_dev", device=dev, dtype=dtype)
    te = ConcatTextEncoders.from_config(FLUX_TEXT_ENCODERS, device=dev, dtype=dtype)
    vae = AutoencoderKL.from_config(FLUX_VAE, device=dev, dtype=dtype)
    tokenizers = [SimpleTokenizer(), SimpleTokenizer(model_max_length=FLUX_T5_TOKENS)]
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


class ServerOverloaded(RuntimeError):
    """Admission rejected: the server's unresolved-request load is at
    ``max_queue`` (the HTTP-429 analogue); clients back off and retry."""


class BatchingServer:
    """Continuous request batching over a ``Txt2ImgPipeline``.

    One dispatcher thread drains the queue, groups compatible requests
    (same resolution bucket, step count, cfg scale and output kind; the
    seed is not in the key, since each lane draws from its own seed)
    into batches of up to ``max_batch``, runs one pipeline call per
    group, and a fetch thread resolves each request's Future with its
    own image. Requests snap to the nearest configured bucket. A group
    of n requests runs at the smallest size of the batch-size ladder
    that holds it (default ``(1, max_batch)``), padded with copies of
    its last request. At most ``max_queue`` requests (default
    ``8*max_batch``; ``None`` = unbounded) may be unresolved at once;
    beyond that ``submit`` raises :class:`ServerOverloaded`.
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
        return (w, h, r.num_steps, r.cfg_scale, r.return_latents)

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
        w, h, steps, cfg, return_latents = key
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
        )
        try:
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
