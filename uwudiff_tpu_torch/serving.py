"""Serving: a text-to-image pipeline and a continuous-batching server
(``uwudiff_tpu/serving.py``).

``Txt2ImgPipeline`` binds the UNet, the text encoders and the VAE on one
device; ``sample_device`` enqueues a whole request batch (encode, CFG
Euler-ancestral sampling, uint8 decode) without waiting on the device,
so ``BatchingServer``'s fetch thread copies one batch's images to the
host while the dispatcher enqueues the next. Adapter hot-swap, int8
weights, latent sharding and the ``**kwargs`` path of the JAX pipeline
come with the modules they need.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule
from uwudiff_tpu_torch.sampling.cfg import build_cfg_fn, encode_cfg_inputs
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral
from uwudiff_tpu_torch.sampling.noise import (
    expand_seeds,
    make_per_sample_noise_sampler,
    per_sample_init_noise,
)
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser
from uwudiff_tpu_torch.utils import resolve_device, truncate_or_pad_to_length, vae_image_postprocess

__all__ = ["Txt2ImgPipeline", "BatchingServer", "Request", "ServerOverloaded", "sdxl_pipeline"]


class Txt2ImgPipeline:
    def __init__(
        self,
        unet,  # (x, t, encoder_hidden_states=, encoder_attention_mask=, added_cond=) -> eps, NHWC
        te_pipeline,  # TextEncodingPipeline
        vae=None,  # AutoencoderKL (decode) or None -> latents only
        schedule: NoiseSchedule | None = None,  # None -> NoiseSchedule.sdxl()
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.unet = unet
        self.te = te_pipeline
        self.vae = vae
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

    def __call__(self, prompt, neg_prompt="", num_steps: int = 16, num_samples: int = 1,
                 cfg_scale: float = 3.0, width: int = 1024, height: int = 1024, seed=42,
                 return_latents: bool = False, cfg_rescale: float = 0.0):
        """Blocking: a list of uint8 HWC images, or the latents array."""
        out, is_images = self.sample_device(
            prompt, neg_prompt, num_steps=num_steps, num_samples=num_samples,
            cfg_scale=cfg_scale, width=width, height=height, seed=seed,
            return_latents=return_latents, cfg_rescale=cfg_rescale,
        )
        host = out.cpu().numpy()
        return [vae_image_postprocess(img) for img in host] if is_images else host

    @torch.inference_mode()
    def sample_device(self, prompt, neg_prompt="", num_steps: int = 16, num_samples: int = 1,
                      cfg_scale: float = 3.0, width: int = 1024, height: int = 1024, seed=42,
                      return_latents: bool = False, cfg_rescale: float = 0.0):
        """The request path, asynchronous: returns ``(device tensor,
        is_images)`` without waiting for the device. ``seed`` is an int
        (sample j uses seed+j) or a per-sample sequence."""
        if isinstance(prompt, str):
            prompt = [prompt]
        if isinstance(neg_prompt, str):
            neg_prompt = [neg_prompt]
        prompt = truncate_or_pad_to_length(list(prompt), num_samples, "cycling")
        neg_prompt = truncate_or_pad_to_length(list(neg_prompt), num_samples, "cycling")
        enc = encode_cfg_inputs(prompt, neg_prompt, width, height, self.te)
        sigmas = self.sigmas(num_steps)
        seeds = expand_seeds(seed, num_samples)
        down, ch = self.vae_downscale, self.latent_channels
        cfg_fn = build_cfg_fn(
            KDiffusionDenoiser(model_fn=self.unet, schedule=self.schedule), enc, cfg_scale,
            cfg_rescale,
        )
        init_scale = float(np.sqrt(np.float32(1.0) + sigmas[0] ** 2))
        init_x = per_sample_init_noise(seeds, (height // down, width // down, ch), self.device)
        latents = sample_euler_ancestral(
            cfg_fn, init_x * init_scale, sigmas, make_per_sample_noise_sampler(seeds, self.device)
        )
        latents = latents * self.vae_std
        if return_latents or self.vae is None:
            return latents, False
        images = self.vae.decode(latents)
        return ((images.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8), True

    def warmup(self, widths_heights_batches, num_steps: int = 16):
        """Run each (width, height, batch) signature once (allocator and
        cuDNN algorithm caches warm before the first request)."""
        for w, h, b in widths_heights_batches:
            self(prompt="warmup", num_steps=num_steps, num_samples=b, width=w, height=h,
                 return_latents=self.vae is None)


def sdxl_pipeline(device="cuda", dtype=torch.bfloat16, seed: int = 0) -> Txt2ImgPipeline:
    """The SDXL serving stack at full width with random weights from
    ``seed`` (made on ``device``): the ``sdxl`` UNet, ``clip_l`` +
    ``clip_bigg`` (``layer_idx=-2``, pooled from bigG) with hash
    tokenizers, the ``sdxl`` VAE decoder, ``NoiseSchedule.sdxl()``. Real
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
    return Txt2ImgPipeline(unet, te_pipe, vae, NoiseSchedule.sdxl(), device=dev)


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
