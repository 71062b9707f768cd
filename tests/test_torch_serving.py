"""The port's serving path against the JAX package's, on the CPU, in fp32.

The whole tiny CFG Euler-ancestral sampler runs in both packages on the
same weights, prompts, init latents and step noise. The JAX steps run
inside ``lax.scan``, so its ``noise_sampler`` picks each step's draw by
looking up the sigma it is handed in the ladder; the port's does the same.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import random_params
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.text_encoders import TextEncodingPipeline as JaxTEPipeline
from uwudiff_tpu.models.tokenizers import SimpleTokenizer as JaxTokenizer
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu.sampling.cfg import apply_cfg_rescale as jax_cfg_rescale
from uwudiff_tpu.sampling.cfg import build_cfg_fn as jax_build_cfg_fn
from uwudiff_tpu.sampling.cfg import default_time_ids as jax_default_time_ids
from uwudiff_tpu.sampling.cfg import encode_cfg_inputs as jax_encode_cfg_inputs
from uwudiff_tpu.sampling.euler import sample_euler_ancestral as jax_sample
from uwudiff_tpu.sampling.noise import expand_seeds as jax_expand_seeds
from uwudiff_tpu.sampling.wrapper import KDiffusionDenoiser as JaxDenoiser
from uwudiff_tpu.sampling.wrapper import get_ancestral_step as jax_ancestral_step
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.diffusion import NoiseSchedule
from uwudiff_tpu_torch.models import (
    AutoencoderKL,
    ConcatTextEncoders,
    SimpleTokenizer,
    TextEncodingPipeline,
    UNet2DConditionModel,
)
from uwudiff_tpu_torch.sampling import (
    KDiffusionDenoiser,
    apply_cfg_rescale,
    build_cfg_fn,
    default_time_ids,
    encode_cfg_inputs,
    expand_seeds,
    get_ancestral_step,
    sample_euler_ancestral,
)
from uwudiff_tpu_torch.serving import BatchingServer, Request, ServerOverloaded, Txt2ImgPipeline

TE_CFGS = [
    ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": False, "layer_idx": -2}),
    ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": True, "layer_idx": -2}),
]
# tiny_sdxl fed by two tiny CLIP towers: context 32+32, pooled 32 + 6*8 time ids
UNET_OVERRIDES = dict(cross_attention_dim=64, projection_class_embeddings_input_dim=80)


def test_cfg_euler_ancestral_sampler_matches_jax():
    prompts, negs = ["a cat on a mat", "a dog"], ["blurry", ""]
    w = h = 64
    steps, cfg = 3, 5.0
    jte = JaxConcat.from_config(TE_CFGS)
    tok = JaxTokenizer()
    te_params = random_params(jte, [tok(prompts + negs)] * 2, seed=1)
    jte_pipe = JaxTEPipeline(jte, te_params, [JaxTokenizer(), JaxTokenizer()])
    jenc = jax_encode_cfg_inputs(prompts, negs, w, h, jte_pipe)

    junet = JaxUNet.from_config("tiny_sdxl", **UNET_OVERRIDES)
    x_probe = np.zeros((4, 8, 8, 4), np.float32)
    unet_params = random_params(
        junet, x_probe, np.zeros(4, np.float32), np.asarray(jenc["ctx"]), None,
        {k: np.asarray(v) for k, v in jenc["added_cond"].items()}, seed=2,
    )

    jsched = JaxSchedule.sdxl()
    sigmas = np.asarray(jsched.sample_sigmas_descending(steps), np.float32)
    rng = np.random.default_rng(3)
    x0 = (rng.standard_normal((2, 8, 8, 4)) * np.sqrt(1 + sigmas[0] ** 2)).astype(np.float32)
    noise = rng.standard_normal((steps, 2, 8, 8, 4)).astype(np.float32)

    def jeps(x, t, **kw):
        return junet.apply({"params": unet_params}, x, t, kw["encoder_hidden_states"],
                           kw["encoder_attention_mask"], kw["added_cond"])

    ladder = jnp.asarray(sigmas[:-1])

    def jnoise(rng_, shape, s, s_next):
        return jnp.asarray(noise)[jnp.argmin(jnp.abs(ladder - s))]

    jcfg = jax_build_cfg_fn(JaxDenoiser(model_fn=jeps, schedule=jsched), jenc, cfg)
    ref = jax.jit(functools.partial(jax_sample, jcfg, noise_sampler=jnoise))(
        jnp.asarray(x0), jnp.asarray(sigmas)
    )

    te = load_jax_params(ConcatTextEncoders.from_config(TE_CFGS, device="cpu"), te_params)
    te_pipe = TextEncodingPipeline(te, [SimpleTokenizer(), SimpleTokenizer()], device="cpu")
    unet = load_jax_params(
        UNet2DConditionModel.from_config("tiny_sdxl", device="cpu", **UNET_OVERRIDES), unet_params
    )
    with torch.no_grad():
        enc = encode_cfg_inputs(prompts, negs, w, h, te_pipe)
        for key in ("ctx",):
            np.testing.assert_allclose(enc[key].numpy(), np.asarray(jenc[key]), atol=1e-5)

        def tnoise(shape, s, s_next):
            return torch.from_numpy(noise[int(np.argmin(np.abs(sigmas[:-1] - s)))])

        tcfg = build_cfg_fn(KDiffusionDenoiser(model_fn=unet, schedule=NoiseSchedule.sdxl()), enc, cfg)
        out = sample_euler_ancestral(tcfg, torch.from_numpy(x0), sigmas, tnoise)
    ref = np.asarray(ref)
    assert np.isfinite(out.numpy()).all()
    # fp32 through 3 steps x (CLIP + UNet): 1e-4 of the latents' scale
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_cfg_rescale_and_time_ids_match_jax():
    rng = np.random.default_rng(5)
    out, cond = rng.standard_normal((2, 2, 8, 8, 4)).astype(np.float32)
    for phi in (0.0, 0.7):
        np.testing.assert_allclose(
            apply_cfg_rescale(torch.from_numpy(out), torch.from_numpy(cond), phi).numpy(),
            np.asarray(jax_cfg_rescale(jnp.asarray(out), jnp.asarray(cond), phi)), atol=1e-6,
        )
    np.testing.assert_array_equal(default_time_ids(1024, 768, 3).numpy(),
                                  np.asarray(jax_default_time_ids(1024, 768, 3)))


def test_ancestral_step_and_seed_expansion_match_jax():
    for s, s_next in ((14.6, 7.3), (1.2, 0.03), (0.5, 0.0)):
        jd, ju = jax_ancestral_step(jnp.float32(s), jnp.float32(s_next))
        td, tu = get_ancestral_step(s, s_next)
        np.testing.assert_allclose([td, tu], [float(jd), float(ju)], rtol=1e-6)
    for seed, n in ((7, 3), ([5, 9], 4), (2**32 - 1, 2)):
        np.testing.assert_array_equal(expand_seeds(seed, n), jax_expand_seeds(seed, n))
    with pytest.raises(ValueError):
        expand_seeds([1, 2, 3], 2)


def test_simple_tokenizer_ids_equal_jax():
    texts = ["A photo of a CAT", "", "word " * 100, "ünïcode 漢字 tokens"]
    for kw in ({}, {"padding": False}, {"max_length": 16}):
        ref = JaxTokenizer()(texts, **kw)
        out = SimpleTokenizer()(texts, **kw)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(out[key], ref[key])
    assert SimpleTokenizer(vocab_size=49408).tokenize("hello") == JaxTokenizer(49408).tokenize("hello")


class _FakePipeline:
    def __init__(self, delay=0.0, gate=None):
        self.calls, self.delay, self.gate = [], delay, gate

    def sample_device(self, prompt, neg_prompt, num_steps, num_samples, cfg_scale, width, height,
                      seed, return_latents):
        if self.gate is not None:
            self.gate.wait(10)
        self.calls.append({"n": num_samples, "seeds": list(seed), "wh": (width, height)})
        time.sleep(self.delay)
        return torch.stack([torch.full((2, 2), float(s)) for s in seed]), False


def test_batching_server_groups_pads_and_sheds():
    pipe = _FakePipeline(delay=0.05)
    server = BatchingServer(pipe, buckets=[(64, 64), (128, 64)], max_batch=4, max_wait_s=0.3).start()
    try:
        futs = [server.submit(Request(prompt="a", seed=s, width=66, height=62)) for s in (1, 2, 3)]
        futs.append(server.submit(Request(prompt="wide", seed=7, width=120, height=60)))
        outs = [f.result(timeout=30) for f in futs]
    finally:
        server.stop()
    # different seeds share a batch, padded to max_batch on the (1, 4) ladder;
    # bucket snap splits the wide request into its own lone (size-1) group
    assert [c["n"] for c in pipe.calls] == [4, 1]
    assert pipe.calls[0]["seeds"] == [1, 2, 3, 3] and pipe.calls[0]["wh"] == (64, 64)
    assert pipe.calls[1]["wh"] == (128, 64)
    assert [float(o[0, 0]) for o in outs] == [1.0, 2.0, 3.0, 7.0]

    # bounded admission: at max_queue unresolved requests, submit raises
    gate = threading.Event()
    server = BatchingServer(_FakePipeline(gate=gate), buckets=[(64, 64)], max_batch=2,
                            max_wait_s=0.01, max_queue=3).start()
    try:
        held = [server.submit(Request(prompt=str(i))) for i in range(3)]
        with pytest.raises(ServerOverloaded):
            server.submit(Request(prompt="over"))
        assert server.load() == 3
        gate.set()
        for f in held:
            f.result(timeout=30)
        # a future's done-callback (which frees its slot) runs just after
        # its waiters wake, on the resolving thread
        deadline = time.monotonic() + 10
        while server.load() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.load() == 0
        server.submit(Request(prompt="after")).result(timeout=30)
    finally:
        gate.set()
        server.stop()


def test_batching_server_admission_under_concurrent_submitters():
    """16 threads submit at once against max_queue=8: every accepted
    request resolves with its own seed, every other one is rejected, and
    the unresolved count returns to 0 (a lost update would leave it off)."""
    import sys

    server = BatchingServer(_FakePipeline(), buckets=[(64, 64)], max_batch=4,
                            max_wait_s=0.001, max_queue=8).start()
    accepted, rejected, lock = [], [], threading.Lock()

    def client(tid):
        for i in range(25):
            seed = tid * 100 + i
            try:
                fut = server.submit(Request(prompt="p", seed=seed))
            except ServerOverloaded:
                with lock:
                    rejected.append(seed)
                continue
            with lock:
                accepted.append((seed, fut))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for seed, fut in accepted:
            assert float(fut.result(timeout=30)[0, 0]) == seed
    finally:
        sys.setswitchinterval(old)
        server.stop()
    assert len(accepted) + len(rejected) == 16 * 25 and accepted
    deadline = time.monotonic() + 10
    while server.load() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.load() == 0


def _cpu_pipeline():
    torch.manual_seed(0)
    te = ConcatTextEncoders.from_config(TE_CFGS, device="cpu")
    te_pipe = TextEncodingPipeline(te, [SimpleTokenizer(), SimpleTokenizer()], device="cpu")
    unet = UNet2DConditionModel.from_config("tiny_sdxl", device="cpu", **UNET_OVERRIDES)
    vae = AutoencoderKL.from_config("tiny", device="cpu")
    return Txt2ImgPipeline(unet, te_pipe, vae, NoiseSchedule.sdxl(), device="cpu")


def test_seed_lanes_isolated_and_server_serves_images():
    pipe = _cpu_pipeline()
    # vae "tiny" downscales 2x: 32x32 images from 16x16 latents
    kw = dict(prompt="a cat", num_steps=2, width=32, height=32, return_latents=True)
    batch = pipe(num_samples=3, seed=[5, 9, 11], **kw)
    solo = pipe(num_samples=1, seed=9, **kw)
    assert batch.shape == (3, 16, 16, 4) and np.isfinite(batch).all()
    assert not np.allclose(batch[0], batch[1])
    # lane 1 depends on seed 9 only (batch size changes only the fp32 sum order)
    np.testing.assert_allclose(solo[0], batch[1], atol=1e-5 * np.abs(batch).max())

    server = BatchingServer(pipe, buckets=[(32, 32)], max_batch=2, max_wait_s=0.2).start()
    try:
        futs = [server.submit(Request(prompt=p, num_steps=2, width=30, height=34, seed=s))
                for p, s in (("a cat", 1), ("a dog", 2), ("a fox", 3))]
        images = [f.result(timeout=120) for f in futs]
    finally:
        server.stop()
    for img in images:
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
