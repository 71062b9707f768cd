"""Weighted and long prompts, and the SDXL slice served from one file, against the JAX package on the CPU.

Two tiny CLIP towers (the second pooled, with a projection) tokenized by
``CLIPBPETokenizer`` over the vocabulary ``tests/test_tokenizers.py``
builds, where most words are several byte-level tokens, so a prompt of a
few dozen words takes two or three 77-token windows. ``encode`` with
``prompt_weighting``, ``long_prompt`` and both, and ``encode_cfg_inputs``
bringing cond and uncond to one window count, match the JAX
``TextEncodingPipeline`` within 1e-5 of the output's largest value (fp32
sums in another order).

The whole slice: a tiny SDXL-layout stack (those towers, ``tiny_sdxl`` and
the tiny VAE) written as one single-file A1111 checkpoint, loaded through
each package's ``apply_load_config``, serves a weighted long prompt with
CFG through two Euler-ancestral steps, the step noise given to both; the
latents agree within 1e-4 of their largest value, as
``tests/test_torch_serving.py`` holds the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uwudiff_tpu.loader as jloader
from test_tokenizers import vocab_files  # noqa: F401  (the module-scoped fixture vocabulary)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import compile_fast, random_params
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models import import_torch as jit_
from uwudiff_tpu.models import ldm_checkpoint as jldm
from uwudiff_tpu.models.long_prompt import chunk_token_stream as jax_chunk
from uwudiff_tpu.models.prompt_weights import parse_weighted_prompt as jax_parse
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.text_encoders import TextEncodingPipeline as JaxTEPipeline
from uwudiff_tpu.models.tokenizers import CLIPBPETokenizer as JaxBPE
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu.models.vae import AutoencoderKL as JaxVAE
from uwudiff_tpu.sampling.cfg import build_cfg_fn as jax_build_cfg_fn
from uwudiff_tpu.sampling.cfg import encode_cfg_inputs as jax_encode_cfg_inputs
from uwudiff_tpu.sampling.euler import sample_euler_ancestral as jax_sample
from uwudiff_tpu.sampling.wrapper import KDiffusionDenoiser as JaxDenoiser
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.diffusion import NoiseSchedule
from uwudiff_tpu_torch.loader import ModelLoadConfig, apply_load_config
from uwudiff_tpu_torch.models import (
    AutoencoderKL,
    CLIPBPETokenizer,
    ConcatTextEncoders,
    TextEncodingPipeline,
    UNet2DConditionModel,
)
from uwudiff_tpu_torch.models.long_prompt import chunk_token_stream
from uwudiff_tpu_torch.models.prompt_weights import parse_weighted_prompt
from uwudiff_tpu_torch.sampling import (
    KDiffusionDenoiser,
    build_cfg_fn,
    diffusion_sampling,
    encode_cfg_inputs,
    image_to_image_sampling,
    sample_euler_ancestral,
)
from uwudiff_tpu_torch.serving import BatchingServer, Request

PROJ = 24
TE_CFGS = [
    ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": False, "layer_idx": -2}),
    ({"model_type": "clip", "preset": "tiny", "projection_dim": PROJ}, {"use_pooled": True, "layer_idx": -2}),
]
UNET_OVERRIDES = dict(cross_attention_dim=64, projection_class_embeddings_input_dim=80)
LONG = ", ".join(["a zebra on the beach at dusk"] * 9)  # ~200 tokens: three windows, commas near their edges
PROMPTS = ["a (photo:1.3) of a [cat], ((running))", "(" + LONG + ":1.2), [blurry]", LONG, "cat \\(not weighted\\)"]


def test_prompt_parsing_and_chunking_equal_jax():
    for text in PROMPTS + ["((a) [b] (c:0.5) d:1.5) e", "unclosed (a [b", "a\\\\b:c", "(x:-0.25)"]:
        assert parse_weighted_prompt(text) == jax_parse(text), text
    ids = list(range(300))
    ids[70] = ids[140] = 7
    for comma in (None, 7, 999):
        for limit in (5, 75):
            assert chunk_token_stream(ids, [1.0] * 300, limit, comma) == jax_chunk(ids, [1.0] * 300, limit, comma)


class _FastApply:
    """A JAX apply compiled with the suite's cheap settings, once per input shape."""

    def __init__(self, module):
        self.module, self.compiled = module, {}

    def __call__(self, variables, toks):
        key = tuple(t["input_ids"].shape for t in toks)
        if key not in self.compiled:
            self.compiled[key] = compile_fast(self.module.apply, variables, toks)
        return self.compiled[key](variables, toks)


@pytest.fixture(scope="module")
def encoders(vocab_files):  # noqa: F811
    """(JAX pipeline, port pipeline) over the same tiny towers and vocabulary."""
    vf, mf = vocab_files
    jte = JaxConcat.from_config(TE_CFGS)
    te_params = random_params(jte, [JaxBPE(vf, mf)(PROMPTS[:1])] * 2, seed=1,
                              like=ConcatTextEncoders.from_config(TE_CFGS, device="cpu"))
    jpipe = JaxTEPipeline(jte, te_params, [JaxBPE(vf, mf), JaxBPE(vf, mf, pad_token="!")], apply_fn=_FastApply(jte),
                          jit=False)
    te = load_jax_params(ConcatTextEncoders.from_config(TE_CFGS, device="cpu"), te_params)
    pipe = TextEncodingPipeline(te, [CLIPBPETokenizer(vf, mf), CLIPBPETokenizer(vf, mf, pad_token="!")], device="cpu")
    return jpipe, pipe, te_params


def _close(got, want, rel=1e-5):
    if want is None:
        assert got is None
        return
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("weighting,long", [(True, False), (False, True), (True, True)])
def test_encode_weighted_and_long_prompts_match_jax(encoders, weighting, long):
    jpipe, pipe, _ = encoders
    with torch.no_grad():
        got = pipe.encode(PROMPTS, prompt_weighting=weighting, long_prompt=long)
    want = jpipe.encode(PROMPTS, prompt_weighting=weighting, long_prompt=long)
    assert got[0].shape[1] == (3 * 77 if long else 77)
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(NotImplementedError):
        pipe.encode([PROMPTS], nested=True, prompt_weighting=weighting, long_prompt=long)


def test_cfg_inputs_align_cond_and_uncond_windows(encoders):
    jpipe, pipe, _ = encoders
    prompts, negs = [PROMPTS[2], "a cat"], ["blurry", "(" + LONG[:60] + ")"]
    with torch.no_grad():
        enc = encode_cfg_inputs(prompts, negs, 64, 64, pipe, prompt_weighting=True, long_prompt=True)
    jenc = jax_encode_cfg_inputs(prompts, negs, 64, 64, jpipe, prompt_weighting=True, long_prompt=True)
    assert enc["ctx"].shape == (4, 3 * 77, 64) and enc["mask"] is None
    _close(enc["ctx"], jenc["ctx"])
    for key in ("time_ids", "text_embeds"):
        _close(enc["added_cond"][key], jenc["added_cond"][key])


def _export_bundle(te_params, unet_params, vae_params, path):
    """One fp32 single-file A1111 checkpoint of the JAX params."""
    from safetensors.numpy import save_file

    tes = [jit_.export_params(te_params[f"text_models_{i}"], jit_.clip_text_key_map) for i in range(2)]
    bundle = jldm.diffusers_to_ldm(jit_.export_params(unet_params, jit_.unet_key_map),
                                   jit_.export_params(vae_params, jit_.vae_key_map), tes)
    save_file(bundle, path)


def test_sdxl_slice_from_one_file_serves_a_weighted_long_prompt_as_jax(encoders, tmp_path):
    jpipe, pipe, te_params = encoders
    prompts, negs = [PROMPTS[1], PROMPTS[0]], ["blurry, lowres", ""]
    steps, cfg = 2, 5.0
    jenc = jax_encode_cfg_inputs(prompts, negs, 32, 32, jpipe, prompt_weighting=True, long_prompt=True)
    junet, jvae = JaxUNet.from_config("tiny_sdxl", **UNET_OVERRIDES), JaxVAE.from_config("tiny")
    x_probe = np.zeros((4, 8, 8, 4), np.float32)
    unet = UNet2DConditionModel.from_config("tiny_sdxl", device="cpu", **UNET_OVERRIDES)
    vae = AutoencoderKL.from_config("tiny", device="cpu")
    unet_params = random_params(junet, x_probe, np.zeros(4, np.float32), np.asarray(jenc["ctx"]), None,
                                {k: np.asarray(v) for k, v in jenc["added_cond"].items()}, seed=2, like=unet)
    vae_params = random_params(jvae, np.zeros((1, 16, 16, 3), np.float32), jax.random.PRNGKey(1), seed=3, like=vae)
    path = str(tmp_path / "tiny_sdxl.safetensors")
    _export_bundle(te_params, unet_params, vae_params, path)

    # the JAX stack, every tree read back from the file over zeroed templates
    def jload(tree, **kw):
        zero = jax.tree_util.tree_map(np.zeros_like, tree)
        return jloader.apply_load_config(zero, jloader.ModelLoadConfig(ckpt_path=path, **kw), None)

    jte_params = {f"text_models_{i}": jload(te_params[f"text_models_{i}"], importer="clip", te_index=i)
                  for i in range(2)}
    junet_params = jload(unet_params, importer="unet")
    jpipe_file = JaxTEPipeline(jpipe.module, jte_params, jpipe.tokenizers, apply_fn=jpipe._apply, jit=False)
    jenc = jax_encode_cfg_inputs(prompts, negs, 32, 32, jpipe_file, prompt_weighting=True, long_prompt=True)

    # the port's stack from the same file
    te = ConcatTextEncoders.from_config(TE_CFGS, device="cpu")
    for module, kw in ((unet, {}), (vae, {}), (te.text_models[0], {"te_index": 0}), (te.text_models[1], {"te_index": 1})):
        apply_load_config(module, ModelLoadConfig(path, **kw))
    te_pipe = TextEncodingPipeline(te, pipe.tokenizers, device="cpu")

    jsched = JaxSchedule.sdxl()
    sigmas = np.asarray(jsched.sample_sigmas_descending(steps), np.float32)
    rng = np.random.default_rng(4)
    x0 = (rng.standard_normal((2, 8, 8, 4)) * np.sqrt(1 + sigmas[0] ** 2)).astype(np.float32)
    noise = rng.standard_normal((steps, 2, 8, 8, 4)).astype(np.float32)
    ladder = jnp.asarray(sigmas[:-1])

    def jeps(x, t, **kw):
        return junet.apply({"params": junet_params}, x, t, kw["encoder_hidden_states"], kw["encoder_attention_mask"],
                           kw["added_cond"])

    def jnoise(rng_, shape, s, s_next):
        return jnp.asarray(noise)[jnp.argmin(jnp.abs(ladder - s))]

    jcfg = jax_build_cfg_fn(JaxDenoiser(model_fn=jeps, schedule=jsched), jenc, cfg)
    run = compile_fast(lambda x, s: jax_sample(jcfg, x, s, noise_sampler=jnoise), jnp.asarray(x0),
                        jnp.asarray(sigmas))

    with torch.no_grad():
        enc = encode_cfg_inputs(prompts, negs, 32, 32, te_pipe, prompt_weighting=True, long_prompt=True)
        assert enc["ctx"].shape == (4, 3 * 77, 64)

        def tnoise(shape, s, s_next):
            return torch.from_numpy(noise[int(np.argmin(np.abs(sigmas[:-1] - s)))])

        tcfg = build_cfg_fn(KDiffusionDenoiser(model_fn=unet, schedule=NoiseSchedule.sdxl()), enc, cfg)
        out = sample_euler_ancestral(tcfg, torch.from_numpy(x0), sigmas, tnoise).numpy()
    ref = np.asarray(run(jnp.asarray(x0), jnp.asarray(sigmas)))
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)

    # the entry points take both flags now (their draws are the port's own)
    kw = dict(num_steps=1, num_samples=2, width=32, height=32, vae_downscale=2, prompt_weighting=True,
              long_prompt=True, return_latents=True)
    lat = diffusion_sampling(unet, te_pipe, vae.decode, NoiseSchedule.sdxl(), prompts, negs, **kw)
    assert lat.shape == (2, 16, 16, 4) and torch.isfinite(lat).all()
    lat = image_to_image_sampling(unet, te_pipe, None, prompts, negs, init_latent=lat, num_steps=2, strength=0.5,
                                  train_schedule=NoiseSchedule.sdxl(), prompt_weighting=True, long_prompt=True,
                                  vae_downscale=2, return_latents=True)
    assert lat.shape == (2, 16, 16, 4) and torch.isfinite(lat).all()


class _RecordingPipeline:
    def __init__(self):
        self.calls = []

    def sample_device(self, prompt, neg_prompt, num_steps, num_samples, cfg_scale, width, height, seed,
                      return_latents, prompt_weighting=False, long_prompt=False):
        self.calls.append((tuple(prompt[:num_samples]), prompt_weighting, long_prompt))
        return torch.stack([torch.full((2, 2), float(s)) for s in seed]), False


def test_server_groups_by_weighting_and_long_prompt():
    pipe = _RecordingPipeline()
    server = BatchingServer(pipe, buckets=[(64, 64)], max_batch=4, max_wait_s=0.3)
    kinds = [(False, False), (True, False), (False, True), (True, True), (True, False), (False, True)]
    reqs = [Request(prompt=f"p{i}", seed=i, width=64, height=64, prompt_weighting=w, long_prompt=lp)
            for i, (w, lp) in enumerate(kinds)]
    assert len({server._group_key(r) for r in reqs}) == 4
    server.start()
    try:
        outs = [f.result(timeout=30) for f in [server.submit(r) for r in reqs]]
    finally:
        server.stop()
    assert [float(o[0, 0]) for o in outs] == list(range(6))
    # one group per key, each call carrying its group's flags
    groups = sorted((flags, sorted(set(p))) for p, *flags in pipe.calls)
    assert groups == [([False, False], ["p0"]), ([False, True], ["p2", "p5"]), ([True, False], ["p1", "p4"]),
                      ([True, True], ["p3"])]
