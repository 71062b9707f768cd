"""The port's SD3 serving slice against the JAX package, on the CPU, in fp32.

- The MMDiT with ``skip_layers`` (SD3's switches on: the ``context_pre_only``
  last block, the cropped position grid; a text key mask) against
  ``JaxMMDiT(skip_layers=...)``, its JAX references compiled in one program.
- ``build_slg_cfg_fn`` against the JAX one on a closed-form model written in
  torch and jax.numpy (run eagerly): with and without ``slg_interval`` (one
  lane's sigma inside the window, one outside) and ``cfg_rescale``; at
  ``slg_scale`` 0 it is ``build_cfg_fn``'s output bitwise.
- ``loader.apply_load_config`` of ``mmdit``, ``t5``, ``vae`` and ``flux``
  files written from the JAX export equals the JAX loader's params for the
  same file bitwise (the JAX loader routes no ``t5``: its
  ``import_params`` with ``t5_key_map`` is the reference there).
- ``serving.sd3_pipeline`` at tiny presets (two tiny CLIPs over a BPE
  vocabulary, a tiny T5 over a test-built SentencePiece model padded to 256
  tokens, a tiny MMDiT with SD3's switches, a one-level 16-channel VAE with
  SD3's scale and shift), read from per-component files, through skip-layer
  guidance against the JAX ``Txt2ImgPipeline`` with ``unet_skip_fn`` and
  ``slg_scale``: the JAX side's threefry draws are fed to the port; its
  sampling loop compiles once with LLVM's cheap settings.
- ``flux_txt2img(component_files=)`` reads each leaf from its file, and
  ``BatchingServer`` pads and sheds a group of SD3 requests as it does
  SDXL's.

Tolerances: encoder outputs, the MMDiT and the guided outputs within 1e-5 of
their scale (fp32 sums in another order); the latents after two steps
within 1e-4 of their largest value, as the Flux slice's test holds them; the
loaded weights bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import uwudiff_tpu.loader as jloader
import uwudiff_tpu.models.import_torch as jit_
from test_spiece import _PIECES
from test_tokenizers import vocab_files  # noqa: F401  (the module-scoped fixture vocabulary)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import FAST_COMPILE, assert_close, compile_fast, random_params
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models.flux import Flux as JaxFlux
from uwudiff_tpu.models.mmdit import MMDiT as JaxMMDiT
from uwudiff_tpu.models.spiece import T5SPTokenizer as JaxT5SP
from uwudiff_tpu.models.t5 import T5EncoderModel as JaxT5
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.text_encoders import TextEncodingPipeline as JaxTEPipeline
from uwudiff_tpu.models.tokenizers import CLIPBPETokenizer as JaxBPE
from uwudiff_tpu.models.vae import AutoencoderKL as JaxVAE
from uwudiff_tpu.sampling import cfg as jcfg
from uwudiff_tpu.sampling import get_sigmas as jsig
from uwudiff_tpu.sampling import noise as jnoise
from uwudiff_tpu.sampling.wrapper import RFDenoiser as JaxRFDenoiser
from uwudiff_tpu.serving import Txt2ImgPipeline as JaxTxt2Img
from uwudiff_tpu_torch import serving
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.loader import ModelLoadConfig, apply_load_config
from uwudiff_tpu_torch.models import (
    CLIP_PRESETS,
    FLUX_PRESETS,
    MMDIT_PRESETS,
    T5_PRESETS,
    AutoencoderKL,
    ConcatTextEncoders,
    Flux,
    MMDiT,
    T5EncoderModel,
)
from uwudiff_tpu_torch.models import import_torch as it
from uwudiff_tpu_torch.models.spiece import serialize_sentencepiece_model
from uwudiff_tpu_torch.sampling import build_cfg_fn, build_slg_cfg_fn, encode_cfg_inputs
from uwudiff_tpu_torch.sampling import sampling as tsampling_module
from uwudiff_tpu_torch.training.bench_setup import SD3_TEXT_ENCODERS

SD3_SWITCHES = dict(depth=3, context_pre_only=True, pos_embed_max_size=16, pos_embed_base_size=8)
# the tiny stack at SD3's layout: the tiny towers' widths (CLIP 32 + 32 pooled, the context padded to 4096)
MMDIT_TINY = dict(MMDIT_PRESETS["tiny"], **SD3_SWITCHES, in_channels=16, context_dim=4096, pooled_dim=64)
VAE_TINY = dict(block_out_channels=(32,), layers_per_block=1, latent_channels=16, norm_num_groups=8,
                scaling_factor=serving.SD3_VAE["scaling_factor"])
TE_TINY = [({**model_cfg, "preset": "tiny"}, extra) for model_cfg, extra in SD3_TEXT_ENCODERS]
PROMPTS, NEGS = ["the quick fox", "a cat at the abc"], ["", "the fox"]


def _mmdit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3.5, 871.25], np.float32)
    ctx = rng.standard_normal((2, 7, 48)).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    return x, t, ctx, mask, {"text_embeds": rng.standard_normal((2, 24)).astype(np.float32)}


SKIPS = [(), (1,), (0, 1)]


@pytest.fixture(scope="module")
def mmdit_skip_refs():
    """The JAX MMDiT's outputs with each of SKIPS bypassed, one program."""
    args = _mmdit_inputs()
    jmodel = JaxMMDiT.from_config("tiny", **SD3_SWITCHES)
    model = MMDiT.from_config("tiny", device="cpu", **SD3_SWITCHES)
    params = random_params(jmodel, *args, seed=3, like=model)

    def run(p, *a):
        return [jmodel.clone(skip_layers=skip).apply({"params": p}, *a) for skip in SKIPS]

    refs = compile_fast(run, params, *args)(params, *args)
    return load_jax_params(model, params), params, args, dict(zip(SKIPS, refs))


@pytest.mark.parametrize("skip", SKIPS)
def test_mmdit_skip_layers_match_jax(mmdit_skip_refs, skip):
    """The listed joint blocks are bypassed, the ``context_pre_only`` final
    block never; a module built with ``skip_layers`` and ``forward(skip_layers=)``
    on the same weights agree."""
    model, params, args, refs = mmdit_skip_refs
    x, t, ctx, mask, added = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                              {k: torch.from_numpy(v) for k, v in a.items()} for a in args)
    with torch.no_grad():
        out = model(x, t, ctx, mask, added, skip_layers=skip)
        assert_close(out, refs[skip])
        built = load_jax_params(MMDiT.from_config("tiny", device="cpu", skip_layers=skip, **SD3_SWITCHES), params)
        assert torch.equal(built(x, t, ctx, mask, added), out)
    if skip:
        assert not np.allclose(np.asarray(refs[skip]), np.asarray(refs[()]), atol=1e-3)
    else:
        with pytest.raises(ValueError, match="outside"):  # only the 2 joint blocks before the final one
            model(x, t, ctx, mask, added, skip_layers=(2,))


# ---------------------------------------------------------------- guidance


def _closed_form(lib, scale):
    """A denoiser-shaped model whose output depends on x, sigma and every
    conditioning input, in torch or jax.numpy."""
    def unet(x, sigma, sigma_cond=None, encoder_hidden_states=None, encoder_attention_mask=None, added_cond=None):
        ctx = (encoder_hidden_states * encoder_attention_mask[..., None]).mean(axis=(1, 2))
        pooled = added_cond["text_embeds"].mean(axis=-1)
        return lib.tanh(scale * x) * (1.0 + ctx + pooled)[:, None, None, None] + 0.1 * sigma[:, None, None, None]

    return unet


def _enc(rng):
    ctx = rng.standard_normal((4, 6, 8)).astype(np.float32)
    mask = np.ones((4, 6), np.float32)
    mask[1, 3:] = 0
    mask[3, 5:] = 0
    return {"ctx": ctx, "mask": mask, "added_cond": {"text_embeds": rng.standard_normal((4, 5)).astype(np.float32)}}


@pytest.mark.parametrize("slg_interval,cfg_rescale", [(None, 0.0), ((1.0, 3.0), 0.7)])
def test_slg_cfg_fn_matches_jax(slg_interval, cfg_rescale):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    sigma = np.array([2.5, 4.0], np.float32)  # lane 0 inside (1, 3), lane 1 outside
    enc = _enc(rng)
    jenc, tenc = jax.tree_util.tree_map(jnp.asarray, enc), jax.tree_util.tree_map(torch.from_numpy, enc)
    jfn = jcfg.build_slg_cfg_fn(_closed_form(jnp, 1.0), _closed_form(jnp, 0.6), jenc, 4.0, 2.5, cfg_rescale,
                                slg_interval=slg_interval)
    tfn = build_slg_cfg_fn(_closed_form(torch, 1.0), _closed_form(torch, 0.6), tenc, 4.0, 2.5, cfg_rescale,
                           slg_interval=slg_interval)
    jout, juncond = jfn(jnp.asarray(x), jnp.asarray(sigma))
    out, uncond = tfn(torch.from_numpy(x), torch.from_numpy(sigma))
    assert_close(out, jout)
    assert_close(uncond, juncond)  # the pair the CFG++ samplers read
    plain, _ = build_cfg_fn(_closed_form(torch, 1.0), tenc, 4.0, cfg_rescale)(torch.from_numpy(x),
                                                                             torch.from_numpy(sigma))
    if slg_interval is None:
        assert not torch.allclose(out, plain, atol=1e-3)
    else:  # the guidance term only in lane 0's window
        assert torch.equal(out[1], plain[1])
        assert not torch.allclose(out[0], plain[0], atol=1e-3)
    zero, _ = build_slg_cfg_fn(_closed_form(torch, 1.0), _closed_form(torch, 0.6), tenc, 4.0, 0.0,
                               cfg_rescale)(torch.from_numpy(x), torch.from_numpy(sigma))
    assert torch.equal(zero, plain)


# ---------------------------------------------------------------- files


# name -> (the JAX module, the port module's builder, the JAX map) at tiny
# sizes; the MMDiT with SD3's switches (its final block placed by the depth)
FAMILIES = {
    "mmdit": (lambda: JaxMMDiT.from_config("tiny", **SD3_SWITCHES),
              lambda: MMDiT.from_config("tiny", device="cpu", **SD3_SWITCHES),
              functools.partial(jit_.mmdit_key_map, depth=3)),
    "t5": (lambda: JaxT5.from_config("tiny"), lambda: T5EncoderModel.from_config("tiny", device="cpu"),
           jit_.t5_key_map),
    "vae": (lambda: JaxVAE.from_config(VAE_TINY), lambda: AutoencoderKL.from_config(VAE_TINY, device="cpu"),
            jit_.vae_key_map),
    "flux": (lambda: JaxFlux.from_config("tiny"), lambda: Flux.from_config("tiny", device="cpu"), jit_.flux_key_map),
}


def _family_params(name):
    jax_module, build, _ = FAMILIES[name]
    return random_params(jax_module(), seed=2, like=build())


def _write(path, flat: dict):
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flat.items()}, str(path))
    return str(path)


@pytest.mark.parametrize("name", ["mmdit", "t5", "vae", "flux"])
def test_apply_load_config_of_component_files_equals_jax_loader(name, tmp_path):
    jax_module, build, jmap = FAMILIES[name]
    params, module = _family_params(name), build()
    path = _write(tmp_path / f"{name}.safetensors", jit_.export_params(params, jmap))
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    if name == "t5":  # the JAX loader routes no t5; its import_params with the map it has
        want = jit_.import_params(zeros, jit_.load_torch_state_dict(path), jit_.t5_key_map)
    else:
        want = jloader.apply_load_config(zeros, jloader.ModelLoadConfig(path), module=jax_module())
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    timings = {}
    apply_load_config(module, ModelLoadConfig(path), timings)  # the importer found from the class
    assert set(timings) == {"read", "map", "copy"} and module.loaded_keys == set(it.load_torch_state_dict(path))
    ref = load_jax_params(build(), want).state_dict()
    for key, value in module.state_dict().items():
        assert torch.equal(value, ref[key]), (name, key)


@pytest.fixture(scope="module")
def sd3_files(tmp_path_factory, vocab_files):  # noqa: F811
    """The tiny SD3 stack's JAX modules and params, its component files (the
    JAX export) and tokenizer files."""
    tmp = tmp_path_factory.mktemp("sd3")
    jte = JaxConcat.from_config(TE_TINY, zero_for_padding=False, pad_context_to=4096)
    te = ConcatTextEncoders.from_config(TE_TINY, device="cpu", zero_for_padding=False, pad_context_to=4096)
    te_params = random_params(jte, seed=5, like=te)
    jmm = JaxMMDiT.from_config(MMDIT_TINY)
    mm_params = random_params(jmm, seed=6, like=MMDiT(**MMDIT_TINY))
    vae_params = _family_params("vae")
    files = {"transformer": jit_.export_params(mm_params, functools.partial(jit_.mmdit_key_map, depth=3)),
             "vae": jit_.export_params(vae_params, jit_.vae_key_map)}
    for i, key in enumerate(("text_encoder", "text_encoder_2")):
        files[key] = jit_.export_params(te_params[f"text_models_{i}"], jit_.clip_text_key_map)
    files["text_encoder_3"] = jit_.export_params(te_params["text_models_2"], jit_.t5_key_map)
    files = {k: _write(tmp / f"{k}.safetensors", v) for k, v in files.items()}
    spm = tmp / "spiece.model"
    spm.write_bytes(serialize_sentencepiece_model(_PIECES))
    vocab = (str(vocab_files[0]), str(vocab_files[1]))
    return dict(jte=jte, te_params=te_params, jmm=jmm, mm_params=mm_params, vae_params=vae_params, files=files,
                tokenizer_files=[vocab, vocab, str(spm)])


@pytest.fixture
def tiny_presets(monkeypatch):
    """``sd3_pipeline``'s and ``flux_txt2img``'s presets cut to the tiny ones."""
    monkeypatch.setitem(MMDIT_PRESETS, "sd3_medium", MMDIT_TINY)
    for name in ("clip_l", "clip_bigg"):
        monkeypatch.setitem(CLIP_PRESETS, name, CLIP_PRESETS["tiny"])
    monkeypatch.setitem(T5_PRESETS, "t5_xxl", T5_PRESETS["tiny"])
    monkeypatch.setattr(serving, "SD3_VAE", VAE_TINY)
    monkeypatch.setattr(serving, "FLUX_VAE", VAE_TINY)


def _jax_draws(seeds, shape, sigmas):
    """JAX's per-sample init noise and each step's draw (keyed by its interval)."""
    n = len(seeds)

    def draws(seed_arr):
        keys = jnoise.per_sample_keys(seed_arr)
        draw = jnoise.make_per_sample_noise_sampler(keys)
        return jnoise.per_sample_init_noise(keys, shape), [
            draw(None, (n, *shape), s, s_next) for s, s_next in zip(sigmas[:-1], sigmas[1:])]

    seed_arr = jnp.asarray(np.asarray(seeds, np.uint32))
    init, steps = compile_fast(draws, seed_arr)(seed_arr)
    return torch.from_numpy(np.array(init)), [torch.from_numpy(np.array(s)) for s in steps]


def test_sd3_pipeline_from_files_with_skip_layer_guidance_matches_jax(sd3_files, tiny_presets, monkeypatch):
    """``sd3_pipeline(component_files=, tokenizer_files=)`` at tiny presets:
    every leaf the file's, the T5 tokens padded to 256, and SLG (block 1
    skipped, scale 2.5, the window over the first of 2 steps) through the
    pipeline's ``**kwargs`` against the JAX ``Txt2ImgPipeline``'s
    ``diffusion_sampling(unet_skip_fn=, slg_scale=, slg_interval=)``."""
    f = sd3_files
    timings = {}
    pipe = serving.sd3_pipeline("cpu", torch.float32, component_files=f["files"],
                                tokenizer_files=f["tokenizer_files"], load_timings=timings)
    assert set(timings) == {"read", "map", "copy"}
    for module, path in ((pipe.unet, "transformer"), (pipe.vae, "vae"), (pipe.te.module.text_models[2],
                                                                          "text_encoder_3")):
        assert module.loaded_keys == set(it.load_torch_state_dict(f["files"][path]))
    want = load_jax_params(MMDiT(**MMDIT_TINY), f["mm_params"]).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in pipe.unet.state_dict().items())

    steps, w, seeds, skip = 2, 16, [5, 9], (1,)
    sigmas = np.asarray(serving.sd3_sigmas(steps), np.float32)
    jsigma_fn = functools.partial(jsig.get_sigmas_for_rf, max_sigma=14.6146,
                                  time_disc_func=functools.partial(jsig.shift_time, shift=3.0))
    np.testing.assert_array_equal(sigmas, np.asarray(jsigma_fn(steps), np.float32))
    window = (0.5 * float(sigmas[0] + sigmas[1]), float(sigmas[0]) + 1.0)
    kw = dict(num_steps=steps, num_samples=2, cfg_scale=4.0, width=w, height=w, seed=seeds, return_latents=True)

    toks = [JaxBPE(*f["tokenizer_files"][0]), JaxBPE(*f["tokenizer_files"][1], pad_token="!"),
            serving.MaxLengthPadding(JaxT5SP(f["tokenizer_files"][2], model_max_length=256))]
    jte_pipe = JaxTEPipeline(f["jte"], f["te_params"], toks)
    jmm = f["jmm"]
    jpipe = JaxTxt2Img(lambda p, *a: jmm.apply({"params": p}, *a), jte_pipe, None, JaxSchedule.sdxl(),
                       vae_std=pipe.vae_std, vae_mean=serving.SD3_VAE_SHIFT, vae_downscale=pipe.vae_downscale,
                       latent_channels=16, unet_params=f["mm_params"], denoiser_cls=JaxRFDenoiser)
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
        jlat = np.asarray(jpipe(PROMPTS, NEGS, get_sigma_func=jsigma_fn, slg_scale=2.5, slg_interval=window,
                                unet_skip_fn=lambda p, *a: jmm.clone(skip_layers=skip).apply({"params": p}, *a),
                                **kw))

    init, step_noise = _jax_draws(seeds, (w, w, 16), sigmas)
    monkeypatch.setattr(tsampling_module, "per_sample_init_noise", lambda *a, **k: init.clone())
    monkeypatch.setattr(tsampling_module, "make_per_sample_noise_sampler", lambda *a, **k: (
        lambda shape_, s, s_next: step_noise[int(np.argmin(np.abs(sigmas[:-1] - s)))]))
    enc = encode_cfg_inputs(PROMPTS, NEGS, w, w, pipe.te)  # T5's 256 tokens after the CLIP pair's 77, masked
    assert enc["ctx"].shape == (4, 77 + 256, 4096) and enc["mask"].shape == (4, 77 + 256)
    assert enc["mask"][:, 77:].sum(1).max() < 256 and enc["mask"][:, :77].all()
    slg = dict(unet_skip_fn=functools.partial(pipe.unet, skip_layers=skip), slg_scale=2.5, slg_interval=window)
    lat = pipe(PROMPTS, NEGS, **slg, **kw)
    assert lat.shape == jlat.shape == (2, w, w, 16) and np.isfinite(lat).all()
    np.testing.assert_allclose(lat, jlat, atol=1e-4 * np.abs(jlat).max(), rtol=0)
    plain = pipe(PROMPTS, NEGS, **kw)
    assert not np.allclose(plain, lat, atol=1e-3)  # the guidance moved the latents
    assert np.array_equal(pipe(PROMPTS, NEGS, **dict(slg, slg_scale=0.0), **kw), plain)


def test_flux_txt2img_reads_its_component_files(tmp_path, tiny_presets, monkeypatch, vocab_files):  # noqa: F811
    """Every leaf of the transformer, both towers and the VAE is the file's;
    the T5 tokenizer pads to Flux's 512 tokens."""
    monkeypatch.setitem(FLUX_PRESETS, "flux_dev", dict(FLUX_PRESETS["tiny"], in_channels=16, context_dim=32,
                                                       pooled_dim=32))
    src = serving.flux_txt2img("cpu", torch.float32, seed=3)
    clip_l, t5 = src.te.module.text_models
    files = {key: _write(tmp_path / f"{key}.safetensors", it.export_params(m, key_map)) for key, m, key_map in (
        ("transformer", src.model, it.flux_key_map), ("text_encoder", clip_l, it.clip_text_key_map),
        ("text_encoder_2", t5, it.t5_key_map), ("vae", src.vae, it.vae_key_map))}
    spm = tmp_path / "spiece.model"
    spm.write_bytes(serialize_sentencepiece_model(_PIECES))
    pipe = serving.flux_txt2img("cpu", torch.float32, seed=4, component_files=files,
                                tokenizer_files=[(str(vocab_files[0]), str(vocab_files[1])), str(spm)])
    for a, b in ((src.model, pipe.model), (src.te.module, pipe.te.module), (src.vae, pipe.vae)):
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert pipe.te.tokenizers[1](["the quick fox"], padding=True)["input_ids"].shape == (1, 512)
    with pytest.raises(ValueError, match="text_encoder_2"):
        serving.flux_txt2img("cpu", torch.float32, component_files={k: v for k, v in files.items()
                                                                    if k != "text_encoder_2"})


def test_server_pads_and_sheds_sd3_requests(tiny_presets):
    """Three SD3 requests form one group at the batch ladder's 4 (padded with
    the last), each lane its lone run's latents; at ``max_queue`` a fourth
    submission is shed."""
    pipe = serving.sd3_pipeline("cpu", torch.float32, seed=2)
    calls = []
    inner = pipe.sample_device

    def recording(**kw):
        calls.append(kw["num_samples"])
        return inner(**kw)

    pipe.sample_device = recording
    server = serving.BatchingServer(pipe, buckets=[(16, 16)], max_batch=4, max_wait_s=0.5, max_queue=3)
    reqs = [serving.Request(prompt=p, width=16, height=16, num_steps=2, cfg_scale=4.0, seed=11 + i,
                            return_latents=True) for i, p in enumerate(["the fox", "a cat", "abc"])]
    futs = [server.submit(r) for r in reqs]
    with pytest.raises(serving.ServerOverloaded):
        server.submit(reqs[0])
    server.start()
    try:
        got = [fut.result(timeout=120) for fut in futs]
    finally:
        server.stop()
    assert calls == [4]
    for r, lat in zip(reqs, got):
        lone = inner(r.prompt, num_steps=2, num_samples=1, cfg_scale=4.0, width=16, height=16, seed=r.seed,
                     return_latents=True)[0]
        assert lat.shape == (16, 16, 16)
        np.testing.assert_allclose(lat, lone[0].numpy(), atol=1e-5 * np.abs(lat).max(), rtol=0)


def test_sd3_and_flux_pipelines_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (serving.sd3_pipeline, serving.flux_txt2img):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
