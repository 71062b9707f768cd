"""The port's Flux txt2img path against the JAX package's, on the CPU, in fp32.

The rotary tables, the RF sigma ladders, the ``tiny`` Flux forward at one
block of each kind (with and without the text mask and the guidance
input), ``RFDenoiser``, the prompt padding and the whole slice: ``diffusion_sampling`` with a pooled-only CLIP, a T5 bucket
with its key mask, the tiny Flux and a 16-channel VAE decode. Weights are
``test_torch_models.random_params`` draws (which fill the leaves the JAX
init zeroes, so the model's output is not identically zero), carried
across by ``convert.load_jax_params``. JAX's threefry draws cannot be made
in torch, so the JAX side's init and step noise are fed to the port. The
one-block pair is built once for the module and shared by the forward
tests and the slice, and the JAX programs are compiled with the suite's
cheap compiler settings (``FAST_COMPILE``), each once. Tolerances: tables
bitwise, ladders exactly, the rotation within 1e-6, the forward within
1e-4 of the output's largest element (fp32 sums in another order), the
sampled latents within 1e-4 of theirs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import FAST_COMPILE, compile_fast, random_params
from uwudiff_tpu.diffusion.losses import RectifiedFlowLoss as JaxRFLoss
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models import flux as jflux
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.text_encoders import TextEncodingPipeline as JaxTEPipeline
from uwudiff_tpu.models.tokenizers import SimpleTokenizer as JaxTokenizer
from uwudiff_tpu.models.vae import AutoencoderKL as JaxVAE
from uwudiff_tpu.sampling import get_sigmas as jsig
from uwudiff_tpu.sampling import noise as jnoise
from uwudiff_tpu.sampling.cfg import encode_cfg_inputs as jax_encode_cfg_inputs
from uwudiff_tpu.sampling.sampling import diffusion_sampling as jax_diffusion_sampling
from uwudiff_tpu.sampling.wrapper import RFDenoiser as JaxRFDenoiser
from uwudiff_tpu_torch import sampling as tsampling
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule, RectifiedFlowLoss
from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders, Flux, SimpleTokenizer, TextEncodingPipeline
from uwudiff_tpu_torch.models import flux as tflux
from uwudiff_tpu_torch.sampling import encode_cfg_inputs
from uwudiff_tpu_torch.sampling import sampling as tsampling_module

# the Flux text stack: CLIP in the pooled-only slot, T5 in bucket 1 with its key mask
TE_CFGS = [
    ({"model_type": "clip", "preset": "tiny", "num_layers": 1}, {"use_pooled": True, "pooled_only": True}),
    ({"model_type": "t5", "preset": "tiny", "num_layers": 1}, {"concat_bucket": 1, "need_mask": True}),
]
T5_LEN = 12
FLUX_OVERRIDES = dict(context_dim=32, pooled_dim=32, in_channels=16)  # the tiny towers' widths, 16 latent channels
VAE_CFG = dict(block_out_channels=(32,), layers_per_block=1, latent_channels=16, norm_num_groups=8,
               scaling_factor=0.3611)
VAE_MEAN = 0.1159


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    t = np.array([3.5, 871.25], np.float32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    pooled = rng.standard_normal((2, 32)).astype(np.float32)
    return x, t, ctx, mask, pooled


def _flux_pair(**overrides):
    """A tiny JAX Flux, its random params and the port's Flux with them."""
    x, t, ctx, mask, pooled = _inputs()
    jmodel = jflux.Flux.from_config("tiny", **FLUX_OVERRIDES, **overrides)
    params = random_params(jmodel, x, t, ctx, mask, {"text_embeds": pooled}, seed=4)
    model = load_jax_params(Flux.from_config("tiny", device="cpu", **FLUX_OVERRIDES, **overrides), params)
    return jmodel, params, model


@pytest.fixture(scope="module")
def flux_pair():
    """One block of each kind: the forward tests' model and the slice's."""
    return _flux_pair(depth=1, depth_single=1)


def test_rope_tables_and_rotation_match_jax():
    ids = jflux._joint_ids(3, 5, 4)
    np.testing.assert_array_equal(tflux._joint_ids(3, 5, 4), ids)
    for axes in ((4, 6, 6), (16, 56, 56)):
        for got, want in zip(tflux.flux_rope_table(ids, axes), jflux.flux_rope_table(ids, axes)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    cos, sin = jflux.flux_rope_table(ids, (4, 6, 6))
    x = np.random.default_rng(1).standard_normal((2, ids.shape[0], 2, 16)).astype(np.float32)
    want = np.asarray(compile_fast(jflux.apply_flux_rope, x, cos, sin)(x, cos, sin))
    tables = (torch.from_numpy(t)[None, :, None] for t in (cos, sin))
    got = tflux.apply_flux_rope(torch.from_numpy(x), *tables)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _ladder(mod, kind):
    disc = {"uniform": None, "shift": functools.partial(mod.shift_time, shift=3.0),
            "dynamic": functools.partial(mod.dynamic_shift_time, mu=mod.mu_for_image_seq_len(4096))}[kind]
    return mod.get_sigmas_for_rf(4, max_sigma=14.6146, time_disc_func=disc)


@pytest.mark.parametrize("kind", ["uniform", "shift", "dynamic"])
def test_rf_sigma_ladders_match_jax_exactly(kind):
    ladder = _ladder(tsampling, kind)
    np.testing.assert_array_equal(ladder, _ladder(jsig, kind))
    assert ladder.shape == (5,) and ladder[-1] == 0.0 and np.all(np.diff(ladder) < 0)
    assert tsampling.mu_for_image_seq_len(4096) == jsig.mu_for_image_seq_len(4096) == pytest.approx(1.15)
    np.testing.assert_array_equal(tsampling.uniform_time(0.1, 0.9, 6), jsig.uniform_time(0.1, 0.9, 6))


FORWARD_CASES = [(True, 2.25), (False, None)]  # (the text mask, the guidance input)


def _added(pooled, guidance):
    return {"text_embeds": pooled} if guidance is None else {
        "text_embeds": pooled, "guidance": np.full((pooled.shape[0],), guidance, np.float32)}


@pytest.fixture(scope="module")
def flux_forward_refs(flux_pair):
    """The JAX forward at each of FORWARD_CASES, all from one compile."""
    jmodel, params, _ = flux_pair
    x, t, ctx, mask, pooled = _inputs(seed=1)

    def forwards(p):
        return [jmodel.apply({"params": p}, x, t, ctx, mask if masked else None, _added(pooled, guidance))
                for masked, guidance in FORWARD_CASES]

    return [np.asarray(r) for r in compile_fast(forwards, params)(params)]


@pytest.mark.parametrize("masked,guidance", FORWARD_CASES)
def test_flux_forward_matches_jax(flux_pair, flux_forward_refs, masked, guidance):
    _, _, model = flux_pair
    ref = flux_forward_refs[FORWARD_CASES.index((masked, guidance))]
    x, t, ctx, mask, pooled = _inputs(seed=1)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x, t, ctx)), torch.from_numpy(mask) if masked else None,
                    {k: torch.from_numpy(v) for k, v in _added(pooled, guidance).items()})
    assert out.shape == x.shape and out.dtype == torch.float32
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_flux_loads_a_scanned_tree_and_zero_initialises(flux_pair):
    # the tiny preset's two blocks of each kind: the pair's one, and a second drawn from it
    params = dict(flux_pair[1])
    for stack in ("blocks", "single_blocks"):
        params[f"{stack}_1"] = jax.tree_util.tree_map(lambda a: -0.5 * np.asarray(a), params[f"{stack}_0"])
    model = load_jax_params(Flux.from_config("tiny", device="cpu", **FLUX_OVERRIDES), params)
    # scan_blocks=True stacks blocks_{i} and single_blocks_{i} each along a leading layer axis
    scanned = {k: v for k, v in params.items() if not k.startswith(("blocks_", "single_blocks_"))}
    for stack in ("blocks", "single_blocks"):
        scanned[stack] = jax.tree_util.tree_map(lambda *a: np.stack(a), params[f"{stack}_0"], params[f"{stack}_1"])
    again = load_jax_params(Flux.from_config("tiny", device="cpu", **FLUX_OVERRIDES), scanned)
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    bad = {**scanned, "single_blocks": jax.tree_util.tree_map(lambda a: a[:1], scanned["single_blocks"])}
    with pytest.raises(ValueError, match="layer axes"):
        load_jax_params(again, bad)
    fresh = Flux.from_config("tiny", device="cpu", **FLUX_OVERRIDES)
    x, t, ctx, mask, pooled = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        assert not fresh(x, t, ctx, mask, {"text_embeds": pooled}).any()  # adaLN-Zero
    for key in ("scan_blocks", "gradient_checkpointing"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Flux.from_config("tiny", device="cpu", **{key: True})
    with pytest.raises(ValueError, match="axes_dims"):
        Flux.from_config("tiny", device="cpu", axes_dims=(4, 4, 4))


def test_rf_denoiser_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 4, 16)).astype(np.float32)
    sigma = np.array([14.6, 1.3, 0.02], np.float32)

    def velocity(xp, t, **_):  # a fixed model: the scaled input and the timestep
        return 0.3 * xp + (t / 1000.0).reshape(-1, 1, 1, 1)

    denoiser = JaxRFDenoiser(model_fn=velocity, schedule=JaxSchedule.sdxl())
    want = compile_fast(lambda x, s: denoiser(x, s), x, sigma)(x, sigma)
    got = tsampling.RFDenoiser(model_fn=velocity, schedule=NoiseSchedule.sdxl())(
        torch.from_numpy(x), torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    sched = NoiseSchedule.sdxl()
    assert tsampling.denoiser_for_loss(RectifiedFlowLoss(schedule=sched)) is tsampling.RFDenoiser
    assert tsampling.denoiser_for_loss(DiffusionLoss(schedule=sched)) is tsampling.KDiffusionDenoiser
    from uwudiff_tpu.sampling.wrapper import denoiser_for_loss as jax_denoiser_for_loss

    assert jax_denoiser_for_loss(JaxRFLoss(schedule=JaxSchedule.sdxl())) is JaxRFDenoiser


@pytest.mark.parametrize("arg,value", [("prompt_weighting", True), ("long_prompt", True), ("cfg_interval", (1.0, 5.0)),
                                       ("unet_skip_fn", lambda *a: a), ("latent_sharding", "data"),
                                       ("sample_schedule", NoiseSchedule.sdxl()), ("rescale", True),
                                       ("internal_sampling_func", lambda *a: a)])
def test_diffusion_sampling_refuses_unported_arguments(arg, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsampling.diffusion_sampling(None, None, None, NoiseSchedule.sdxl(), "a", "", **{arg: value})


def test_diffusion_sampling_defaults_to_the_training_schedules_ladder():
    """With no ``get_sigma_func`` the ladder is the training schedule's own
    (``sample_sigmas_descending``, held to JAX in ``test_torch_models``)."""
    te = ConcatTextEncoders.from_config(TE_CFGS, device="cpu")
    te_pipe = TextEncodingPipeline(te, [SimpleTokenizer(), SimpleTokenizer(model_max_length=T5_LEN)], device="cpu")
    sched = NoiseSchedule.sdxl()
    run = functools.partial(tsampling.diffusion_sampling, lambda x, t, *_: 0.1 * x, te_pipe, None, sched, "a", "",
                            num_steps=3, num_samples=2, cfg_scale=1.0, width=8, height=8, vae_downscale=1,
                            seed=[3, 4])
    want = run(get_sigma_func=lambda n: sched.sample_sigmas_descending(n).numpy())
    assert torch.equal(run(), want) and not torch.equal(run(num_steps=4), want)


@pytest.mark.parametrize("mode", ["repeat_last", "cycling"])
def test_prompt_padding_matches_jax(mode):
    from uwudiff_tpu.utils import truncate_or_pad_to_length as jax_pad
    from uwudiff_tpu_torch.utils import truncate_or_pad_to_length

    for prompts, n in ((["a", "b", "c"], 7), (["a", "b", "c"], 2), (["a"], 3)):
        assert truncate_or_pad_to_length(list(prompts), n, mode) == jax_pad(list(prompts), n, padding_mode=mode)


def test_flux_txt2img_matches_jax(flux_pair, monkeypatch):
    """``diffusion_sampling`` as Flux is served: the pooled-only CLIP and the
    masked T5 bucket, cfg 1 (one conditional pass), RFDenoiser, the
    dynamic-shift RF ladder, per-sample seeds, a 16-channel VAE decode (one
    level, so ``vae_downscale`` is 1). One block of each kind and two steps: the JAX side compiles the whole loop,
    with the suite's cheap compiler settings (its ``jax.jit`` calls take
    ``FAST_COMPILE`` while it runs), and the decode and the noise draws
    once each."""
    jmodel, params, model = flux_pair
    # one VAE level (no upsampler): 32x32 latents, 16x16 = 256 image tokens after the 2x2 packing
    prompts, steps, w, seeds = ["a lighthouse at dusk", "a fox"], 2, 32, [5, 9]
    toks = [JaxTokenizer(), JaxTokenizer(model_max_length=T5_LEN)]
    jte = JaxConcat.from_config(TE_CFGS)
    te_params = random_params(jte, [tok(prompts) for tok in toks], seed=5)
    jvae = JaxVAE.from_config(VAE_CFG)
    z_probe = np.zeros((1, w, w, 16), np.float32)
    vae_params = random_params(jvae, z_probe, method=jvae.decode, seed=6)
    sigma_fn = functools.partial(jsig.get_sigmas_for_rf, max_sigma=14.6146, time_disc_func=functools.partial(
        jsig.dynamic_shift_time, mu=jsig.mu_for_image_seq_len((w // 2) ** 2)))
    kw = dict(num_steps=steps, num_samples=2, cfg_scale=1.0, seed=seeds, width=w, height=w,
              vae_std=1 / 0.3611, vae_mean=VAE_MEAN, latent_channels=16, vae_downscale=1, get_sigma_func=sigma_fn)

    def unet_fn(p, x, t, ctx, mask, added_cond):
        return jmodel.apply({"params": p}, x, t, ctx, mask, added_cond)

    with monkeypatch.context() as m:
        m.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
        jte_pipe = JaxTEPipeline(jte, te_params, toks)
        jlat = jax_diffusion_sampling(unet_fn, jte_pipe, None, JaxSchedule.sdxl(),
                                      prompts, ["", ""], denoiser_cls=JaxRFDenoiser, unet_params=params,
                                      return_latents=True, **kw)
    decode = functools.partial(jvae.apply, method=jvae.decode)
    jimg = np.asarray(compile_fast(decode, {"params": vae_params}, jlat)({"params": vae_params}, jlat))

    # the JAX side's draws, fed to the port: init noise, and each step's by its interval
    sigmas = np.asarray(sigma_fn(steps), np.float32)
    shape = (w, w, 16)

    def draws(seed_arr):
        keys = jnoise.per_sample_keys(seed_arr)
        draw = jnoise.make_per_sample_noise_sampler(keys)
        return jnoise.per_sample_init_noise(keys, shape), [
            draw(None, (2, *shape), s, s_next) for s, s_next in zip(sigmas[:-1], sigmas[1:])]

    seed_arr = jnp.asarray(np.asarray(seeds, np.uint32))
    init, step_noise = compile_fast(draws, seed_arr)(seed_arr)
    init, step_noise = torch.from_numpy(np.array(init)), [torch.from_numpy(np.array(n)) for n in step_noise]
    monkeypatch.setattr(tsampling_module, "per_sample_init_noise", lambda *a, **k: init.clone())
    monkeypatch.setattr(tsampling_module, "make_per_sample_noise_sampler", lambda *a, **k: (
        lambda shape_, s, s_next: step_noise[int(np.argmin(np.abs(sigmas[:-1] - s)))]))

    te = load_jax_params(ConcatTextEncoders.from_config(TE_CFGS, device="cpu"), te_params)
    te_pipe = TextEncodingPipeline(te, [SimpleTokenizer(), SimpleTokenizer(model_max_length=T5_LEN)], device="cpu")
    vae = load_jax_params(AutoencoderKL.from_config(VAE_CFG, device="cpu"), vae_params)
    tkw = dict(kw, get_sigma_func=functools.partial(tsampling.get_sigmas_for_rf, max_sigma=14.6146,
                                                    time_disc_func=functools.partial(
                                                        tsampling.dynamic_shift_time,
                                                        mu=tsampling.mu_for_image_seq_len((w // 2) ** 2))))
    run = functools.partial(tsampling.diffusion_sampling, lambda m, *a: m(*a), te_pipe, vae.decode,
                            NoiseSchedule.sdxl(), prompts, ["", ""], denoiser_cls=tsampling.RFDenoiser,
                            unet_params=model, **tkw)
    # the conditioning: T5's sequence and key mask, CLIP's pooled vector alone
    enc, jenc = encode_cfg_inputs(prompts, ["", ""], w, w, te_pipe), jax_encode_cfg_inputs(
        prompts, ["", ""], w, w, jte_pipe)
    assert enc["ctx"].shape == (4, T5_LEN, 32) and enc["added_cond"]["text_embeds"].shape == (4, 32)
    for got, want in ((enc["ctx"], jenc["ctx"]), (enc["mask"], jenc["mask"]),
                      (enc["added_cond"]["text_embeds"], jenc["added_cond"]["text_embeds"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    lat = run(return_latents=True)
    images = run()
    jlat = np.asarray(jlat)
    assert lat.shape == jlat.shape == (2, w, w, 16)
    assert np.isfinite(lat.numpy()).all() and np.abs(jlat - VAE_MEAN).max() > 0
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-4 * np.abs(jlat).max(), rtol=0)
    want = ((np.clip(jimg, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)
    assert len(images) == 2 and images[0].shape == (w, w, 3) and images[0].dtype == np.uint8
    # a pixel may round across a level boundary; no more than one level off
    assert max(np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(images, want)) <= 1
