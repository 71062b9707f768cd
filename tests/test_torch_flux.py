"""The port's Flux txt2img path and Flux training step against the JAX
package's, on the CPU, in fp32.

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
sampled latents within 1e-4 of theirs. The training step (bench.py's
flux_1b recipe at a small width with Flux's head dim 128) states its own
tolerances.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import FAST_COMPILE, compile_fast, random_params
from uwudiff_tpu.diffusion.losses import DiffusionLoss as JaxDiffusionLoss
from uwudiff_tpu.diffusion.losses import RectifiedFlowLoss as JaxRFLoss
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models import flux as jflux
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.text_encoders import TextEncodingPipeline as JaxTEPipeline
from uwudiff_tpu.models.tokenizers import SimpleTokenizer as JaxTokenizer
from uwudiff_tpu.models.vae import AutoencoderKL as JaxVAE
from uwudiff_tpu.parallel import batch_sharding, make_mesh
from uwudiff_tpu.sampling import get_sigmas as jsig
from uwudiff_tpu.sampling import noise as jnoise
from uwudiff_tpu.sampling.cfg import encode_cfg_inputs as jax_encode_cfg_inputs
from uwudiff_tpu.sampling.sampling import diffusion_sampling as jax_diffusion_sampling
from uwudiff_tpu.sampling.wrapper import RFDenoiser as JaxRFDenoiser
from uwudiff_tpu.training import DMTrainer as JaxTrainer
from uwudiff_tpu_torch import sampling as tsampling
from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule, RectifiedFlowLoss
from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders, Flux, SimpleTokenizer, TextEncodingPipeline
from uwudiff_tpu_torch.models import flux as tflux
from uwudiff_tpu_torch.sampling import encode_cfg_inputs
from uwudiff_tpu_torch.sampling import sampling as tsampling_module
from uwudiff_tpu_torch.training import DMTrainer

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
    model = Flux.from_config("tiny", device="cpu", **FLUX_OVERRIDES, **overrides)
    params = random_params(jmodel, x, t, ctx, mask, {"text_embeds": pooled}, seed=4, like=model)
    load_jax_params(model, params)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Flux.from_config("tiny", device="cpu", scan_blocks=True)
    assert Flux.from_config("tiny", device="cpu", gradient_checkpointing=True).gradient_checkpointing
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


@pytest.mark.parametrize("arg,value", [("latent_sharding", "data")])
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
    te_params = random_params(jte, [tok(prompts) for tok in toks], seed=5,
                              like=ConcatTextEncoders.from_config(TE_CFGS, device="cpu"))
    jvae = JaxVAE.from_config(VAE_CFG)
    z_probe = np.zeros((1, w, w, 16), np.float32)
    # the decoder's leaves drawn as decode's init draws them; the encoder's (which the port's VAE holds too) beside
    vae_params = {**random_params(jvae, np.zeros((1, w, w, 3), np.float32), jax.random.PRNGKey(1), seed=6),
                  **random_params(jvae, z_probe, method=jvae.decode, seed=6)}
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


# ---------------------------------------------------------------- training
# bench.py's flux_1b step at a small width with Flux's head dim 128 (hidden
# 256, 2 heads, axes (16, 56, 56)), one block of each kind, the recipe's
# adamw_factored in fp32, through the JAX package's DMTrainer (its blocks
# under nn.remat) and the port's, remat on and off; and the rectified-flow
# loss Flux users train with (configs/demo_training_flux.yaml)
STEP_MODEL = dict(hidden_size=256, num_heads=2, depth=1, depth_single=1, axes_dims=(16, 56, 56), in_channels=16,
                  context_dim=32, pooled_dim=32)
STEP_OPT = {"weight_decay": 0.01, "betas": (0.9, 0.999), "clipping_threshold": 1.0}
STEP_KW = dict(lr=1e-3, optimizer="adamw_factored", opt_config=STEP_OPT, use_warm_up=False, grad_clip=None, seed=0)


def _step_batch():
    rng = np.random.default_rng(11)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    return {"sample": rng.standard_normal((2, 8, 8, 16)).astype(np.float32),
            "ctx": rng.standard_normal((2, 8, 32)).astype(np.float32), "ctx_mask": mask,
            "pooled": rng.standard_normal((2, 32)).astype(np.float32), "tokenizer_outputs": []}


def _step_loss(kind, jax_side):
    if kind == "eps":
        return (JaxDiffusionLoss(schedule=JaxSchedule.sd15()) if jax_side
                else DiffusionLoss(schedule=NoiseSchedule.sd15()))
    return (JaxRFLoss(schedule=JaxSchedule.sdxl(), time_sampling_type="logit_normal") if jax_side
            else RectifiedFlowLoss(schedule=NoiseSchedule.sdxl(), time_sampling_type="logit_normal"))


@functools.lru_cache(maxsize=None)
def _jax_trainer(kind):
    """The JAX trainer of the small Flux with ``kind``'s loss: DiffusionLoss
    with its blocks under ``nn.remat``, as ``bench.py`` trains flux_1b; the
    rectified-flow loss without."""
    jmodel = jflux.Flux.from_config("tiny", gradient_checkpointing=kind == "eps", **STEP_MODEL)
    jtr = JaxTrainer(model_config={"unet": jmodel, "te": None, "vae": None},
                     loss_config=_step_loss(kind, jax_side=True), **STEP_KW)
    jtr.mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])  # what setup builds, on one device
    jtr._batch_sh = batch_sharding(jtr.mesh)
    return jtr


@functools.lru_cache(maxsize=None)
def _jax_flux_programs():
    """The small Flux's random params and the JAX trainer's first step, the
    body of ``_train_step_impl`` in fp32 as three programs so that the two
    losses share the update's: ``jax.value_and_grad`` of the trainer's
    ``_loss_for_batch`` under the key its step 0 folds, for each loss, and
    ``(grads, params) -> params`` after one step of ``adamw_factored`` from
    its initial state (``tx.update``, then ``optax.apply_updates``). Each is
    traced here and compiled in a thread of its own (XLA's compile releases
    the interpreter lock), so the compiles run beside the tracing and the
    port's step; the futures are read by :func:`_jax_flux_step`."""
    batch = _step_batch()
    params = random_params(jflux.Flux.from_config("tiny", **STEP_MODEL), batch["sample"][:1],
                           np.zeros((1,), np.float32), batch["ctx"][:1], batch["ctx_mask"][:1],
                           {"text_embeds": batch["pooled"][:1]}, seed=12,
                           like=Flux.from_config("tiny", device="cpu", **STEP_MODEL))
    pool = ThreadPoolExecutor(3)
    programs = {}
    for kind in ("eps", "rf"):
        jtr = _jax_trainer(kind)
        put = jtr._put_batch(batch)

        def loss_and_grads(p, b, jtr=jtr):
            return jax.value_and_grad(lambda p_: jtr._loss_for_batch(p_, {}, b, _step_rng()), has_aux=True)(p)

        programs[kind] = (pool.submit(jax.jit(loss_and_grads).lower(params, put).compile, FAST_COMPILE), put)
    tx = _jax_trainer("eps").tx

    def update(grads, p):
        return optax.apply_updates(p, tx.update(grads, tx.init(p), p)[0])

    programs["update"] = pool.submit(jax.jit(update).lower(params, params).compile, FAST_COMPILE)
    pool.shutdown(wait=False)  # the threads end with their compiles
    return params, programs


def _step_rng():
    """The key the JAX trainer's step 0 passes its loss: its seed's, folded with the step."""
    return jax.random.fold_in(jax.random.PRNGKey(STEP_KW["seed"]), 0)


def _jax_draws(kind, x):
    """The JAX loss's draws at step 0, from its own samplers: the step's key
    split for (encode, loss, dropout), the loss's for (time, noise); noise and
    timesteps for DiffusionLoss, noise and the logit-normal z for the
    rectified-flow loss."""
    jloss = _jax_trainer(kind).loss
    rng_t, rng_n = jax.random.split(jax.random.split(_step_rng(), 3)[1])
    if kind == "eps":
        return dict(noise=np.array(jloss.sample_noise(rng_n, jnp.asarray(x))),
                    timesteps=np.array(jloss.sample_timesteps_and_sigmas(rng_t, x.shape[0])[0]))
    return dict(noise=np.array(jloss.get_x0_and_noises(rng_n, jnp.asarray(x))[1]),
                time_draws=np.array(jax.random.normal(rng_t, (x.shape[0],))))


@functools.lru_cache(maxsize=None)
def _jax_flux_step(kind):
    """The JAX trainer's first step with ``kind``'s loss: loss, grad norm,
    the target and timesteps it drew, the gradients and the params after the
    update (from :func:`_jax_flux_programs`)."""
    params, programs = _jax_flux_programs()
    compiled, put = programs[kind]
    (loss, aux), grads = compiled.result()(params, put)
    flat = dict(_flat_tree(jax.device_get(grads)))
    return {"loss": float(loss), "grad_norm": float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                                               for g in flat.values()))),
            "target": np.asarray(aux.target), "timesteps": np.asarray(aux.timesteps), "grads": flat,
            "params": dict(_flat_tree(jax.device_get(programs["update"].result()(grads, params))))}


def _flat_tree(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tree(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def _port_flux_trainer(kind, params, remat):
    model = load_jax_params(Flux.from_config("tiny", device="cpu", gradient_checkpointing=remat, **STEP_MODEL),
                            params)
    return DMTrainer({"unet": model, "te": None, "vae": None}, loss_config=_step_loss(kind, jax_side=False),
                     device="cpu", **STEP_KW)


@pytest.mark.parametrize("kind,remat", [("eps", True), ("eps", False), ("rf", True)])
def test_flux_training_step_at_head_dim_128_matches_jax(kind, remat):
    """One fp32 step at head dim 128: loss and grad norm within 1e-5
    relative; every gradient within 2e-4 of the leaf's largest and the
    median leaf within 5e-5 (fp32 sums in another order; the guidance
    sinusoid's phase, up to 3,500 rad, rounds by up to 1.2e-4 in fp32,
    which reaches ``g_fc1``'s gradient); every parameter's change within one
    bf16 step of its largest (the factored optimizer's bf16 momentum) plus
    two fp32 steps of the leaf against the JAX update of the port's own
    gradients, and within 1e-2 of the JAX step's change in norm (an
    unfactored leaf's first step, g / sqrt(g^2 + eps), turns a small
    gradient's rounding into a large change of that element). The port with
    remat on and off computes the same gradients, bitwise."""
    params, programs = _jax_flux_programs()  # compiling while the port's step runs
    batch = _step_batch()
    draws = _jax_draws(kind, batch["sample"])
    tr = _port_flux_trainer(kind, params, remat)
    assert tr.unet.single_blocks_0.attn1.norm_q.weight.shape == (128,)  # the head dim
    grads = {}
    apply_updates = tr.apply_updates

    def capture(sr_bits=None):
        grads.update({n: p.grad.detach().clone() for n, p in tr.params})
        return apply_updates(sr_bits)

    tr.apply_updates = capture
    m, aux = tr.train_step(batch, **draws)
    ref = _jax_flux_step(kind)
    want_target = draws["noise"] if kind == "eps" else draws["noise"] - batch["sample"]
    np.testing.assert_allclose(ref["target"], want_target, atol=1e-6)  # the draws the JAX step made
    np.testing.assert_allclose(float(m["train/loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["train/grad_norm"]), ref["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(aux.timesteps.numpy(), ref["timesteps"], rtol=1e-5)
    grad_tree = to_jax_params(tr.unet, grads)
    got_grads, got_params = dict(_flat_tree(grad_tree)), dict(_flat_tree(to_jax_params(tr.unet)))
    p0 = dict(_flat_tree(params))
    same_grads = dict(_flat_tree(jax.device_get(programs["update"].result()(grad_tree, params))))
    assert set(got_grads) == set(ref["grads"]) == set(p0)
    rel = []
    for name, want in ref["grads"].items():
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got_grads[name], want, atol=2e-4 * np.abs(want).max(), rtol=0, err_msg=name)
        rel.append(np.abs(got_grads[name] - want).max() / np.abs(want).max())
        jd, td = same_grads[name] - p0[name], got_params[name] - p0[name]
        tol = 2.0**-8 * np.abs(jd).max() + 2.0**-22 * np.abs(p0[name]).max()
        np.testing.assert_allclose(td, jd, atol=tol, rtol=0, err_msg=name)
        jd = ref["params"][name] - p0[name]
        assert np.linalg.norm(td - jd) <= 1e-2 * np.linalg.norm(jd), name
    assert np.median(rel) <= 5e-5, np.median(rel)
    if not remat:  # the same step's gradients with each block recomputed in the backward
        again = _port_flux_trainer(kind, params, remat=True)
        again.forward_backward(batch, **draws)
        for name, p in again.params:
            assert torch.equal(p.grad, grads[name]), name
