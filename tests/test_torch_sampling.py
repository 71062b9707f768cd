"""The port's sampling surface against the JAX package's, on the CPU, in fp32.

- Every sampler of ``sampling/`` (and the inversion mode of the two that
  use it) on one closed-form denoiser written twice, in torch and in
  jax.numpy, over a Karras ladder. Step noise comes from one table of
  numpy normals keyed by the interval: the port asks for each interval it
  draws over, and the JAX side's ``noise_sampler`` (inside ``lax.scan``,
  with traced sigmas) looks up the nearest interval of the table.
  Tolerance: 1e-5 of the output's largest element (fp32 sums and
  transcendental functions in another order).
- The k-diffusion ladders, exactly or to 1e-6 where a schedule's sigma
  table enters; the denoisers (v-prediction, EDM, LCM, ``sigma_cond``,
  ``quantize``) to 1e-5 (1e-6 for the timestep).
- At the tiny presets (the two-tower CLIP and ``tiny_sdxl`` UNet of
  ``test_torch_serving``, the UNet at one level, the ``tiny`` VAE): ``diffusion_sampling`` with
  another sampler, a second schedule, the per-sample rescale and a CFG
  window; the VAE encoder and its weights' carry-over; tiled encode and
  decode at 2x2 and 3x3 tiles; ``image_to_image_sampling`` with and without
  an inpainting mask; ``euler_latent_sampling``'s inversion with CFG++. The
  JAX side's threefry draws are fed to the port. Tolerance 1e-4 of the
  largest element (a UNet in fp32 through several steps), the encoder's
  moments 1e-5.

Every JAX program is compiled once, with the suite's cheap compiler
settings (``FAST_COMPILE``): the 14 sampler twins as one program; the
tiny-preset entry points in the background from the module's start.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import FAST_COMPILE, compile_fast, random_params
from uwudiff_tpu import sampling as jsampling
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.text_encoders import TextEncodingPipeline as JaxTEPipeline
from uwudiff_tpu.models.tokenizers import SimpleTokenizer as JaxTokenizer
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu.models.vae import AutoencoderKL as JaxVAE
from uwudiff_tpu.sampling import noise as jnoise
from uwudiff_tpu_torch import sampling as tsampling
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders, SimpleTokenizer, TextEncodingPipeline
from uwudiff_tpu_torch.models import UNet2DConditionModel
from uwudiff_tpu_torch.sampling import sampling as tsampling_module

REL = 1e-5


def assert_rel(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------- samplers


def _denoiser(xp, x, sigma, sigma_cond):
    """A smooth closed-form (denoised, uncond) pair in either package's ops:
    the data estimate shrinks x by 1/(1 + sigma^2) and bends it, the
    conditioning sigma enters too, and the uncond output differs from it."""
    s = sigma.reshape(-1, 1, 1, 1)
    sc = (sigma if sigma_cond is None else sigma_cond).reshape(-1, 1, 1, 1)
    denoised = x / (1.0 + s * s) + 0.3 * xp.sin(x) * s / (1.0 + s * s) + 0.01 * sc
    return denoised, 0.9 * denoised + 0.05 * xp.tanh(x)


def _jax_model(x, sigma, sigma_cond=None):
    return _denoiser(jnp, x, sigma, sigma_cond)


def _torch_model(x, sigma, sigma_cond=None):
    return _denoiser(torch, x, sigma, sigma_cond)


SHAPE = (2, 4, 4, 3)
LADDER = tsampling.karras_sigmas(6, sigma_min=0.03, sigma_max=14.6)
INVERSE = np.concatenate([LADDER[-2::-1]])  # ascending from the smallest nonzero sigma, no 0

# (name, options): a stochastic sampler's draws, the churn's, dpm2's cached
# derivative, the heun solver of 2M SDE
SAMPLER_CASES = [
    ("euler_ancestral", dict(eta=0.8, s_noise=1.1)),
    ("euler_ancestral_cfgpp", dict()),
    ("heun", dict(s_churn=0.5)),
    ("dpm2", dict(s_churn=0.5, single_call=True)),
    ("dpm2_cfgpp", dict(single_call=True)),
    ("dpmpp_2m", dict()),
    ("dpmpp_2m_sde", dict(eta=0.9, solver_type="heun")),
    ("dpmpp_2s_ancestral", dict()),
    ("dpmpp_sde", dict()),
    ("dpmpp_3m_sde", dict()),
    ("unipc", dict()),
    ("lcm", dict()),
]
JAX_NAMES = {"euler_ancestral": "sample_euler_ancestral", "euler_ancestral_cfgpp": "sample_euler_ancestral_cfgpp"}


class NoiseTable:
    """One numpy normal per interval, made the first time the port asks."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.pairs, self.draws = [], []

    def torch_sampler(self, shape, sigma, sigma_next):
        key = (np.float32(sigma), np.float32(sigma_next))
        if key not in self.pairs:
            self.pairs.append(key)
            self.draws.append(self.rng.standard_normal(shape).astype(np.float32))
        return torch.from_numpy(self.draws[self.pairs.index(key)])

    def jax_sampler(self):
        pairs = jnp.asarray(np.asarray(self.pairs, np.float32).reshape(-1, 2))
        draws = jnp.asarray(np.stack(self.draws)) if self.draws else jnp.zeros((1, *SHAPE), jnp.float32)

        def sampler(rng, shape, sigma, sigma_next):
            del rng
            if not self.draws:  # the port drew nothing: any draw the JAX loop makes is scaled by 0
                return jnp.zeros(shape, jnp.float32)
            dist = jnp.abs(pairs[:, 0] - sigma) + jnp.abs(pairs[:, 1] - sigma_next)
            return draws[jnp.argmin(dist)]

        return sampler


# the inversion mode (image_to_noise: an ascending ladder, the model
# conditioned on the next sigma, eta 0) of the two samplers that use it
INVERSION_CASES = [("euler_ancestral", dict(eta=0.0)), ("euler_ancestral_cfgpp", dict(eta=0.0))]
CASES = [(n, o, False) for n, o in SAMPLER_CASES] + [(n, o, True) for n, o in INVERSION_CASES]
CASE_IDS = [n for n, _ in SAMPLER_CASES] + [n + "-image_to_noise" for n, _ in INVERSION_CASES]


def _run_case(name, options, inversion):
    """The port's result of a case, and its JAX twin as a function of x0."""
    tsampler = tsampling.SAMPLERS[name]
    jsampler = getattr(jsampling, JAX_NAMES.get(name, "sample_" + name))
    sigmas = INVERSE if inversion else LADDER
    kw = dict(options, image_to_noise=True) if inversion else dict(options)
    x0 = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * float(sigmas[0])
    table = NoiseTable(2)
    stochastic = tsampling.supports_noise_sampler(tsampler)
    assert stochastic == jnoise.supports_noise_sampler(jsampler)
    got = tsampler(_torch_model, torch.from_numpy(x0), sigmas,
                   **(dict(noise_sampler=table.torch_sampler) if stochastic else {}), **kw)
    jkw = dict(kw, noise_sampler=table.jax_sampler()) if stochastic else kw
    return x0, got, lambda x: jsampler(_jax_model, x, jnp.asarray(sigmas), **jkw)


@pytest.fixture(scope="module")
def sampler_results():
    """Every case's (port, JAX) results; the JAX twins in one program."""
    runs = [_run_case(*case) for case in CASES]
    x0s = [x0 for x0, _, _ in runs]
    want = compile_fast(lambda xs: [fn(x) for (_, _, fn), x in zip(runs, xs)], x0s)(x0s)
    return {case_id: (got, w) for case_id, (_, got, _), w in zip(CASE_IDS, runs, want)}


@pytest.mark.parametrize("name,options,inversion", CASES, ids=CASE_IDS)
def test_sampler_matches_jax(name, options, inversion, sampler_results, request):
    """fp32, 1e-5 of the result's largest element."""
    got, want = sampler_results[request.node.callspec.id]
    assert_rel(got, want, REL)
    if not inversion and name != "lcm" and not name.startswith("euler"):
        # the flag is taken and unused, as in the JAX package
        tsampler = tsampling.SAMPLERS[name]
        table = NoiseTable(2)
        noise = dict(noise_sampler=table.torch_sampler) if tsampling.supports_noise_sampler(tsampler) else {}
        x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * float(LADDER[0]))
        assert torch.equal(tsampler(_torch_model, x0, LADDER, image_to_noise=True, **noise, **options), got)


def test_samplers_without_a_noise_sampler_draw_from_the_generator():
    """The seed-derived fallback: a stochastic sampler given no
    ``noise_sampler`` draws from ``generator``, reproducibly."""
    x = torch.ones(SHAPE)
    runs = [tsampling.sample_dpmpp_sde(_torch_model, x, LADDER, generator=tsampling.batch_fallback_generator([s], "cpu"))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(tsampling.sample_unipc(_torch_model, x, LADDER, generator=torch.Generator()),
                       tsampling.sample_unipc(_torch_model, x, LADDER))


# ----------------------------------------------------------------- ladders

LADDERS = {
    "karras": dict(sigma_min=0.03, sigma_max=14.6, rho=7.0),
    "exponential": dict(sigma_min=0.03, sigma_max=14.6),
    "polyexponential": dict(sigma_min=0.03, sigma_max=14.6, rho=1.7),
    "beta": dict(sigma_min=0.03, sigma_max=14.6),
    "ays": dict(model="sd15"),
    "sigmoid_time": dict(rho=8),
    "sigmoid_time_scale": dict(rho=8),
}


@pytest.mark.parametrize("steps", [1, 4, 10, 25])
@pytest.mark.parametrize("kind", list(LADDERS))
def test_ladder_matches_jax(kind, steps):
    """Exactly (host numpy on both sides); the RF time warps through
    ``get_sigmas_for_rf``."""
    if kind.startswith("sigmoid"):
        want = jsampling.get_sigmas_for_rf(steps, 14.6, 0.02, functools.partial(getattr(jsampling, kind),
                                                                                 **LADDERS[kind]))
        got = tsampling.get_sigmas_for_rf(steps, 14.6, 0.02, functools.partial(getattr(tsampling, kind),
                                                                                **LADDERS[kind]))
    else:
        want = getattr(jsampling, f"{kind}_sigmas")(steps, **LADDERS[kind])
        got = getattr(tsampling, f"{kind}_sigmas")(steps, **LADDERS[kind])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_schedule_indexed_ladders_match_jax():
    """The beta ladder over a schedule's sigma table and the LCM ladder,
    exactly: the JAX functions index the port's table (the two packages'
    tables agree to 1e-5, ``test_torch_models.test_schedule_matches_jax``)."""
    sched = NoiseSchedule.sdxl()
    table = sched.sigmas.numpy()

    class PortTable:  # the JAX functions read these three from a schedule
        num_train_timesteps = sched.num_train_timesteps
        sigmas = table

        @staticmethod
        def sigma_for_timestep(t):
            return table[np.asarray(t)]

    for steps in (3, 8, 60):
        np.testing.assert_array_equal(tsampling.beta_sigmas(steps, schedule=sched),
                                      jsampling.beta_sigmas(steps, schedule=PortTable))
        np.testing.assert_array_equal(tsampling.get_sigmas_lcm(steps, sched),
                                      np.asarray(jsampling.get_sigmas_lcm(steps, PortTable)))
    assert tsampling.get_sigmas_lcm(4).dtype == np.float32


# ---------------------------------------------------------------- denoisers


def _eps(xp, x, t):
    return 0.3 * x + xp.reshape(t / 1000.0, (-1, 1, 1, 1))


@pytest.mark.parametrize("kind", ["eps_sigma_cond", "eps_quantize", "v", "edm", "lcm"])
def test_denoiser_matches_jax(kind):
    """fp32, 1e-5 relative (and the quantized timestep exactly)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    sigma = np.array([14.6, 1.3, 0.02], np.float32)
    sigma_cond = np.array([9.1, 0.7, 0.05], np.float32)
    jfn, tfn = functools.partial(_eps, jnp), functools.partial(_eps, torch)
    jsched, tsched = JaxSchedule.sdxl(), NoiseSchedule.sdxl()
    cond = kind in ("eps_sigma_cond", "lcm")
    if kind == "edm":
        jden, tden = jsampling.EDMDenoiser(jfn, sigma_data=0.6), tsampling.EDMDenoiser(tfn, sigma_data=0.6)
    elif kind == "v":
        jden, tden = jsampling.VDenoiser(jfn, jsched), tsampling.VDenoiser(tfn, tsched)
    elif kind == "lcm":
        jden = jsampling.LCMDenoiser(jfn, jsched, timestep_scaling=5.0)
        tden = tsampling.LCMDenoiser(tfn, tsched, timestep_scaling=5.0)
    else:
        quantize = kind == "eps_quantize"
        jden, tden = jsampling.KDiffusionDenoiser(jfn, jsched, quantize), tsampling.KDiffusionDenoiser(
            tfn, tsched, quantize)
        want_t = compile_fast(lambda s: jden.sigma_to_t(s), sigma)(sigma)
        np.testing.assert_allclose(tsched.sigma_to_t(torch.from_numpy(sigma), quantize=quantize).numpy(),
                                   np.asarray(want_t), rtol=1e-6)
    args = (x, sigma, sigma_cond) if cond else (x, sigma)
    want = compile_fast(lambda *a: jden(a[0], a[1], sigma_cond=a[2] if cond else None), *args)(*args)
    got = tden(*(torch.from_numpy(a) for a in args[:2]),
               sigma_cond=torch.from_numpy(sigma_cond) if cond else None)
    assert_rel(got, want, REL)
    if kind == "v":  # the wrapper a v-prediction loss names
        loss = DiffusionLoss(schedule=tsched, prediction_type="v_prediction")
        assert tsampling.denoiser_for_loss(loss) is tsampling.VDenoiser


# ------------------------------------------------------------ tiny presets
# the two tiny CLIP towers and the tiny_sdxl UNet of test_torch_serving at
# one level (its cross-attention level: a JAX program compiled in half the
# time), the tiny VAE (two levels: 2x downscale)
from test_torch_serving import TE_CFGS, UNET_OVERRIDES  # noqa: E402

UNET = dict(UNET_OVERRIDES, block_out_channels=(32,), down_block_types=("CrossAttnDownBlock2D",))

PROMPTS, NEGS = ["a cat on a mat", "a dog"], ["blurry", ""]
LAT = (2, 8, 8, 4)
TINY_REL = 1e-4
LIN = dict(beta_schedule="linear", beta_start=1e-4, beta_end=0.02)  # a second schedule, for the ladder
OPTIONS_KW = dict(num_steps=4, num_samples=2, cfg_scale=5.0, seed=[3, 4], width=64, height=64, rescale=True,
                  cfg_interval=(0.5, 5.0), vae_std=1 / 0.13025, return_latents=True)
IMG_SEED, IMG_STD = 11, 1 / 0.18215
INVERT_KW = dict(image_to_noise=True, cfg_scale=2.0, use_cfgpp=True, num_steps=4, seed=5, vae_downscale=8)


def _mask():
    mask = np.zeros((2, 8, 8, 1), np.float32)
    mask[:, :, 4:] = 1.0
    return mask


def _img2img_kw(masked):
    return dict(strength=0.6, num_steps=5, cfg_scale=4.0, seed=IMG_SEED, vae_std=IMG_STD, vae_downscale=2,
                return_latents=True, inpaint_mask=_mask() if masked else None,
                cfg_interval=(0.1, 5.0) if masked else None)


def _images():
    return np.random.default_rng(8).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def stack():
    """(JAX text pipeline, JAX UNet apply, its params, port text pipeline, port UNet)."""
    jte = JaxConcat.from_config(TE_CFGS)
    tok = JaxTokenizer()
    te_params = random_params(jte, [tok(PROMPTS + NEGS)] * 2, seed=1,
                              like=ConcatTextEncoders.from_config(TE_CFGS, device="cpu"))
    jte_pipe = JaxTEPipeline(jte, te_params, [JaxTokenizer(), JaxTokenizer()])
    junet = JaxUNet.from_config("tiny_sdxl", **UNET)
    ctx = np.zeros((4, 77, 64), np.float32)
    added = {"time_ids": np.zeros((4, 6), np.float32), "text_embeds": np.zeros((4, 32), np.float32)}
    unet_params = random_params(junet, np.zeros((4, *LAT[1:]), np.float32), np.zeros(4, np.float32), ctx, None,
                                added, seed=2, like=UNet2DConditionModel.from_config("tiny_sdxl", device="cpu", **UNET))
    te = load_jax_params(ConcatTextEncoders.from_config(TE_CFGS, device="cpu"), te_params)
    te_pipe = TextEncodingPipeline(te, [SimpleTokenizer(), SimpleTokenizer()], device="cpu")
    unet = load_jax_params(UNet2DConditionModel.from_config("tiny_sdxl", device="cpu", **UNET), unet_params)

    # one jitted function: the entry points' programs each trace the UNet
    # once for their scans, and JAX traces a jitted callee once per input type
    unet_fn = jax.jit(lambda p, x, t, c, m, a: junet.apply({"params": p}, x, t, c, m, a))
    return jte_pipe, unet_fn, unet_params, te_pipe, unet


@pytest.fixture(scope="module")
def vae_pair():
    jvae = JaxVAE.from_config("tiny")
    params = random_params(jvae, np.zeros((1, 16, 16, 3), np.float32), jax.random.PRNGKey(1), seed=7,
                           like=AutoencoderKL.from_config("tiny", device="cpu"))
    return jvae, params, load_jax_params(AutoencoderKL.from_config("tiny", device="cpu"), params)


@pytest.fixture(scope="module", autouse=True)
def jax_refs(stack, vae_pair):
    """The JAX entry points' results at the tiny presets, computed in the
    background from the module's start while the other tests run (two,
    then three at once; the entry points' own jax.jit calls with
    FAST_COMPILE, which is what the module's other JAX programs take too).
    A future of {name: result}."""
    jte_pipe, unet_fn, params, _, _ = stack
    jvae, vparams, _ = vae_pair
    fast_jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)

    @fast_jit
    def encoder(img, rng):  # one program: the encoder's test and img2img's vae_encode (the same input shape)
        dist = jvae.apply({"params": vparams}, img, method=jvae.encode)
        return dist.mean, dist.logvar, dist.kl(), dist.sample(rng), jax.random.normal(rng, dist.mean.shape)

    def encode(img, rng):
        return encoder(img, rng)[3]

    def img2img(masked):
        return jsampling.image_to_image_sampling(unet_fn, jte_pipe, _images(), PROMPTS, NEGS, vae_encode=encode,
                                                 train_schedule=JaxSchedule.sdxl(), unet_params=params,
                                                 internal_sampling_func=jsampling.sample_dpmpp_2m,
                                                 **_img2img_kw(masked))

    def invert(p, x):
        return jsampling.euler_latent_sampling(x, functools.partial(unet_fn, p), jte_pipe, JaxSchedule.sdxl(),
                                               PROMPTS, NEGS, **INVERT_KW)

    x0 = np.random.default_rng(10).standard_normal(LAT).astype(np.float32)
    enc_x = np.random.default_rng(5).uniform(-1, 1, _images().shape).astype(np.float32)
    jobs = {
        "encoder": lambda: (enc_x, encoder(enc_x, jax.random.PRNGKey(9))),
        "options": lambda: jsampling.diffusion_sampling(
            unet_fn, jte_pipe, None, JaxSchedule.sdxl(), PROMPTS, NEGS, sample_schedule=JaxSchedule.ddpm(**LIN),
            unet_params=params, internal_sampling_func=jsampling.sample_dpmpp_2m_sde, **OPTIONS_KW),
        "img2img": lambda: img2img(False),
        "inpaint": lambda: img2img(True),
        "invert": lambda: (x0, compile_fast(invert, params, x0)(params, x0)),
    }

    def run_all(pool):
        # two jobs first: the text encoding and the UNet's trace, and the
        # encoder's program, which the others then reuse
        first = {k: pool.submit(jobs.pop(k)) for k in ("options", "encoder")}
        refs = {k: jax.tree_util.tree_map(np.asarray, f.result()) for k, f in first.items()}
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return refs | {k: jax.tree_util.tree_map(np.asarray, f.result()) for k, f in futures.items()}

    with pytest.MonkeyPatch.context() as m, ThreadPoolExecutor(3) as pool, ThreadPoolExecutor(1) as main:
        m.setattr(jax, "jit", fast_jit)
        refs = main.submit(run_all, pool)
        yield refs
        refs.result()  # nothing left running at the module's end


def test_diffusion_sampling_options_match_jax(stack, jax_refs, monkeypatch):
    """Another sampler (DPM++ 2M SDE, per-sample noise), a second schedule
    for the ladder, guidance only in a sigma window, the per-sample rescale;
    1e-4 of the latents' largest element."""
    _, _, _, te_pipe, unet = stack
    steps, seeds = OPTIONS_KW["num_steps"], OPTIONS_KW["seed"]
    sigmas = np.asarray(JaxSchedule.ddpm(**LIN).sample_sigmas_descending(steps), np.float32)

    def draws(seed_arr):
        keys = jnoise.per_sample_keys(seed_arr)
        draw = jnoise.make_per_sample_noise_sampler(keys)
        return jnoise.per_sample_init_noise(keys, LAT[1:]), [
            draw(None, LAT, s, s_next) for s, s_next in zip(sigmas[:-1], sigmas[1:])]

    seed_arr = jnp.asarray(np.asarray(seeds, np.uint32))
    init, step_noise = compile_fast(draws, seed_arr)(seed_arr)
    init, step_noise = torch.from_numpy(np.array(init)), [torch.from_numpy(np.array(n)) for n in step_noise]
    monkeypatch.setattr(tsampling_module, "per_sample_init_noise", lambda *a, **k: init.clone())
    monkeypatch.setattr(tsampling_module, "make_per_sample_noise_sampler", lambda *a, **k: (
        lambda shape, s, s_next: step_noise[int(np.argmin(np.abs(sigmas[:-1] - s)))]))
    got = tsampling.diffusion_sampling(lambda mod, *a: mod(*a), te_pipe, None, NoiseSchedule.sdxl(), PROMPTS, NEGS,
                                       sample_schedule=NoiseSchedule.ddpm(**LIN), unet_params=unet,
                                       internal_sampling_func=tsampling.sample_dpmpp_2m_sde, **OPTIONS_KW)
    assert sigmas[2] < 5.0 < sigmas[1]  # two steps outside the window, two inside
    assert_rel(got, jax_refs.result()["options"], TINY_REL)
    np.testing.assert_allclose(got.reshape(2, -1).std(dim=1, unbiased=False).numpy() * 0.13025, 1.0, rtol=1e-5)


def test_vae_encoder_matches_jax(vae_pair, jax_refs):
    """The tiny encoder's mean and log-variance (1e-5), a draw from them
    with JAX's noise, their KL; the converter carries the encoder and
    quant_conv across."""
    _, params, vae = vae_pair
    x, (mean, logvar, kl, sample, draw) = jax_refs.result()["encoder"]
    with torch.no_grad():
        dist = vae.encode(torch.from_numpy(x))
    assert dist.mean.shape == (2, 8, 8, 4) and dist.mean.dtype == torch.float32
    for got, want in ((dist.mean, mean), (dist.logvar, logvar), (dist.kl(), kl),
                      (dist.sample(noise=torch.from_numpy(np.array(draw))), sample)):
        assert_rel(got, want, REL)
    assert torch.equal(dist.mode(), dist.mean)
    for name in ("encoder", "quant_conv"):
        state = {k: v for k, v in vae.state_dict().items() if k.startswith(name + ".")}
        assert state and all(v.abs().sum() > 0 for v in state.values())
    np.testing.assert_array_equal(vae.quant_conv.weight.permute(2, 3, 1, 0).detach().numpy(),
                                  np.asarray(params["quant_conv"]["kernel"], np.float32))


def test_vae_tiled_decode_and_encode_match_jax(vae_pair):
    """3 x 2 overlapping tiles each way (each tile normalised on its own, as
    in the JAX package), fp32, 1e-5 of the largest element; one tile is the
    untiled call itself."""
    jvae, params, vae = vae_pair
    rng = np.random.default_rng(6)
    z = rng.standard_normal((2, 16, 12, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)

    def tiled(p, z, x):
        dist = jvae.apply({"params": p}, x, tile=16, overlap=8, method=jvae.encode_tiled)
        return jvae.apply({"params": p}, z, tile=8, overlap=4, method=jvae.decode_tiled), dist.mean, dist.logvar

    dec, mean, logvar = compile_fast(tiled, params, z, x)(params, z, x)
    with torch.no_grad():
        dist = vae.encode_tiled(torch.from_numpy(x), tile=16, overlap=8)
        assert_rel(vae.decode_tiled(torch.from_numpy(z), tile=8, overlap=4), dec, REL)
        assert_rel(dist.mean, mean, REL)
        assert_rel(dist.logvar, logvar, REL)
        assert torch.equal(vae.decode_tiled(torch.from_numpy(z), tile=16), vae.decode(torch.from_numpy(z)))


@pytest.mark.parametrize("masked", [False, True], ids=["img2img", "inpaint"])
def test_image_to_image_sampling_matches_jax(stack, vae_pair, jax_refs, masked):
    """SDEdit from an encoded image at strength 0.6 of 5 steps (3 run) with
    DPM++ 2M, and inpainting with half the latent kept (and a CFG window);
    JAX's encoder draw and start noise fed to the port; 1e-4 of the
    latents' largest element, the kept half exactly the init latent."""
    _, _, _, te_pipe, unet = stack
    _, _, vae = vae_pair
    _, rng_enc, rng_noise, _ = jax.random.split(jax.random.PRNGKey(IMG_SEED), 4)
    enc_draw = torch.from_numpy(np.array(jax.random.normal(rng_enc, LAT)))
    noise = torch.from_numpy(np.array(jax.random.normal(rng_noise, LAT)))

    def port_encode(img, generator):
        return vae.encode(img).sample(noise=enc_draw)

    got = tsampling.image_to_image_sampling(lambda mod, *a: mod(*a), te_pipe, _images(), PROMPTS, NEGS,
                                            vae_encode=port_encode, train_schedule=NoiseSchedule.sdxl(),
                                            unet_params=unet, internal_sampling_func=tsampling.sample_dpmpp_2m,
                                            noise=noise, **_img2img_kw(masked))
    assert_rel(got, jax_refs.result()["inpaint" if masked else "img2img"], TINY_REL)
    if masked:
        with torch.no_grad():
            init = port_encode(torch.from_numpy(_images()), None) / IMG_STD * IMG_STD
        keep = torch.from_numpy(_mask()).expand(LAT) == 0
        assert torch.equal(got[keep], init[keep])


def test_euler_latent_inversion_matches_jax(stack, jax_refs):
    """Image -> noise with CFG++ at cfg 2 (the model conditioned on each
    step's next sigma); JAX's start noise fed to the port; 1e-4 of the
    result's largest element."""
    _, _, _, te_pipe, unet = stack
    x0, want = jax_refs.result()["invert"]
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.split(jax.random.PRNGKey(5))[1], LAT)))
    got = tsampling.euler_latent_sampling(torch.from_numpy(x0), unet, te_pipe, NoiseSchedule.sdxl(), PROMPTS, NEGS,
                                          noise=noise, **INVERT_KW)
    assert_rel(got, want, TINY_REL)
    # the ladder: up from the smallest nonzero sigma (twice: a first step of length 0, as in the JAX package)
    sig = tsampling.euler_latent.euler_latent_sigmas(NoiseSchedule.sdxl(), 4, image_to_noise=True)
    assert len(sig) == 5 and sig[0] == sig[1] < sig[2] < sig[-1]


def test_pipeline_takes_a_sampler_a_ladder_and_vae_tiling(stack, vae_pair):
    """``Txt2ImgPipeline(sampler=, vae_tiling=)``: on the request path,
    with and without a ``diffusion_sampling`` keyword (a ladder), the
    latents ``diffusion_sampling`` gives for that sampler, bitwise, and the
    images decoded in tiles."""
    from uwudiff_tpu_torch.serving import Txt2ImgPipeline
    from uwudiff_tpu_torch.utils import vae_image_postprocess

    _, _, _, te_pipe, unet = stack
    _, _, vae = vae_pair
    sampler = tsampling.sample_dpmpp_2m_sde
    ladder = functools.partial(tsampling.karras_sigmas, sigma_min=0.03, sigma_max=14.6)
    pipe = Txt2ImgPipeline(unet, te_pipe, vae, NoiseSchedule.sdxl(), device="cpu", sampler=sampler, vae_tiling=4)
    kw = dict(num_steps=3, num_samples=2, cfg_scale=3.0, width=16, height=16, seed=[1, 2])
    direct = functools.partial(tsampling.diffusion_sampling, unet, te_pipe, None, NoiseSchedule.sdxl(), PROMPTS, NEGS,
                               vae_std=pipe.vae_std, vae_downscale=2, internal_sampling_func=sampler,
                               return_latents=True, **kw)
    want = direct()
    np.testing.assert_array_equal(pipe(PROMPTS, NEGS, return_latents=True, **kw), want.numpy())
    want = direct(get_sigma_func=ladder)
    np.testing.assert_array_equal(pipe(PROMPTS, NEGS, return_latents=True, get_sigma_func=ladder, **kw), want.numpy())
    lat, is_images = pipe.sample_device(PROMPTS, NEGS, return_latents=True, get_sigma_func=ladder, **kw)
    assert not is_images and torch.equal(lat, want)
    with torch.no_grad():
        tiles = vae.decode_tiled(want, tile=4)
    images = pipe(PROMPTS, NEGS, get_sigma_func=ladder, **kw)
    assert len(images) == 2 and images[0].shape == (16, 16, 3)
    for got, img in zip(images, tiles):
        np.testing.assert_array_equal(got, vae_image_postprocess(img))
