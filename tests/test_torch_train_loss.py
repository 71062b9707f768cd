"""The port's diffusion loss, schedule methods and LR schedules against the JAX package.

The loss gets the JAX side's draws (timesteps and noise, read back from
``aux.timesteps`` and ``aux.target`` with an eps target, and the input
perturbation's fresh normal draw, re-derived from the same key); the
model is one fixed affine map of the noisy latent and the timestep on
both sides. fp32; tolerance 1e-6 relative to the largest element (the
same fp32 operations, XLA may fuse them), 1e-5 where the schedules'
alphas_cumprod enter (the port takes the product in fp64, rounded once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from uwudiff_tpu.diffusion import DiffusionLoss as JaxLoss
from uwudiff_tpu.diffusion import NoiseSchedule as JaxSchedule
from uwudiff_tpu.training.lr_schedules import warmup_cosine_schedule as jax_warmup_cosine
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule

B, H, W, C = 3, 8, 8, 4


def _close(out, ref, rel=1e-6):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=rel * max(1.0, np.abs(ref).max()), rtol=0)


def _model(lib):
    w = np.random.default_rng(5).standard_normal((C, C)).astype(np.float32) * 0.5

    def fn(xt, t):
        t = t.astype(jnp.float32) if lib is jnp else t.float()
        tt = t.reshape(-1, 1, 1, 1) / 1000.0
        return lib.tanh(xt @ (lib.asarray(w) if lib is jnp else torch.from_numpy(w))) + tt

    return fn


CASES = {
    "eps": {},
    "v_target_from_eps": dict(target_type="v_prediction"),
    "v_both_min_snr": dict(prediction_type="v_prediction", target_type="v_prediction", use_snr_weight=True),
    "sample_pred": dict(prediction_type="sample"),
    "debiased_l1": dict(use_debiased_estimation=True, loss_type="l1"),
    "huber_band": dict(loss_type="huber", min_timestep=200, max_timestep=600),
    "offset_perturbed": dict(noise_offset=0.1, input_perturbation=0.2),
    "multires": dict(multires_noise_iterations=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diffusion_loss_matches_jax_given_its_draws(case):
    kw = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    mask = (rng.random((B, H, W)) > 0.3).astype(np.float32) if case == "eps" else None
    weight = np.array([1.0, 0.5, 2.0], np.float32) if case == "sample_pred" else None
    key = jax.random.PRNGKey(7)
    jloss = JaxLoss(schedule=JaxSchedule.sd15(), **kw)
    jl, jaux = jloss(key, jnp.asarray(x), _model(jnp),
                     sample_weight=None if weight is None else jnp.asarray(weight),
                     loss_mask=None if mask is None else jnp.asarray(mask))
    # JAX's noise: with an eps target it is aux.target; otherwise re-draw it
    rng_t, rng_n = jax.random.split(key)
    noise = np.asarray(jloss.sample_noise(rng_n, jnp.asarray(x)))
    perturbation = np.asarray(jax.random.normal(jax.random.fold_in(rng_n, 2), x.shape, jnp.float32))
    if jloss.target_type == "epsilon":
        np.testing.assert_array_equal(noise, np.asarray(jaux.target))

    loss = DiffusionLoss(schedule=NoiseSchedule.sd15(), **kw)
    tl, aux = loss(torch.from_numpy(x), _model(torch), noise=torch.from_numpy(noise),
                   timesteps=torch.from_numpy(np.asarray(jaux.timesteps)).long(),
                   perturbation=torch.from_numpy(perturbation),
                   sample_weight=None if weight is None else torch.from_numpy(weight),
                   loss_mask=None if mask is None else torch.from_numpy(mask))
    for name in ("noisy_latent", "pred", "target", "losses"):
        _close(getattr(aux, name), getattr(jaux, name), rel=1e-5)
    _close(tl, jl, rel=1e-5)


def test_diffusion_loss_draws_from_its_generator():
    loss = DiffusionLoss(schedule=NoiseSchedule.sd15(), noise_offset=0.05, min_timestep=100, max_timestep=300)
    x = torch.zeros(64, 8, 8, 4)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return loss(x, lambda xt, t: xt, generator=gen)[1]

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a.timesteps, b.timesteps) and torch.equal(a.target, b.target)
    assert not torch.equal(a.target, c.target)
    assert a.timesteps.min() >= 100 and a.timesteps.max() < 300
    with pytest.raises(ValueError, match="timestep range"):
        DiffusionLoss(schedule=NoiseSchedule.sd15(), min_timestep=5, max_timestep=5)(
            x, lambda xt, t: xt, generator=torch.Generator())
    multires = DiffusionLoss(schedule=NoiseSchedule.sd15(), multires_noise_iterations=4)
    noise = multires.sample_noise(torch.zeros(4, 16, 16, 4), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(noise.reshape(4, -1).std(1, unbiased=False).numpy(), 1.0, rtol=1e-5)


def test_schedule_methods_match_jax():
    js, ts = JaxSchedule.sd15(), NoiseSchedule.sd15()
    t = np.array([0, 1, 10, 500, 999])
    _close(ts.sigma_for_timestep(torch.from_numpy(t)), js.sigma_for_timestep(jnp.asarray(t)), rel=1e-5)
    sig = np.array([0.03, 0.5, 1.0, 14.6], np.float32)
    _close(ts.snr_for_sigma(torch.from_numpy(sig)), js.snr_for_sigma(jnp.asarray(sig)))
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((5, 4, 4, 2)).astype(np.float32) for _ in range(2))
    _close(ts.velocity(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t)),
           js.velocity(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)), rel=1e-5)
    acp = ts.alphas_cumprod.double()  # at the integer timesteps, snr = acp / (1 - acp)
    np.testing.assert_allclose(ts.snr_for_sigma(ts.sigmas.double()).numpy(), (acp / (1 - acp)).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("use_warm_up", [True, False])
def test_warmup_cosine_schedule_matches_jax(use_warm_up):
    kw = dict(warm_up_period=10, T_max=100, eta_min=1e-7, use_warm_up=use_warm_up)
    jsched, tsched = jax_warmup_cosine(1e-3, **kw), warmup_cosine_schedule(1e-3, **kw)
    steps = [0, 1, 5, 10, 11, 50, 60, 110, 500]
    got = np.array([tsched(s) for s in steps], np.float32)
    want = np.array([float(jsched(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-12)
    assert all(isinstance(tsched(s), float) for s in steps)
