"""The port's SDXL-style training step against the JAX package's DMTrainer, on the CPU.

A ``tiny_sdxl`` UNet with the same random weights on both sides (numpy
draws loaded through ``convert.load_jax_params``), ``adamw_factored``
(update-RMS clip 1.0, weight decay 0.01, factored down to 16-wide leaves
so that the tiny model's leaves take the factored path), global-norm
clipping 1.0, the JAX side's timesteps and noise handed to the port. The
JAX trainer runs on one CPU device; its state is built from the same
param tree that ``DMTrainer.setup`` would initialise (setup's eager init
alone takes over half a minute on the CPU).

Both trainers keep a weight EMA (``ema_weights_decay``).

fp32 parameters (the momentum in bf16, as in the bench's recipe): three
steps; loss, grad norm, lr and EMA loss within 1e-5 relative (fp32 sums
in another order); every leaf's parameter change within one bf16 step of
its largest element (2^-8: the bf16 momentum state can round a 1e-7
difference to a whole bf16 step) plus two fp32 steps of the leaf's
largest value (the rounding of ``p + u`` where ``|p| ~ 1``), and the
median leaf's within 1e-4; the EMA weights' change the same.

bf16 parameters: one port step with the stochastic-rounding bits of the
JAX step (the JAX trainer's keys, mapped to the port's names and
layouts), and the JAX package's ``stochastic_round_add`` applied to the
port's own updates with those keys: the parameters agree bitwise; so do
the EMA weights, against ``stochastic_round_add`` of the JAX step's EMA
update fed its ``0x5858`` keys. (The
JAX bf16 step itself takes over a minute to compile on the CPU; the
bf16 optimizer is held against optax in ``test_torch_train_optim.py``
and the bf16 forward and backward against fp32 on the card by
``chip_smoke.py``.)
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import random_params
from uwudiff_tpu.diffusion import DiffusionLoss as JaxLoss
from uwudiff_tpu.diffusion import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu.parallel import batch_sharding, make_mesh
from uwudiff_tpu.training import DMTrainer as JaxTrainer
from uwudiff_tpu.training.optimizers import stochastic_round_add as jax_stochastic_round_add
from uwudiff_tpu.training.trainer import TrainState
from uwudiff_tpu_torch.convert import _jax_state_dict, load_jax_params, to_jax_params
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models import UNet2DConditionModel
from uwudiff_tpu_torch.training import DMTrainer

EMA_DECAY = 0.999
OPT = {"weight_decay": 0.01, "betas": (0.9, 0.999), "clipping_threshold": 1.0,
       "min_dim_size_to_factor": 16}


def _batch(b=2, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "sample": rng.standard_normal((b, hw, hw, 4)).astype(np.float32),
        "ctx": rng.standard_normal((b, 7, 32)).astype(np.float32),
        "pooled": rng.standard_normal((b, 16)).astype(np.float32),
        "added_cond": {"time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (b, 1))},
        "tokenizer_outputs": [],
    }


def _pair(param_dtype):
    """(JAX trainer, port trainer, initial flax params) with equal weights."""
    batch = _batch()
    compute = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    jmodel = JaxUNet.from_config("tiny_sdxl", dtype=compute)
    kw = dict(lr=1e-3, optimizer="adamw_factored", use_warm_up=False, grad_clip=1.0,
              param_dtype=param_dtype, seed=0, ema_weights_decay=EMA_DECAY)
    jtr = JaxTrainer(model_config={"unet": jmodel, "te": None, "vae": None},
                     opt_config=OPT,
                     loss_config=JaxLoss(schedule=JaxSchedule.sd15()), **kw)
    x, t = batch["sample"][:1], np.zeros((1,), np.float32)
    added = {"time_ids": batch["added_cond"]["time_ids"][:1], "text_embeds": batch["pooled"][:1]}
    params = random_params(jmodel, x, t, batch["ctx"][:1], None, added)
    jparams = jax.tree_util.tree_map(lambda p: jnp.asarray(p, compute), params)
    # what DMTrainer.setup builds for a te/vae-free trainer, on one device
    jtr.mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtr._batch_sh = batch_sharding(jtr.mesh)
    jtr.frozen = {}
    jtr.state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=jax.jit(jtr.tx.init)(jparams), ema_loss=jnp.zeros((), jnp.float32),
                           ema_params=jax.tree_util.tree_map(lambda p: jnp.array(p, copy=True), jparams))
    jtr.state = jax.device_put(jtr.state, jax.devices()[0])  # committed, as the step returns it
    jtr._train_step = jax.jit(jtr._train_step_impl, donate_argnums=0)
    jtr._built = True

    unet = load_jax_params(UNet2DConditionModel.from_config("tiny_sdxl", device="cpu"), params)
    tr = DMTrainer({"unet": unet, "te": None, "vae": None},
                   opt_config=OPT,
                   loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), device="cpu", **kw)
    return jtr, tr, batch


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def test_train_steps_match_jax_fp32():
    jtr, tr, batch = _pair(None)
    p0 = dict(_flat(to_jax_params(tr.unet)))
    for _ in range(3):
        jm, jaux = jtr.train_step(batch)
        m, aux = tr.train_step(batch, noise=np.asarray(jaux.target), timesteps=np.asarray(jaux.timesteps))
        for key in ("train/loss", "train/grad_norm", "train/ema_loss", "train/lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(aux.pred.detach().numpy(), np.asarray(jaux.pred),
                                   atol=1e-4 * np.abs(np.asarray(jaux.pred)).max())
    assert int(jtr.state.step) == tr.step == tr.opt_state.count == 3
    for jtree, port in ((jtr.state.params, None), (jtr.state.ema_params, tr.ema_weights())):
        jp = dict(_flat(jax.device_get(jtree)))
        tp = dict(_flat(to_jax_params(tr.unet, port)))
        assert set(jp) == set(tp)
        rel = []
        for name in jp:
            jd, td = jp[name] - p0[name], tp[name] - p0[name]
            assert np.abs(jd).max() > 0, name
            tol = 2.0**-8 * np.abs(jd).max() + 2.0**-22 * np.abs(jp[name]).max()
            np.testing.assert_allclose(td, jd, atol=tol, rtol=0, err_msg=name)
            rel.append(np.abs(td - jd).max() / np.abs(jd).max())
        assert np.median(rel) <= 1e-4, np.median(rel)


def test_bf16_step_with_jax_stochastic_rounding_bits():
    jtr, tr, batch = _pair("bfloat16")
    tr.grad_clip = None  # the updates below are the optimizer's on the raw gradients
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jtr.state.params)
    # the JAX step's keys: rng folded with the step, then 0x5757, one per leaf
    # in flattening order; bits for the first leaf of each kind (Dense and
    # Conv kernels, biases, norm scales) and every 20th (each leaf shape
    # costs a compile)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    keys = jax.random.split(jax.random.fold_in(rng, 0x5757), len(leaves))
    ema_keys = jax.random.split(jax.random.fold_in(rng, 0x5858), len(leaves))  # the weight EMA's
    picked, seen = {}, set()
    for i, (path, p) in enumerate(leaves):
        kind = (path[-1].key, p.ndim, p.shape[:2] if p.ndim == 4 else ())
        if kind in seen and i % 20:
            continue
        seen.add(kind)
        drawn = []
        for key in (keys[i], ema_keys[i]):
            tree = np.asarray(jax.random.bits(key, p.shape, jnp.uint32) & 0xFFFF).astype(np.int64)
            for k in reversed(path):
                tree = {k.key: tree}
            (name, port_bits), = _jax_state_dict(tree).items()
            drawn.append(torch.from_numpy(np.ascontiguousarray(port_bits)))
        picked[name] = ("/".join(k.key for k in path), keys[i], drawn[0], ema_keys[i], drawn[1])
    assert {(k[0], k[1]) for k in seen} >= {("kernel", 2), ("kernel", 4), ("bias", 1), ("scale", 1)}

    rng = np.random.default_rng(1)
    noise = rng.standard_normal(batch["sample"].shape).astype(np.float32)
    tr.forward_backward(batch, noise=noise, timesteps=np.array([10, 700]))
    params = [p for _, p in tr.params]
    grads = [p.grad for p in params]
    assert all(g is not None and g.dtype == torch.bfloat16 for g in grads)
    p0 = {n: p.detach().clone() for n, p in tr.params}
    updates, _ = tr.tx.update(grads, copy.deepcopy(tr.opt_state), params)
    assert set(picked) <= {n for n, _ in tr.params}
    # the trainer's update and weight EMA, with JAX's bits
    tr.apply_updates({n: v[2] for n, v in picked.items()}, {n: v[4] for n, v in picked.items()})

    u_flat = dict(_flat(to_jax_params(tr.unet, dict(zip((n for n, _ in tr.params), updates)))))
    p_flat = dict(_flat(to_jax_params(tr.unet, p0)))
    got = dict(_flat(to_jax_params(tr.unet)))
    got_ema = dict(_flat(to_jax_params(tr.unet, tr.ema_weights())))
    keep = np.float32(1.0) - np.float32(min(1.0 / 10.0, EMA_DECAY))  # the JAX step's 1 - d_w at step 0
    for flax_name, key, _, ema_key, _ in picked.values():
        want = jax_stochastic_round_add(jnp.asarray(p_flat[flax_name], jnp.bfloat16), u_flat[flax_name], key)
        np.testing.assert_array_equal(got[flax_name], np.asarray(want, np.float32), err_msg=flax_name)
        assert (got[flax_name] != p_flat[flax_name]).any(), flax_name
        # the EMA starts at the parameters: e + (1 - d_w) * (p_new - e), rounded with the 0x5858 keys
        want_ema = jax_stochastic_round_add(jnp.asarray(p_flat[flax_name], jnp.bfloat16),
                                            keep * (got[flax_name] - p_flat[flax_name]), ema_key)
        np.testing.assert_array_equal(got_ema[flax_name], np.asarray(want_ema, np.float32), err_msg=flax_name)
        assert (got_ema[flax_name] != p_flat[flax_name]).any(), flax_name
    assert all(p.dtype == torch.bfloat16 for p in tr.unet.parameters())


def test_to_jax_params_inverts_load_jax_params():
    jmodel = JaxUNet.from_config("tiny_sdxl")
    b = _batch()
    added = {"time_ids": b["added_cond"]["time_ids"], "text_embeds": b["pooled"]}
    params = random_params(jmodel, b["sample"], np.zeros(2, np.float32), b["ctx"], None, added)
    unet = load_jax_params(UNet2DConditionModel.from_config("tiny_sdxl", device="cpu"), params)
    back = dict(_flat(to_jax_params(unet)))
    src = dict(_flat(params))
    assert set(back) == set(src)
    for name in src:
        np.testing.assert_array_equal(back[name], src[name], err_msg=name)


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    unet = UNet2DConditionModel.from_config("tiny_sdxl", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DMTrainer({"unet": unet})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DMTrainer({"unet": unet, "vae": object()}, device="cpu")
    assert DMTrainer({"unet": unet}, device="cpu").device.type == "cpu"
