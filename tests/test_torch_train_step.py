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
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import compile_fast, random_params
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


@functools.lru_cache(maxsize=None)
def _tiny_sdxl_params():
    """The tiny_sdxl param tree, drawn once for the module (its shapes are
    the model's whatever the compute dtype and batch; the draws follow from
    the shapes and the seed alone)."""
    batch = _batch()
    x, t = batch["sample"][:1], np.zeros((1,), np.float32)
    added = {"time_ids": batch["added_cond"]["time_ids"][:1], "text_embeds": batch["pooled"][:1]}
    return random_params(JaxUNet.from_config("tiny_sdxl"), x, t, batch["ctx"][:1], None, added,
                         like=UNet2DConditionModel.from_config("tiny_sdxl", device="cpu"))


def _params():
    return jax.tree_util.tree_map(np.copy, _tiny_sdxl_params())  # a copy per test: nothing shares its arrays


def _jax_trainer(param_dtype):
    """The JAX trainer over the module's params, and the batch."""
    batch = _batch()
    compute = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    jmodel = JaxUNet.from_config("tiny_sdxl", dtype=compute)
    jtr = JaxTrainer(model_config={"unet": jmodel, "te": None, "vae": None},
                     opt_config=OPT,
                     loss_config=JaxLoss(schedule=JaxSchedule.sd15()), **_trainer_kw(param_dtype))
    jparams = jax.tree_util.tree_map(lambda p: jnp.asarray(p, compute), _params())
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
    return jtr, batch


def _trainer_kw(param_dtype):
    return dict(lr=1e-3, optimizer="adamw_factored", use_warm_up=False, grad_clip=1.0,
                param_dtype=param_dtype, seed=0, ema_weights_decay=EMA_DECAY)


def _port_trainer(param_dtype):
    unet = load_jax_params(UNet2DConditionModel.from_config("tiny_sdxl", device="cpu"), _params())
    return DMTrainer({"unet": unet, "te": None, "vae": None},
                     opt_config=OPT,
                     loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), device="cpu",
                     **_trainer_kw(param_dtype))


def _pair(param_dtype):
    """(JAX trainer, port trainer, batch) with equal weights."""
    jtr, batch = _jax_trainer(param_dtype)
    return jtr, _port_trainer(param_dtype), batch


def _jax_fp32_steps():
    """The JAX side of the fp32 test: three steps of the trainer, its step
    compiled with the suite's cheap LLVM settings (as the SD1.5 step's test
    does: fp32 sums in another order, inside the tolerances); each step's
    metrics and aux, the final params and EMA weights, on the host."""
    jtr, batch = _jax_trainer(None)
    jtr._train_step = compile_fast(jtr._train_step_impl, jtr.state, jtr.frozen, jtr._put_batch(batch),
                                   jax.random.PRNGKey(jtr.seed), donate_argnums=0)
    steps = [jax.device_get(jtr.train_step(batch)) for _ in range(3)]
    return steps, jax.device_get((jtr.state.params, jtr.state.ema_params)), int(jtr.state.step)


@pytest.fixture(autouse=True, scope="module")
def jax_fp32_steps():
    """The fp32 test's JAX side, traced, compiled and run in a thread of its
    own from the module's start (XLA's compile releases the interpreter
    lock): the module's other tests run beside it, the fp32 test last."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_fp32_steps)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def test_bf16_step_with_jax_stochastic_rounding_bits():
    jtr, tr, batch = _pair("bfloat16")
    tr.grad_clip = None  # the updates below are the optimizer's on the raw gradients
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jtr.state.params)
    # the JAX step's keys: rng folded with the step, then 0x5757, one per leaf
    # in flattening order; bits for the first leaf of each kind (Dense and
    # Conv kernels, biases, norm scales) and every 20th, all drawn by one
    # program (each leaf shape costs its own compile eagerly)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    keys = jax.random.split(jax.random.fold_in(rng, 0x5757), len(leaves))
    ema_keys = jax.random.split(jax.random.fold_in(rng, 0x5858), len(leaves))  # the weight EMA's
    chosen, seen = [], set()
    for i, (path, p) in enumerate(leaves):
        kind = (path[-1].key, p.ndim, p.shape[:2] if p.ndim == 4 else ())
        if kind in seen and i % 20:
            continue
        seen.add(kind)
        chosen.append((i, path, p.shape))

    def draw_bits(ks, eks):
        return [[jax.random.bits(k[j], shape, jnp.uint32) & 0xFFFF for k in (ks, eks)] for j, (_, _, shape)
                in enumerate(chosen)]

    idx = np.asarray([i for i, _, _ in chosen])
    all_bits = compile_fast(draw_bits, keys[idx], ema_keys[idx])(keys[idx], ema_keys[idx])
    picked = {}
    for (i, path, _), bits in zip(chosen, all_bits):
        drawn = []
        for b in bits:
            tree = np.asarray(b).astype(np.int64)
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
    # JAX's rounding of every picked leaf's update, and of its EMA's (the EMA
    # starts at the parameters: e + (1 - d_w) * (p_new - e), rounded with the
    # 0x5858 keys), in one program
    names = [v[0] for v in picked.values()]
    args = ([jnp.asarray(p_flat[n], jnp.bfloat16) for n in names], [u_flat[n] for n in names],
            [keep * (got[n] - p_flat[n]) for n in names], [v[1] for v in picked.values()],
            [v[3] for v in picked.values()])

    def round_all(ps, us, es, ks, eks):
        return [(jax_stochastic_round_add(p, u, k), jax_stochastic_round_add(p, e, ek))
                for p, u, e, k, ek in zip(ps, us, es, ks, eks)]

    for flax_name, (want, want_ema) in zip(names, compile_fast(round_all, *args)(*args)):
        np.testing.assert_array_equal(got[flax_name], np.asarray(want, np.float32), err_msg=flax_name)
        assert (got[flax_name] != p_flat[flax_name]).any(), flax_name
        np.testing.assert_array_equal(got_ema[flax_name], np.asarray(want_ema, np.float32), err_msg=flax_name)
        assert (got_ema[flax_name] != p_flat[flax_name]).any(), flax_name
    assert all(p.dtype == torch.bfloat16 for p in tr.unet.parameters())


def test_to_jax_params_inverts_load_jax_params():
    params = _params()
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


def test_train_steps_match_jax_fp32(jax_fp32_steps):
    tr, batch = _port_trainer(None), _batch()
    p0 = dict(_flat(to_jax_params(tr.unet)))
    steps, (jparams, jema), jstep = jax_fp32_steps.result()
    for jm, jaux in steps:
        m, aux = tr.train_step(batch, noise=np.asarray(jaux.target), timesteps=np.asarray(jaux.timesteps))
        for key in ("train/loss", "train/grad_norm", "train/ema_loss", "train/lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(aux.pred.detach().numpy(), np.asarray(jaux.pred),
                                   atol=1e-4 * np.abs(np.asarray(jaux.pred)).max())
    assert jstep == tr.step == tr.opt_state.count == 3
    for jtree, port in ((jparams, None), (jema, tr.ema_weights())):
        jp = dict(_flat(jtree))
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
