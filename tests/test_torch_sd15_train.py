"""The SD1.5 recipe's training step and optimizer against the JAX package, on the CPU.

The trainer: a ``tiny`` UNet (the SD1.5 layout narrowed: 1x1-conv
transformer projections, no addition embedding) with the same random
weights on both sides, trained as ``bench.py``'s ``sd15`` recipe trains
it: fp32 master parameters under bf16 compute (the JAX ``DMTrainer`` with
``param_dtype=None`` over a ``dtype=bfloat16`` module; the port's
``compute_dtype="bfloat16"`` over an fp32 module), ``adamw_fp16`` with
weight decay 0.01, global-norm clip 1.0. The port is handed the JAX
step's noise and timesteps and the JAX optimizer's per-leaf decay phases.
After one step: the loss and the grad norm within 2e-2 relative (bf16
activations through different kernels and sums); the gradient, as the
first moment holds it (``m = bf16((1 - b1) * clip(g))``), within 2^-6 over
the whole tree (L2) and each leaf's within 2^-4 of that leaf's largest JAX
value; the port's masters fp32 and its module's weights their bf16
rounding. The per-leaf bound is the reference's own bf16 noise: JAX's
bf16 step differs from its own fp32 step by up to 4.3 % of a leaf's
largest value (1.0 % over the tree), in 50 of the 208 leaves by more than
2^-6, weight kernels among them (a reduction over every position, rounded
in bf16); the port's bf16 step differs from JAX's by up to 4.3 % and 1.0 %
and from JAX's fp32 step by up to 4.1 % and 1.0 %. Updated weights are not
compared element by element: Adam's first step is about ``lr * sign(g)``,
which bf16 noise flips where g is near 0.

The optimizer: the plain ``AdamWFP16`` against ``adamw_fp16_state`` on
four leaves whose accumulated decay fires at some steps, given the same
fp32 gradients and JAX's phases, for three steps: both moments within one
step of their dtype (bf16, and the fp16 that ``moment_dtype`` may name),
the parameters within 1e-6 relative.
"""

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
from uwudiff_tpu.training.optimizers import adamw_fp16_state as jax_adamw_fp16
from uwudiff_tpu.training.trainer import TrainState
from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models import UNet2DConditionModel
from uwudiff_tpu_torch.training import DMTrainer
from uwudiff_tpu_torch.training.optimizers import AdamWFP16

OPT = {"weight_decay": 0.01, "betas": (0.9, 0.999)}
# a moment dtype's step relative to the value, at most
STEP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def _port_name(path) -> str:
    """A flax path -> the port's parameter name (kernel / scale -> weight)."""
    *mods, leaf = [k.key for k in path]
    return ".".join(mods + ["weight" if leaf in ("kernel", "scale", "embedding") else leaf])


def _by_port_name(tree) -> dict:
    return {_port_name(path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _flat(tree) -> dict:
    """A flax tree -> {"a/b/kernel": fp32 array}."""
    return {"/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_sd15_recipe_step_matches_jax():
    rng = np.random.default_rng(0)
    b, hw = 2, 16
    batch = {"sample": rng.standard_normal((b, hw, hw, 4)).astype(np.float32),
             "ctx": rng.standard_normal((b, 3, 32)).astype(np.float32), "tokenizer_outputs": []}
    jmodel = JaxUNet.from_config("tiny", dtype=jnp.bfloat16)
    kw = dict(lr=1e-4, optimizer="adamw_fp16", opt_config=OPT, use_warm_up=False, grad_clip=1.0, seed=0)
    jtr = JaxTrainer(model_config={"unet": jmodel, "te": None, "vae": None}, param_dtype=None,
                     loss_config=JaxLoss(schedule=JaxSchedule.sd15()), **kw)
    params = random_params(jmodel, batch["sample"][:1], np.zeros((1,), np.float32), batch["ctx"][:1], None, None,
                           like=UNet2DConditionModel.from_config("tiny", device="cpu"))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)  # fp32: param_dtype=None
    # what DMTrainer.setup builds for a te/vae-free trainer, on one device
    jtr.mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtr._batch_sh = batch_sharding(jtr.mesh)
    jtr.frozen = {}
    # the optimizer's init over the tree's scalars (its per-leaf phases depend
    # on the leaf order alone), with moments of the leaves' shapes: the same
    # state as tx.init(jparams), without compiling a zeros per leaf shape
    clip_state, fp16 = jtr.tx.init(jax.tree_util.tree_map(lambda p: np.zeros((), np.float32), params))
    zeros = jax.tree_util.tree_map(lambda p: np.zeros(p.shape, jnp.bfloat16), params)
    opt_state = (clip_state, fp16._replace(exp_avg=zeros, exp_avg_sq=zeros))
    jtr.state = jax.device_put(TrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=opt_state,
                                          ema_loss=jnp.zeros((), jnp.float32)), jax.devices()[0])
    jtr._train_step = compile_fast(jtr._train_step_impl, jtr.state, jtr.frozen, jtr._put_batch(batch),
                                   jax.random.PRNGKey(0), donate_argnums=0)
    jtr._built = True
    phases = _by_port_name(jtr.state.opt_state[1].accumulated_decay)

    unet = load_jax_params(UNet2DConditionModel.from_config("tiny", device="cpu"), params)
    tr = DMTrainer({"unet": unet, "te": None, "vae": None}, compute_dtype="bfloat16",
                   loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), device="cpu", **kw)
    tr.setup()
    tr.opt_state = tr.tx.init(tr.masters, phases=[phases[n] for n, _ in tr.params])

    jm, jaux = jtr.train_step(batch)
    m, _ = tr.train_step(batch, noise=np.asarray(jaux.target), timesteps=np.asarray(jaux.timesteps))
    for key in ("train/loss", "train/grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-2, err_msg=key)
    assert float(m["train/grad_norm"]) > 1.0  # the clip acted on both sides
    j_m = _flat(jtr.state.opt_state[1].exp_avg)
    t_m = _flat(to_jax_params(tr.unet, {n: st["exp_avg"] for (n, _), st in zip(tr.params, tr.opt_state.leaves)}))
    assert set(j_m) == set(t_m)
    for name, want in j_m.items():
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(t_m[name], want, rtol=0, atol=2.0**-4 * np.abs(want).max(), err_msg=name)
    flat_t, flat_j = (np.concatenate([m[n].ravel() for n in sorted(j_m)]) for m in (t_m, j_m))
    assert np.linalg.norm(flat_t - flat_j) <= 2.0**-6 * np.linalg.norm(flat_j)
    masters = tr.master_weights()
    for name, p in tr.params:
        assert masters[name].dtype == torch.float32 and p.dtype == torch.bfloat16
        assert torch.equal(p.detach(), masters[name].to(torch.bfloat16)), name
    assert tr.opt_state.count == int(jtr.state.step) == 1


@pytest.mark.parametrize("moment_dtype", [torch.bfloat16, torch.float16])
def test_plain_adamw_fp16_matches_optax(moment_dtype):
    rng = np.random.default_rng(3)
    shapes = [(6, 5), (7,), (3, 2, 4), (4, 4)]
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.3 for k, v in params.items()} for _ in range(3)]
    # lr * wd = 1e-4 a step against a threshold of 1.5e-4: a leaf whose
    # phase is above 5e-5 fires at the first step
    lr, wd, thr = 1e-3, 0.1, 1.5e-4
    jtx = jax_adamw_fp16(lr, weight_decay=wd, decay_threshold=thr,
                         moment_dtype=jnp.bfloat16 if moment_dtype == torch.bfloat16 else jnp.float16)
    jstate = jtx.init(params)
    keys = sorted(params)  # the tree's leaf order
    phases = [float(jstate.accumulated_decay[k]) for k in keys]
    tx = AdamWFP16(lr, weight_decay=wd, decay_threshold=thr, moment_dtype=moment_dtype)
    tparams = [torch.from_numpy(params[k].copy()) for k in keys]
    state = tx.init(tparams, phases=phases)
    jparams = params
    update = jax.jit(jtx.update)
    fired = 0
    for g in grads:
        fired += sum(p + np.float32(wd) * np.float32(lr) > thr for p in state.decay)
        jupd, jstate = update(g, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupd)
        tx.step_(tparams, [torch.from_numpy(g[k]) for k in keys], state)
        for i, k in enumerate(keys):
            for mine, theirs in ((state.leaves[i]["exp_avg"], jstate.exp_avg[k]),
                                 (state.leaves[i]["exp_avg_sq"], jstate.exp_avg_sq[k])):
                a, b_ = mine.float().numpy(), np.asarray(theirs, np.float32)
                assert mine.dtype == moment_dtype
                np.testing.assert_array_less(np.abs(a - b_), STEP[moment_dtype] * np.abs(b_) + 1e-30, err_msg=k)
            np.testing.assert_allclose(tparams[i].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=0, err_msg=k)
            np.testing.assert_allclose(state.decay[i], float(jstate.accumulated_decay[k]), rtol=1e-6, atol=1e-9)
    assert fired > 0
    assert state.count == int(jstate.step) == 3
