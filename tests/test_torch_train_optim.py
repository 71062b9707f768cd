"""The port's optimizers and stochastic rounding against the JAX package's (optax).

Leaves in the flax layout on the JAX side and in PyTorch's layout on the
port's (``Linear [out, in]``, ``Conv2d [out, in, kh, kw]``): a square and
a non-square Dense kernel and a 3x3 conv kernel take the factored second
moment (two dims >= 128; PyTorch's layout may pick the other axis as the
"row", which the factored estimate does not see), a Dense kernel with a
dim below 128 and a bias take the dense one. Three steps of the same
random gradients under the same LR schedule.

fp32 parameters: updates within 1e-5 of the largest element for 99.9 %
of the elements and within one bf16 step of the momentum (2^-8
relative) for all (the bf16 momentum state can round a 1e-7 difference
to a whole bf16 step); the momentum state within one bf16 step; the
second-moment estimate within 1e-5 relative; the step counts equal. bf16
parameters (statistics in bf16, as optax keeps them in the param dtype):
the dtypes of optax's state and update, and the update within four bf16
steps of its largest element (each stage rounds to bf16, in another
order than XLA's fused program, over three steps). ``stochastic_round_add`` is bitwise the JAX package's given the
same bits.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from uwudiff_tpu.training.lr_schedules import warmup_cosine_schedule as jax_schedule
from uwudiff_tpu.training.optimizers import adamw_factored as jax_adamw_factored
from uwudiff_tpu.training.optimizers import stochastic_round_add as jax_sr
from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule
from uwudiff_tpu_torch.training.optimizers import (
    AdamWFP16,
    adamw,
    adamw_factored,
    build_optimizer,
    stochastic_round_add,
)

LEAVES = {  # name: (flax shape, axes taking the flax layout to PyTorch's)
    "square": ((256, 256), (1, 0)),
    "wide": ((128, 384), (1, 0)),
    "conv": ((3, 3, 160, 192), (3, 2, 0, 1)),
    "small": ((64, 100), (1, 0)),
    "bias": ((320,), (0,)),
}


def _to_torch(tree, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(tree[n], np.float32).transpose(ax))).to(dtype)
            for n, (_, ax) in LEAVES.items()]


def _to_flax(tensors):
    return {n: t.float().numpy().transpose(np.argsort(ax)) for (n, (_, ax)), t in zip(LEAVES.items(), tensors)}


def _data(dtype, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    params = {n: (0.1 * rng.standard_normal(s)).astype(np.float32) for n, (s, _) in LEAVES.items()}
    grads = [{n: (rng.standard_normal(s) * rng.uniform(0.01, 1.0)).astype(np.float32)
              for n, (s, _) in LEAVES.items()} for _ in range(steps)]
    cast = (lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t))
    return cast(params), [cast(g) for g in grads]


def _estimate(fs, name):
    """The factored second moment of one leaf of optax's state, in the flax layout."""
    vr, vc = np.asarray(fs.v_row[name], np.float32), np.asarray(fs.v_col[name], np.float32)
    if vr.size == 1:
        return np.asarray(fs.v[name], np.float32)
    shape = LEAVES[name][0]
    d1, d0 = np.argsort(shape)[-2:]
    return (np.expand_dims(vr, d0) * np.expand_dims(vc, d1)
            / np.expand_dims(vr.mean(axis=d1 - 1 if d1 > d0 else d1, keepdims=True), d0))


def _port_estimate(st, shape):
    if "v" in st:
        return st["v"].float()
    d1, d0 = (int(i) for i in np.argsort(shape)[-2:])
    vr, vc = st["v_row"].float(), st["v_col"].float()
    rd1 = d1 - 1 if d1 > d0 else d1
    return vr.unsqueeze(d0) * vc.unsqueeze(d1) / vr.mean(dim=rd1, keepdim=True).unsqueeze(d0)


def _run(dtype):
    jparams, jgrads = _data(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jtx = jax_adamw_factored(jax_schedule(1e-3, T_max=10, use_warm_up=False), weight_decay=0.01,
                             clipping_threshold=1.0)
    tx = adamw_factored(warmup_cosine_schedule(1e-3, T_max=10, use_warm_up=False), weight_decay=0.01,
                        clipping_threshold=1.0)
    jstate = jtx.init(jparams)
    params = _to_torch(jparams, dtype)
    state = tx.init(params)
    steps = []
    for g in jgrads:
        jupd, jstate = jax.jit(jtx.update)(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        upd, state = tx.update(_to_torch(g, dtype), state, params)
        params = [(p + u).to(p.dtype) for p, u in zip(params, upd)]
        steps.append((jupd, upd, jstate, copy.deepcopy(state)))
    return steps


def test_adamw_factored_matches_optax_fp32():
    steps = _run(torch.float32)
    for jupd, upd, jstate, state in steps:
        for (name, (shape, ax)), u, st in zip(LEAVES.items(), upd, state.leaves):
            want = np.asarray(jupd[name])
            got = u.numpy().transpose(np.argsort(ax))
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 2.0**-8 * scale, name
            assert (np.abs(got - want) <= 1e-5 * scale).mean() >= 0.999, name
            mu = np.asarray(jstate[0][3].ema[name], np.float32)
            np.testing.assert_allclose(st["mu"].float().numpy().transpose(np.argsort(ax)), mu,
                                       atol=2.0**-8 * np.abs(mu).max(), rtol=0, err_msg=name)
            assert st["mu"].dtype == torch.bfloat16
            est = _estimate(jstate[0][0], name)
            np.testing.assert_allclose(_port_estimate(st, tuple(u.shape)).numpy().transpose(np.argsort(ax)), est,
                                       rtol=1e-5, err_msg=name)
            assert ("v" in st) == (name in ("small", "bias")), name
        assert int(jstate[0][0].count) == int(jstate[1].count) == state.count


def test_adamw_factored_bf16_keeps_optax_dtypes():
    steps = _run(torch.bfloat16)
    for jupd, upd, jstate, state in steps:
        for (name, (_, ax)), u, st in zip(LEAVES.items(), upd, state.leaves):
            want = np.asarray(jupd[name], np.float32)
            assert u.dtype == torch.float32 and jupd[name].dtype == jnp.float32, name  # the decay promotes
            assert st["mu"].dtype == torch.bfloat16 == getattr(torch, str(jstate[0][3].ema[name].dtype))
            stat = st["v"] if "v" in st else st["v_row"]
            assert stat.dtype == torch.bfloat16 and jstate[0][0].v_row[name].dtype == jnp.bfloat16
            got = u.numpy().transpose(np.argsort(ax))
            assert np.abs(got - want).max() <= 2.0**-6 * np.abs(want).max(), name


def test_adamw_matches_optax():
    jparams, jgrads = _data(jnp.float32, seed=1)
    jtx = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    tx = adamw(1e-3, weight_decay=0.01)
    jstate, params = jtx.init(jparams), _to_torch(jparams)
    state = tx.init(params)
    for g in jgrads:
        jupd, jstate = jtx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        upd, state = tx.update(_to_torch(g), state, params)
        params = [p + u for p, u in zip(params, upd)]
        for name, got in _to_flax(upd).items():
            want = np.asarray(jupd[name])
            np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0, err_msg=name)
    assert state.count == 3


def test_build_optimizer_names():
    assert isinstance(build_optimizer("torch.optim.AdamW"), type(adamw(1e-3)))
    assert isinstance(build_optimizer("adamw_factored", clipping_threshold=1.0), type(adamw_factored(1e-3)))
    tx = build_optimizer("duwu.trainer.optimizers.AdamWFP16", moment_dtype=torch.float16, decay_threshold=0.5)
    assert isinstance(tx, AdamWFP16) and tx.moment_dtype == torch.float16 and tx.decay_threshold == 0.5
    assert isinstance(build_optimizer("adamw_fp16"), AdamWFP16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer("lion_pytorch.Lion")
    with pytest.raises(ValueError):
        build_optimizer("no_such_optimizer")


def test_stochastic_round_add_is_bitwise_jax():
    rng = np.random.default_rng(3)
    base = np.concatenate([
        rng.standard_normal(2000) * 0.1,
        -np.abs(rng.standard_normal(500)),  # negative values
        np.zeros(100),  # zeros
        np.full(200, 1.9921875), np.full(200, -3.984375),  # one bf16 step below a power of two: carries
        np.full(100, 1e-38),  # subnormal range of the sum
    ]).astype(np.float32)
    param = jnp.asarray(base, jnp.bfloat16)
    update = (rng.standard_normal(base.shape) * np.where(np.arange(base.size) % 3, 1e-2, 1e-5)).astype(np.float32)
    update[2600:3000] = np.abs(update[2600:3000]) * np.sign(base[2600:3000])  # push towards the carry
    key = jax.random.PRNGKey(11)
    want = jax_sr(param, jnp.asarray(update), key)
    bits = np.asarray(jax.random.bits(key, base.shape, jnp.uint32) & 0xFFFF).astype(np.int64)
    got = stochastic_round_add(torch.from_numpy(np.asarray(param, np.float32)).bfloat16(),
                               torch.from_numpy(update), torch.from_numpy(bits))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    # the carries really crossed a power of two
    assert (np.abs(np.asarray(want, np.float32)[2600:3000]) > np.abs(base[2600:3000])).any()
