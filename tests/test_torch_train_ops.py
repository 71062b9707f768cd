"""Gradients of the port's kernel modules against the JAX package, on the CPU.

The port's autograd functions run their plain versions here (K1's and
the backward pair's for flash attention, the GroupNorm forward pair's and
K7/K8's for GroupNorm+SiLU); the JAX side is ``jax.grad`` through the
Pallas kernels in interpret mode, as the JAX package's own tests run
them, and through flax ``nn.GroupNorm`` for the plain GroupNorm. Inputs
are numpy draws from a seed, fp32. Tolerance: 1e-4 of the largest
gradient element (fp32 sums in another order; the JAX kernels work in
the exp2 domain with LOG2E folded into q).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from uwudiff_tpu.ops.flash_attention import flash_attention as jax_flash
from uwudiff_tpu.ops.groupnorm_silu import _gn_silu
from uwudiff_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_reference,
)
from uwudiff_tpu_torch.ops.groupnorm_silu import (
    GroupNormSiLUFunction,
    gn_bwd_dx_reference,
    gn_bwd_partials_reference,
    group_norm_silu,
    group_norm_silu_reference,
)

REL = 1e-4


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


def _bias(kind, b, h, sq, sk, rng):
    neg = np.finfo(np.float32).min
    if kind == "none":
        return None
    if kind == "key":  # ragged padding mask: a different kept length per row
        keep = np.arange(sk)[None, :] < np.array([sk // 3, sk])[:b, None]
        return np.where(keep, 0.0, neg).astype(np.float32)[:, None, None, :]
    return rng.standard_normal((b, h, sq, sk)).astype(np.float32)  # a constant full bias


@pytest.mark.parametrize(
    "b,sq,sk,h,d,kind",
    [
        (1, 128, 128, 2, 64, "none"),
        (2, 128, 77, 2, 64, "key"),  # cross-attention's 77 keys, ragged mask
        (1, 128, 128, 2, 64, "full"),
        (2, 128, 77, 2, 40, "key"),
        (1, 128, 128, 2, 40, "full"),
        (1, 200, 77, 2, 64, "none"),  # ragged Sq
        (1, 128, 128, 2, 160, "none"),  # SD1.5's level-2 head dim
        (2, 128, 77, 2, 160, "key"),
    ],
)
def test_flash_grads_match_jax_kernel(b, sq, sk, h, d, kind):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, sk, sk))
    dout = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    bias = _bias(kind, b, h, sq, sk, rng)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, bias=None if bias is None else jnp.asarray(bias),
                        interpret=True, block_q=128, block_k=128)
        return jnp.sum(out * dout)

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, None if bias is None else torch.from_numpy(bias))
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, tg, jg in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert tg.shape == (b, sq if name == "dq" else sk, h, d), name
        _close(tg, jg)


@pytest.mark.parametrize("kind", ["none", "key"])
def test_flash_lse_grads_match_jax_kernel(kind):
    """A loss that reads both ``out`` and the lse of
    ``flash_attention(..., return_lse=True)``: the lse's cotangent folds
    into the backward's delta (``delta - dlse``), as JAX's ``_flash_core_lse``
    does. Tiny shapes; tolerance REL of the largest gradient element."""
    rng = np.random.default_rng(4)
    b, s, h, d = 1, 24, 2, 8
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, s)).astype(np.float32)
    bias = _bias(kind, b, h, s, s, rng)

    def jax_loss(q, k, v):
        out, lse = jax_flash(q, k, v, bias=None if bias is None else jnp.asarray(bias),
                             interpret=True, block_q=128, block_k=128, return_lse=True)
        return jnp.sum(out * dout) + jnp.sum(lse * dlse)

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, None if bias is None else torch.from_numpy(bias), return_lse=True)
    loss = (out * torch.from_numpy(dout)).sum() + (lse * torch.from_numpy(dlse)).sum()
    for tg, jg in zip(torch.autograd.grad(loss, (tq, tk, tv)), jgrads):
        _close(tg, jg)
    # a loss on the lse alone: out's cotangent is undefined (None, not zeros)
    tb = None if bias is None else torch.from_numpy(bias)
    lse_loss = [(flash(tq, tk, tv, tb)[1] * torch.from_numpy(dlse)).sum() for flash in (
        lambda *a: flash_attention(*a, return_lse=True), flash_attention_reference)]
    got, ref = (torch.autograd.grad(loss, tq)[0] for loss in lse_loss)
    _close(got, ref.detach().numpy())


def test_flash_backward_reference_matches_autograd():
    rng = np.random.default_rng(1)
    b, sq, sk, h, d = 2, 40, 24, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).requires_grad_()
               for s in (sq, sk, sk))
    bias = torch.from_numpy(_bias("key", b, h, sq, sk, rng))
    dout = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32))
    out, lse = flash_attention_reference(q, k, v, bias)
    ref = torch.autograd.grad(out, (q, k, v), dout)
    got = flash_attention_backward_reference(q.detach(), k.detach(), v.detach(), bias, out.detach(), lse, dout)
    for g, r in zip(got, ref):
        _close(g, r.numpy(), rel=1e-5)


def test_flash_bias_is_a_constant():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 8, 1, 16)).astype(np.float32))
    bias = torch.zeros(1, 1, 8, 8, requires_grad=True)
    out = flash_attention(q.requires_grad_(), q, q, bias)
    out.sum().backward()
    assert bias.grad is None and q.grad is not None


def _gn_data(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, g


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 40), 4), ((1, 16, 16, 64), 32)])
def test_gn_silu_grads_match_jax_kernel(shape, groups):
    """C = 40 in 4 groups: 10 channels a group, straddling 8-wide vectors."""
    x, gamma, beta, g = _gn_data(shape)

    def jax_loss(x, gamma, beta):
        return jnp.sum(_gn_silu(x, gamma, beta, groups, 1e-5, True) * g)

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta))
    y = group_norm_silu(tx, tg, tb, groups, 1e-5)
    tgrads = torch.autograd.grad(y, (tx, tg, tb), torch.from_numpy(g))
    for tgr, jgr in zip(tgrads, jgrads):
        _close(tgr, jgr)


def test_plain_group_norm_grads_match_flax_groupnorm():
    import flax.linen as nn

    x, gamma, beta, g = _gn_data((2, 8, 8, 32))

    def jax_loss(x, gamma, beta):
        y = nn.GroupNorm(num_groups=8, epsilon=1e-6).apply({"params": {"scale": gamma, "bias": beta}}, x)
        return jnp.sum(y * g)

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta))
    y = group_norm_silu(tx, tg, tb, 8, 1e-6, silu=False)
    tgrads = torch.autograd.grad(y, (tx, tg, tb), torch.from_numpy(g))
    for tgr, jgr in zip(tgrads, jgrads):
        _close(tgr, jgr)


@pytest.mark.parametrize("silu", [True, False])
def test_gn_backward_pair_matches_autograd_of_the_plain_forward(silu):
    """K7 + glue + K8 (their plain versions) against autograd through
    ``group_norm_silu_reference``, and a non-contiguous incoming gradient
    is copied once and counted."""
    x, gamma, beta, g = _gn_data((2, 6, 6, 24), seed=3)
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta))
    gy = torch.from_numpy(g)
    ref = torch.autograd.grad(group_norm_silu_reference(tx, tg, tb, 6, 1e-5, silu), (tx, tg, tb), gy)
    before = GroupNormSiLUFunction.grad_layout_copies
    y = group_norm_silu(tx, tg, tb, 6, 1e-5, silu)
    got = torch.autograd.grad(y, (tx, tg, tb), gy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    assert GroupNormSiLUFunction.grad_layout_copies == before + 1
    for a, r in zip(got, ref):
        _close(a, r.numpy(), rel=1e-5)


def test_gn_backward_plain_kernels_keep_their_contract():
    """K7's t = (t1, t2) are the per-channel sums of dz and dz*xhat, and
    its coef (scale, shift, P, Q) folds the group means a, b of gamma*dz and
    gamma*dz*xhat into dx = scale*dz + P*x + Q; K8 with P = Q = 0 and a unit
    scale returns dz."""
    x, gamma, beta, g = _gn_data((2, 10, 16), seed=4)
    x3, g3 = torch.from_numpy(x), torch.from_numpy(g)
    sc, sh = torch.full((2, 16), 0.7), torch.full((2, 16), 0.1)
    mean, inv = torch.full((2, 4), 0.2 / 1.3), torch.full((2, 4), 1.3)  # 4 groups of 4 channels
    t, coef = gn_bwd_partials_reference(x3, g3, torch.from_numpy(gamma), sc, sh, mean, inv, silu=False)
    _close(t[:, 0], g.sum(1), rel=1e-6)
    _close(t[:, 1], (g * (x * 1.3 - 0.2)).sum(1), rel=1e-6)
    a, b = (np.repeat((gamma * s).reshape(2, 4, 4).sum(-1) / 40, 4, axis=1)
            for s in (g.sum(1), (g * (x * 1.3 - 0.2)).sum(1)))
    assert torch.equal(coef[:, 0], sc) and torch.equal(coef[:, 1], sh)
    _close(coef[:, 2], -1.3 * 1.3 * b, rel=1e-5)
    _close(coef[:, 3], -1.3 * (a - 0.2 * b), rel=1e-5)
    ones, zeros = torch.ones(2, 16), torch.zeros(2, 16)
    z = x * 0.7 + 0.1
    dz = torch.from_numpy(g) * torch.sigmoid(torch.from_numpy(z)) * (
        1 + torch.from_numpy(z) * (1 - torch.sigmoid(torch.from_numpy(z))))
    dx = gn_bwd_dx_reference(x3, g3, torch.stack([sc, sh, zeros, zeros], 1), silu=True)
    _close(dx, (0.7 * dz).numpy(), rel=1e-6)
    assert torch.equal(gn_bwd_dx_reference(x3, g3, torch.stack([ones, sh, zeros, zeros], 1), silu=False), g3)
