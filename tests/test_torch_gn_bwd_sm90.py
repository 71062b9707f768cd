"""The GroupNorm(+SiLU) backward's plain versions against the JAX package,
on the CPU.

The port's backward takes one of two routes (``plan_gn_bwd``): the fused
kernel, whose plain version ``gn_silu_bwd_fused_reference`` is also the
whole backward on CPU tensors, or the pair K7 then K8, whose plain
versions are ``gn_bwd_partials_reference`` (the sums, and K8's
coefficients with the group means folded in) and ``gn_bwd_dx_reference``.
Both routes start from the statistics the port's forward saves and are
held against ``jax.grad`` of the JAX package: ``_gn_silu`` through its
Pallas backward (K7, the XLA glue, K8) in interpret mode, as the JAX
package's own tests run it, and, with SiLU off, flax ``nn.GroupNorm``,
the plain GroupNorm of the JAX package's models, each compiled as one
program with the suite's cheap compiler settings (``compile_fast``) and
computed once for the routes that share its inputs. Inputs are numpy
draws from a seed, fp32. Tolerance: 1e-4 of the largest gradient element (fp32
sums in another order).
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import compile_fast
from uwudiff_tpu.ops.groupnorm_silu import _gn_silu
from uwudiff_tpu_torch.ops.groupnorm_silu import (
    gn_bwd_dx_reference,
    gn_bwd_partials_reference,
    gn_silu_bwd_fused_reference,
    gn_stats_reference,
    group_norm_silu,
)

EPS = 1e-5
REL = 1e-4


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    out = out.detach().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, g


@functools.lru_cache(maxsize=None)
def _jax_grads(shape, groups, seed, silu):
    """(dx, dgamma, dbeta) of ``_data(shape, seed)`` from the JAX package:
    the Pallas backward in interpret mode with SiLU, flax's GroupNorm
    without."""
    x, gamma, beta, g = _data(shape, seed)
    if silu:
        def fwd(x, gamma, beta):
            return _gn_silu(x, gamma, beta, groups, EPS, True)
    else:
        def fwd(x, gamma, beta):
            return nn.GroupNorm(num_groups=groups, epsilon=EPS).apply({"params": {"scale": gamma, "bias": beta}}, x)

    grad = jax.grad(lambda *a: jnp.sum(fwd(*a) * g), argnums=(0, 1, 2))
    return compile_fast(grad, x, gamma, beta)(x, gamma, beta)


# C = 40 in 4 groups: 10 channels a group, straddling the kernels' 8-wide vectors
CASES = [((2, 8, 8, 40), 4, 0), ((1, 16, 16, 64), 32, 1)]


@pytest.mark.parametrize("shape,groups,seed", CASES)
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("route", ["fused", "pair"])
def test_backward_plain_versions_match_jax(route, silu, shape, groups, seed):
    """Each route's plain versions, from the forward's saved statistics:
    dx, and dgamma/dbeta as the sums over samples of t2 and t1."""
    x, gamma, beta, g = _data(shape, seed)
    jgrads = _jax_grads(shape, groups, seed, silu)
    n, c = shape[0], shape[-1]
    x3, g3 = torch.from_numpy(x).reshape(n, -1, c), torch.from_numpy(g).reshape(n, -1, c)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    scale, shift, mean, inv = gn_stats_reference(x3, tg, tb, groups, EPS, with_group_stats=True)
    if route == "fused":
        dx, t = gn_silu_bwd_fused_reference(x3, g3, tg, scale, shift, mean, inv, silu)
    else:
        t, coef = gn_bwd_partials_reference(x3, g3, tg, scale, shift, mean, inv, silu)
        dx = gn_bwd_dx_reference(x3, g3, coef, silu)
    sums = t.sum(0)
    for got, want in zip((dx.reshape(shape), sums[1], sums[0]), jgrads):
        _close(got, want)


@pytest.mark.parametrize("silu", [True, False])
def test_cpu_backward_matches_jax(silu):
    """The whole CPU backward through autograd (the forward's plain
    version, its saved statistics, the fused route's plain backward)."""
    shape, groups, seed = CASES[0]
    x, gamma, beta, g = _data(shape, seed + 2)
    jgrads = _jax_grads(shape, groups, seed + 2, silu)
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta))
    tgrads = torch.autograd.grad(group_norm_silu(tx, tg, tb, groups, EPS, silu), (tx, tg, tb), torch.from_numpy(g))
    for got, want in zip(tgrads, jgrads):
        _close(got, want)
