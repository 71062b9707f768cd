"""The port's kernel modules against the JAX package, on the CPU.

On the CPU the port runs each kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do. Inputs are made with numpy from a seed; everything is fp32.
Tolerance: 2e-5 absolute on O(1) outputs, the bound the JAX package's
own kernel tests use — both sides accumulate in fp32, in another order.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from uwudiff_tpu.ops.attention import _xla_attention
from uwudiff_tpu.ops.attention import attention_bias_from_mask as jax_bias_from_mask
from uwudiff_tpu.ops.flash_attention import flash_attention as jax_flash
from uwudiff_tpu.ops.groupnorm_silu import _gn_silu_fwd_chunked
from uwudiff_tpu.ops.groupnorm_silu import group_norm_silu as jax_gn_silu
from uwudiff_tpu_torch.ops import (
    attention_bias_from_mask,
    attention_reference,
    dot_product_attention,
    flash_attention,
    gn_silu_apply,
    gn_stats,
    group_norm_silu,
)
from uwudiff_tpu_torch.ops.groupnorm_silu import gn_silu_apply_reference, gn_stats_reference

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-5


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))
    )


def _bias(kind, b, h, sq, sk, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "key":  # padding mask as the models build it: finfo.min on masked keys
        mask = np.ones((b, sk), np.int32)
        mask[:, sk // 2:] = 0
        return np.asarray(jax_bias_from_mask(jnp.asarray(mask)))
    # full: CLIP-style causal + padding, finfo.min added twice -> -inf,
    # plus a finite random part
    neg = np.finfo(np.float32).min
    causal = np.where(np.tril(np.ones((sq, sk), bool)), 0.0, neg).astype(np.float32)
    pad = np.where(np.arange(sk) < sk - 3, 0.0, neg).astype(np.float32)
    with np.errstate(over="ignore"):
        full = causal[None, None] + pad[None, None, None, :]
    return full + rng.standard_normal((b, h, sq, sk)).astype(np.float32)


@pytest.mark.parametrize(
    "b,sq,sk,h,d,kind",
    [
        (1, 256, 256, 2, 64, "none"),
        (2, 128, 256, 2, 40, "key"),
        (1, 77, 77, 2, 64, "full"),  # CLIP's causal 77x77 with -inf entries
        (1, 200, 77, 2, 80, "none"),  # ragged Sq and a cross-attention Sk
    ],
)
def test_flash_plain_matches_jax_kernel(b, sq, sk, h, d, kind):
    q, k, v = _qkv(b, sq, sk, h, d)
    bias = _bias(kind, b, h, sq, sk)
    jout, jlse = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias),
        interpret=True, block_q=128, block_k=128, return_lse=True,
    )
    tbias = None if bias is None else torch.tensor(bias)
    tout, tlse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bias=tbias, return_lse=True
    )
    assert tout.shape == (b, sq, h, d) and tlse.shape == (b, h, sq)
    assert torch.isfinite(tout).all()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL, rtol=1e-6)


def test_attention_einsum_and_mask_bias_match_jax():
    q, k, v = _qkv(2, 40, 24, 2, 16)
    mask = np.ones((2, 24), np.int32)
    mask[1, 10:] = 0
    jb = jax_bias_from_mask(jnp.asarray(mask))
    tb = attention_bias_from_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb)
    out = attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bias=tb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # the dispatch sends CPU tensors to the einsum at every head dim
    out2 = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tb)
    np.testing.assert_array_equal(out2.numpy(), out.numpy())


def _gn_data(n, hw, c, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, hw, c)) * 2.0 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("shape,groups", [((2, 16, 16, 64), 32), ((1, 8, 8, 320), 32)])
def test_gn_silu_plain_matches_jax_kernel(shape, groups):
    n, h, w, c = shape
    x, gamma, beta = _gn_data(n, h * w, c)
    x = x.reshape(shape)
    ref = jax_gn_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-5,
                      interpret=True)
    out = group_norm_silu(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                          groups, 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_gn_stats_and_apply_plain_match_jax_chunked_kernel():
    """K3: the chunked-stats Pallas kernel + its apply, against the
    port's gn_stats/gn_silu_apply plain versions (hw > 512: several chunks)."""
    x, gamma, beta = _gn_data(2, 1024, 64)
    ref = _gn_silu_fwd_chunked(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 16, 1e-5,
                               interpret=True)
    scale, shift = gn_stats_reference(torch.from_numpy(x), torch.from_numpy(gamma),
                                      torch.from_numpy(beta), 16, 1e-5)
    out = gn_silu_apply_reference(torch.from_numpy(x), scale, shift)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_plain_group_norm_matches_flax_groupnorm():
    import flax.linen as nn

    x, gamma, beta = _gn_data(2, 64, 32)
    x = x.reshape(2, 8, 8, 32)
    ref = nn.GroupNorm(num_groups=8, epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}, jnp.asarray(x)
    )
    out = group_norm_silu(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                          8, 1e-6, silu=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_kernel_wrappers_take_cuda_tensors_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        from uwudiff_tpu_torch.ops import flash_fwd

        flash_fwd(q, k, v)
    x = torch.zeros(1, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        gn_stats(x, torch.ones(64), torch.zeros(64), 32, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        gn_silu_apply(x, torch.ones(1, 64), torch.zeros(1, 64))


def test_entry_points_raise_without_cuda(monkeypatch):
    from uwudiff_tpu_torch.models import CLIPTextModel, UNet2DConditionModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNet2DConditionModel.from_config("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIPTextModel.from_config("tiny")
    assert isinstance(CLIPTextModel.from_config("tiny", device="cpu"), CLIPTextModel)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "uwudiff_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    banned = ("jax", "flax", "optax", "uwudiff_tpu")
    bad = [
        f"{p.relative_to(REPO)}: {name}"
        for p in files for name in _imports(p)
        if name.split(".")[0] in banned
    ]
    assert len(files) > 10
    assert not bad, bad
