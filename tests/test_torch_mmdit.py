"""The port's MMDiT against the JAX package's, on the CPU, in fp32.

A tiny MMDiT with SD3's architecture switches on (the ``context_pre_only``
last block, the cropped position grid) and a text key mask; weights are
``test_torch_models.random_params`` draws, which also fill the leaves the
JAX init zeroes (adaLN modulations, final projection), so the gradient
reaches the context. Tolerances: the forward within 1e-5 of the output's
max, gradients within 1e-4 of their largest element (fp32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import assert_close, compile_fast, random_params
from uwudiff_tpu.models.mmdit import MMDiT as JaxMMDiT
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.models import MMDiT

SD3_SWITCHES = dict(depth=3, context_pre_only=True, pos_embed_max_size=16, pos_embed_base_size=8)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3.5, 871.25], np.float32)
    ctx = rng.standard_normal((2, 7, 48)).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    pooled = rng.standard_normal((2, 24)).astype(np.float32)
    return x, t, ctx, mask, pooled


def test_mmdit_forward_and_input_grads_match_jax():
    x, t, ctx, mask, pooled = _inputs()
    jmodel = JaxMMDiT.from_config("tiny", **SD3_SWITCHES)
    params = random_params(jmodel, x, t, ctx, mask, {"text_embeds": pooled})
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def loss(ctx, pooled):
        out = jmodel.apply({"params": params}, x, t, ctx, mask, {"text_embeds": pooled})
        return jnp.sum(out * g), out

    (_, ref), (jd_ctx, jd_pooled) = compile_fast(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                                                 ctx, pooled)(ctx, pooled)
    model = load_jax_params(MMDiT.from_config("tiny", device="cpu", **SD3_SWITCHES), params)
    tctx, tpooled = torch.from_numpy(ctx).requires_grad_(), torch.from_numpy(pooled).requires_grad_()
    out = model(torch.from_numpy(x), torch.from_numpy(t), tctx, torch.from_numpy(mask), {"text_embeds": tpooled})
    assert out.shape == x.shape and out.dtype == torch.float32
    assert_close(out, ref)
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in ((tctx.grad, jd_ctx), (tpooled.grad, jd_pooled)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    # padded text keys take no part: their context rows get no gradient
    assert tctx.grad[1, 4:].abs().max() == 0


def test_mmdit_loads_a_scanned_block_stack():
    """A ``scan_blocks=True`` tree (one ``blocks`` subtree with a leading
    layer axis) unstacks into the port's ``blocks_{i}``."""
    x, t, ctx, mask, pooled = _inputs(seed=2)
    jmodel = JaxMMDiT.from_config("tiny", scan_blocks=True, **SD3_SWITCHES)
    params = random_params(jmodel, x, t, ctx, None, {"text_embeds": pooled}, seed=3)
    assert params["blocks"]["adaLN_x"]["kernel"].shape[0] == 2
    args = ({"params": params}, x, t, ctx, None, {"text_embeds": pooled})
    ref = compile_fast(jmodel.apply, *args)(*args)
    model = load_jax_params(MMDiT.from_config("tiny", device="cpu", **SD3_SWITCHES), params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), None,
                    {"text_embeds": torch.from_numpy(pooled)})
    assert_close(out, ref)
    bad = {**params, "blocks": jax.tree_util.tree_map(lambda a: a[:1], params["blocks"])}
    with pytest.raises(ValueError, match="layer axes"):
        load_jax_params(model, bad)


def test_mmdit_zero_initialised_leaves_and_unported_options():
    model = MMDiT.from_config("tiny", device="cpu", **SD3_SWITCHES)
    for name in ("blocks_0.adaLN_x", "blocks_1.adaLN_ctx", "final_block.adaLN_ctx", "final_modulation"):
        layer = model.get_submodule(name)
        assert not layer.weight.any() and not layer.bias.any(), name
    assert not model.final_proj.weight.any()
    assert model.final_block.adaLN_ctx.out_features == 2 * 32 and not hasattr(model.final_block, "mlp_ctx")
    for key in ("scan_blocks", "gradient_checkpointing", "num_experts"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MMDiT.from_config("tiny", device="cpu", **{key: 1})
