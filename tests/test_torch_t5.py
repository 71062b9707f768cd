"""The port's T5 encoder and the flash dBias path against the JAX package,
on the CPU, in fp32.

Weights are ``test_torch_models.random_params`` draws loaded through
``convert.load_jax_params``. Tolerances: bucket ids exactly equal; the
forward within 1e-5 of the output's max (fp32 sums in another order);
gradients within 1e-4 of each gradient's largest element (the backward
adds another pass of reordered fp32 sums and, for the flash case, the
JAX kernel's exp2-domain arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import assert_close, compile_fast, random_params
from uwudiff_tpu.models.t5 import T5EncoderModel as JaxT5
from uwudiff_tpu.models.t5 import relative_position_bucket as jax_bucket
from uwudiff_tpu.ops.flash_attention import flash_attention as jax_flash
from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
from uwudiff_tpu_torch.models import T5EncoderModel
from uwudiff_tpu_torch.models.t5 import relative_position_bucket
from uwudiff_tpu_torch.ops.attention import dot_product_attention
from uwudiff_tpu_torch.ops.flash_attention import _split_bias, flash_attention

REL_GRAD = 1e-4


def _grad_close(out, ref):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=REL_GRAD * np.abs(ref).max(), rtol=0)


def test_relative_position_buckets_match_jax():
    pos = np.arange(512)
    rel = pos[None, :] - pos[:, None]
    for num_buckets, max_distance in ((32, 128), (64, 256)):
        ref = np.asarray(jax_bucket(jnp.asarray(rel), num_buckets, max_distance))
        got = relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance).numpy()
        np.testing.assert_array_equal(got, ref)


def _t5_inputs(b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1024, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 11:] = 0  # key padding on the second row
    return ids, mask


def test_t5_forward_and_grads_match_jax():
    """The forward, and the gradients of sum(out * g) with respect to the
    token embeddings and the (here trainable) relative-position bias table,
    which reach it through every layer's attention bias."""
    ids, mask = _t5_inputs()
    jmodel = JaxT5.from_config("tiny")
    params = random_params(jmodel, ids, mask, like=T5EncoderModel.from_config("tiny", device="cpu"))
    g = np.random.default_rng(1).standard_normal((2, ids.shape[1], 32)).astype(np.float32)

    def loss(p):
        out = jmodel.apply({"params": p}, ids, mask)
        return jnp.sum(out.last_hidden_state * g), out

    (_, jout), jgrads = compile_fast(jax.value_and_grad(loss, has_aux=True), params)(params)
    model = load_jax_params(T5EncoderModel.from_config("tiny", device="cpu"), params)
    out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert_close(out.last_hidden_state, jout.last_hidden_state)
    for got, ref in zip(out.hidden_states, jout.hidden_states):
        assert_close(got, ref)
    (out.last_hidden_state * torch.from_numpy(g)).sum().backward()
    grads = to_jax_params(model, {n: p.grad for n, p in model.named_parameters()})
    _grad_close(grads["token_embedding"]["embedding"], jgrads["token_embedding"]["embedding"])
    _grad_close(grads["relative_attention_bias"]["embedding"], jgrads["relative_attention_bias"]["embedding"])
    assert np.abs(grads["relative_attention_bias"]["embedding"]).max() > 0
    for name in ("q", "k", "wo"):
        _grad_close(grads["layers_1"][name]["kernel"], jgrads["layers_1"][name]["kernel"])


def test_t5_keeps_fp32_norms_and_bias_table():
    model = T5EncoderModel.from_config("tiny", device="cpu", dtype=torch.bfloat16)
    assert model.layers_0.q.weight.dtype == torch.bfloat16
    assert model.layers_0.attn_norm.weight.dtype == torch.float32
    assert model.final_norm.weight.dtype == torch.float32
    assert model.relative_attention_bias.weight.dtype == torch.float32
    ids, mask = _t5_inputs(s=12)
    out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.last_hidden_state.dtype == torch.bfloat16 and torch.isfinite(out.last_hidden_state).all()


def test_t5_bias_reaches_the_kernels_uncopied(monkeypatch):
    """The bias built once per forward is fp32, full and contiguous, so the
    kernels' wrapper hands every layer's launches the same storage."""
    import uwudiff_tpu_torch.models.t5 as t5_module

    seen = []

    def spy(q, k, v, bias=None, scale=None, bias_grad=False):
        seen.append((bias, q.shape, k.shape[1]))
        return dot_product_attention(q, k, v, bias, scale, bias_grad)

    monkeypatch.setattr(t5_module, "dot_product_attention", spy)
    ids, mask = _t5_inputs(s=24)
    T5EncoderModel.from_config("tiny", device="cpu", dtype=torch.bfloat16)(torch.from_numpy(ids),
                                                                           torch.from_numpy(mask))
    assert len(seen) == 2 and seen[0][0] is seen[1][0]
    for bias, (b, sq, h, _), sk in seen:
        mode, split = _split_bias(bias, b, h, sq, sk, full=True)
        assert mode == 2 and split.dtype == torch.float32 and split.data_ptr() == bias.data_ptr()
        assert _split_bias(bias, b, h, sq, sk)[1].data_ptr() == bias.data_ptr()
    key = torch.zeros((2, 1, 1, 24))
    assert _split_bias(key, 2, 4, 24, 24)[1].data_ptr() == key.data_ptr()


def test_flash_plain_dbias_matches_jax_kernel():
    """The autograd function's plain backward with ``bias_grad=True``
    (dQ, dK, dV and the full bias's dS) against jax.grad through the Pallas
    kernels in interpret mode (K1, K5, K6) at a ragged shape with key
    padding in the bias."""
    b, s, h, d = 1, 130, 2, 16
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    bias = rng.standard_normal((b, h, s, s)).astype(np.float32)
    bias[..., s - 9:] = np.finfo(np.float32).min

    def jax_loss(q, k, v, bias):
        out = jax_flash(q, k, v, bias=bias, scale=1.0, interpret=True, block_q=128, block_k=128, bias_grad=True)
        return jnp.sum(out * dout)

    args = tuple(map(jnp.asarray, (q, k, v, bias)))
    jgrads = compile_fast(jax.grad(jax_loss, argnums=(0, 1, 2, 3)), *args)(*args)
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias))
    out = flash_attention(tq, tk, tv, tb, 1.0, bias_grad=True)
    tgrads = torch.autograd.grad(out, (tq, tk, tv, tb), torch.from_numpy(dout))
    for tg, jg in zip(tgrads, jgrads):
        _grad_close(tg, jg)
    assert np.abs(np.asarray(jgrads[3])[..., s - 9:]).max() == 0 == tgrads[3][..., s - 9:].abs().max()
