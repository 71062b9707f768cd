"""The port's models against the JAX package's, on the CPU, in fp32.

Weights: the JAX module's param shapes (``jax.eval_shape`` of its
``init``) filled with numpy draws from a seed — fan-in-scaled kernels,
perturbed norm scales and biases, so no layer is the near-zero identity
the JAX init gives some of them — loaded into the port through
``convert.load_jax_params``. Tolerances are relative to the output's
scale, 1e-5 of its max: fp32 sums in another order, through a few
dozen layers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models.clip import CLIPTextModel as JaxCLIP
from uwudiff_tpu.models.layers import get_timestep_embedding as jax_timestep_embedding
from uwudiff_tpu.models.text_encoders import ConcatTextEncoders as JaxConcat
from uwudiff_tpu.models.tokenizers import SimpleTokenizer as JaxTokenizer
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu.models.vae import AutoencoderKL as JaxVAE
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.diffusion import NoiseSchedule
from uwudiff_tpu_torch.models import (
    AutoencoderKL,
    ConcatTextEncoders,
    UNet2DConditionModel,
)
from uwudiff_tpu_torch.models.layers import LayerNorm, Upsample2D, get_timestep_embedding


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a module of the port's tests runs: the suite
    runs several test processes at once, and more threads each only make
    them contend for the cores. Every test_torch_*.py that computes on the
    CPU imports it; the thread count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_params(module, *args, seed=0, method=None):
    """Param tree of ``module.init(*args)`` filled from numpy."""
    rng = np.random.default_rng(seed)
    kw = {"method": method} if method is not None else {}
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape).astype(np.float32) / np.sqrt(fan_in)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "embedding":
            return rng.standard_normal(shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# LLVM's cheap settings for the JAX reference programs: about half the
# compile time on the CPU. They change how the backend lowers XLA's program,
# which may reorder fp32 arithmetic; the tests' tolerances cover that
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compile_fast(fn, *args, **jit_kw):
    """``jax.jit(fn, **jit_kw)`` compiled for ``args`` with FAST_COMPILE."""
    return jax.jit(fn, **jit_kw).lower(*args).compile(FAST_COMPILE)


def assert_close(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=rel * max(1.0, np.abs(ref).max()), rtol=0)


def unet_inputs(preset, b=2, hw=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    t = np.array([10.5, 731.25], np.float32)[:b]
    ctx = rng.standard_normal((b, 7, 32)).astype(np.float32)
    added = None
    if preset == "tiny_sdxl":
        added = {
            "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (b, 1)),
            "text_embeds": rng.standard_normal((b, 16)).astype(np.float32),
        }
    return x, t, ctx, added


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("preset", ["tiny_sdxl", "tiny"])
def test_unet_forward_matches_jax(preset):
    x, t, ctx, added = unet_inputs(preset)
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    jmodel = JaxUNet.from_config(preset)
    params = random_params(jmodel, x, t, ctx, mask, added)
    ref = jax.jit(jmodel.apply)({"params": params}, x, t, ctx, mask, added)
    model = load_jax_params(UNet2DConditionModel.from_config(preset, device="cpu"), params)
    with torch.no_grad():
        out = model(_t(x), _t(t), _t(ctx), _t(mask),
                    None if added is None else {k: _t(v) for k, v in added.items()})
    assert_close(out, ref)


def _clip_pair():
    cfgs = [
        ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": False, "layer_idx": -2}),
        ({"model_type": "clip", "preset": "tiny"}, {"use_pooled": True, "layer_idx": -2}),
    ]
    return JaxConcat.from_config(cfgs), ConcatTextEncoders.from_config(cfgs, device="cpu")


def test_clip_concat_encoders_match_jax():
    jmodel, model = _clip_pair()
    tok = JaxTokenizer()
    texts = ["a photo of a cat", "", "an oil painting of a lighthouse at dusk"]
    toks = [tok(texts, padding=True, truncation=True) for _ in range(2)]
    params = random_params(jmodel, toks)
    ref = jax.jit(jmodel.apply)({"params": params}, toks)
    load_jax_params(model, params)
    with torch.no_grad():
        out = model([{k: _t(v) for k, v in t.items()} for t in toks])
    for o, r in zip(out, ref):
        assert (o is None) == (r is None)
        if r is not None:
            assert_close(o, r)
    # SDXL layout: features concat (32 + 32), pooled of the second tower only
    assert out[0].shape == (3, 77, 64) and out[2].shape == (3, 32)


def test_clip_gelu_tower_matches_jax():
    """clip_bigg's act: flax nn.gelu is the tanh approximation."""
    jmodel = JaxCLIP.from_config("tiny", hidden_act="gelu", projection_dim=8)
    ids = np.asarray(JaxTokenizer()(["a red fox", "snow"])["input_ids"])
    params = random_params(jmodel, ids)
    ref = jax.jit(functools.partial(jmodel.apply, layer_idx=-2))({"params": params}, ids)
    from uwudiff_tpu_torch.models import CLIPTextModel

    model = load_jax_params(
        CLIPTextModel.from_config("tiny", device="cpu", hidden_act="gelu", projection_dim=8), params
    )
    with torch.no_grad():
        out = model(_t(ids), None, -2)
    for name in ("last_hidden_state", "pooler_output", "embedding", "normed_embedding", "text_embeds"):
        assert_close(getattr(out, name), getattr(ref, name))


def test_vae_decode_matches_jax():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    jvae = JaxVAE.from_config("tiny")
    params = random_params(jvae, z, method=jvae.decode)
    # decode-only init has no encoder; the full tree (with encoder and
    # quant_conv) is what checkpoints hold, and the port's VAE holds it all
    full = random_params(jvae, np.zeros((1, 16, 16, 3), np.float32), jax.random.PRNGKey(1))
    full = {**full, "decoder": params["decoder"], "post_quant_conv": params["post_quant_conv"]}
    ref = jax.jit(functools.partial(jvae.apply, method=jvae.decode))({"params": full}, z)
    vae = load_jax_params(AutoencoderKL.from_config("tiny", device="cpu"), full)
    with torch.no_grad():
        out = vae.decode(_t(z))
    assert out.shape == (1, 16, 16, 3)
    assert_close(out, ref)


def test_convert_raises_on_mismatch():
    jvae = JaxVAE.from_config("tiny")
    params = random_params(jvae, np.zeros((1, 16, 16, 3), np.float32), jax.random.PRNGKey(1))
    vae = AutoencoderKL.from_config("tiny", device="cpu")
    extra = {**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(vae, extra)
    missing = {k: v for k, v in params.items() if k != "post_quant_conv"}
    with pytest.raises(KeyError, match="post_quant_conv"):
        load_jax_params(vae, missing)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["post_quant_conv"] = {"kernel": np.zeros((1, 1, 4, 5), np.float32),
                              "bias": np.zeros((5,), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(vae, bad)


def test_layer_norm_computes_a_bf16_input_in_fp32_on_the_cpu():
    """As flax's LayerNorm: the output and the weight and bias gradients
    are the fp32 computation's, rounded once to bf16 (torch's CPU kernel
    sums a bf16 input's parameter gradients in bf16)."""
    rng = np.random.default_rng(0)
    x, dy = (torch.from_numpy(rng.standard_normal((2, 256, 32)).astype(np.float32)).bfloat16() for _ in range(2))
    ln = LayerNorm(32, eps=1e-5)
    with torch.no_grad():
        ln.weight.normal_(1.0, 0.2)
        ln.bias.normal_(0.0, 0.1)
    w, b = (t.detach().clone().requires_grad_() for t in (ln.weight, ln.bias))
    ln.to(torch.bfloat16)
    y = ln(x)
    y.backward(dy)
    ref = torch.nn.functional.layer_norm(x.float(), (32,), w.bfloat16().float(), b.bfloat16().float(), 1e-5)
    ref.backward(dy.float())
    assert y.dtype == torch.bfloat16 and torch.equal(y, ref.bfloat16())
    assert torch.equal(ln.weight.grad, w.grad.bfloat16()) and torch.equal(ln.bias.grad, b.grad.bfloat16())


def test_upsample_nearest_matches_jax_resize():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 6, 10, 4), method="nearest")
    up = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    assert isinstance(Upsample2D(4, 4).conv, torch.nn.Conv2d)


def test_timestep_embedding_matches_jax():
    # sin/cos of fp32 arguments up to ~1e3 rad: one ulp of the argument
    # is 6e-5, and the two libraries reduce the range differently
    t = np.array([0.0, 1.5, 999.0], np.float32)
    for dim in (8, 320, 7):
        ref = jax_timestep_embedding(jnp.asarray(t), dim)
        assert_close(get_timestep_embedding(_t(t), dim), ref, rel=2e-4)


def test_schedule_matches_jax():
    # XLA's fp32 cumprod of the alphas sits up to 6e-7 from the exact
    # product, the port's fp64 product is rounded once; at the low end
    # sigma = sqrt((1-acp)/acp) magnifies one ulp of acp ~ 1 about 1e3x
    js, ts = JaxSchedule.sdxl(), NoiseSchedule.sdxl()
    np.testing.assert_allclose(ts.sigmas.numpy(), np.asarray(js.sigmas), rtol=1e-5)
    for steps in (4, 16, 25):
        np.testing.assert_allclose(
            ts.sample_sigmas_descending(steps).numpy(), np.asarray(js.sample_sigmas_descending(steps)),
            rtol=2e-6,
        )
    sig = np.array([14.6, 3.1, 0.5, 0.0292, 0.01], np.float32)
    np.testing.assert_allclose(ts.sigma_to_t(_t(sig)).numpy(), np.asarray(js.sigma_to_t(sig)),
                               rtol=1e-5, atol=1e-4)
    t = np.array([0.0, 10.25, 998.5], np.float32)
    np.testing.assert_allclose(ts.t_to_sigma(_t(t)).numpy(), np.asarray(js.t_to_sigma(jnp.asarray(t))),
                               rtol=1e-5)
