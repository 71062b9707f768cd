"""The port's SD1.5 UNet (the ``sd15`` preset) against the JAX package's, on the CPU.

The preset is the JAX package's (SD1.5's layout: four levels, the last a
``DownBlock2D``, 8 heads, 1x1-conv transformer projections, 768-wide
context, no addition embedding). The model is held at that layout with
narrow widths: ``block_out_channels=(32, 64, 64, 64)``, 2 heads, 32-wide
context of 3 tokens, 8 groups, 16x16 latents, batch 2; fp32, the same
numpy weights on both sides (``test_torch_models.random_params``), the
tolerance of ``test_torch_models``' UNet (1e-5 of the output's largest
value). The same tree round-trips through ``load_jax_params`` and
``to_jax_params`` bitwise: every leaf, the 1x1 projection kernels
included.
"""

import jax
import numpy as np
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import _t, assert_close, compile_fast, random_params
from uwudiff_tpu.models.unet import UNET_PRESETS as JAX_PRESETS
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
from uwudiff_tpu_torch.models import UNet2DConditionModel
from uwudiff_tpu_torch.models.unet import UNET_PRESETS

NARROW = dict(block_out_channels=(32, 64, 64, 64), num_attention_heads=2, cross_attention_dim=32, norm_num_groups=8)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)  # the fp32 values the module holds


def test_sd15_preset_is_the_jax_one():
    norm = lambda cfg: {k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in cfg.items()}  # noqa: E731
    assert norm(UNET_PRESETS["sd15"]) == norm(JAX_PRESETS["sd15"])


def test_narrow_sd15_unet_matches_jax_and_its_tree_round_trips():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10.5, 731.25], np.float32)
    ctx = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jmodel = JaxUNet.from_config("sd15", **NARROW)
    params = random_params(jmodel, x, t, ctx, None, None)
    assert params["down_0_attn_0"]["proj_in"]["kernel"].shape == (1, 1, 32, 32)  # the 1x1-conv projections
    ref = compile_fast(lambda p, *a: jmodel.apply({"params": p}, *a), params, x, t, ctx)(params, x, t, ctx)
    model = load_jax_params(UNet2DConditionModel.from_config("sd15", device="cpu", **NARROW), params)
    assert isinstance(model.down_0_attn_0.proj_in, torch.nn.Conv2d) and model.addition_embed_type is None
    with torch.no_grad():
        out = model(_t(x), _t(t), _t(ctx))
    assert out.shape == (2, 16, 16, 4)
    assert_close(out, ref)
    back, src = dict(_flat(to_jax_params(model))), dict(_flat(jax.device_get(params)))
    assert set(back) == set(src)
    for name in src:
        np.testing.assert_array_equal(back[name], src[name], err_msg=name)
