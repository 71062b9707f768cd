"""The port's checkpoint import against the JAX package's, on the CPU.

Key maps at full width: the port's modules built on the ``meta`` device,
the JAX trees from ``jax.eval_shape``. Each port parameter's flax path is a
leaf of the JAX tree, and the port's map gives it the JAX map's torch key
and a transform of the same name. For SDXL's UNet, VAE, CLIP-L and bigG the
port's export and a strict import consume the canonical diffusers/HF key
sets of ``tests/test_import_sdxl_fixture.py`` exactly, with their shapes;
for T5-XXL, SD3-medium's MMDiT, flux_dev and DiT-XL/2 the canonical set is
the JAX ``export_params`` of the preset's tree cut to two blocks (Flux: a
double and a single one). The JAX export copies every leaf, so its leaves
here are zero-byte ``V0`` arrays of the preset's shapes, and the depth is
cut for the time of that copy loop. Nothing of full width is allocated.

Values at the tiny presets: the JAX ``export_params`` of numpy-drawn params,
imported by the port, equals ``convert.load_jax_params`` of the same params
bitwise; the single-file bundle (``diffusers_to_ldm``, OpenCLIP naming for
the second tower) and its split back equal the JAX package's bitwise. The
port's ``.safetensors`` reader equals ``safetensors``' own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uwudiff_tpu.models.import_torch as jit_
import uwudiff_tpu.models.ldm_checkpoint as jldm
from test_import_sdxl_fixture import (
    diffusers_sdxl_unet_keys,
    diffusers_sdxl_vae_keys,
    hf_clip_text_keys,
)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import random_params
from uwudiff_tpu.models.clip import CLIPTextModel as JaxCLIP
from uwudiff_tpu.models.dit import DiT as JaxDiT
from uwudiff_tpu.models.flux import Flux as JaxFlux
from uwudiff_tpu.models.mmdit import MMDiT as JaxMMDiT
from uwudiff_tpu.models.t5 import T5EncoderModel as JaxT5
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu.models.vae import AutoencoderKL as JaxVAE
from uwudiff_tpu_torch.convert import load_jax_params
from uwudiff_tpu_torch.loader import ModelLoadConfig, apply_load_config
from uwudiff_tpu_torch.models import (
    CLIP_PRESETS,
    DIT_PRESETS,
    FLUX_PRESETS,
    MMDIT_PRESETS,
    T5_PRESETS,
    UNET_PRESETS,
    VAE_PRESETS,
    AutoencoderKL,
    CLIPTextModel,
    DiT,
    Flux,
    MMDiT,
    T5EncoderModel,
    UNet2DConditionModel,
)
from uwudiff_tpu_torch.models import import_torch as it
from uwudiff_tpu_torch.models import ldm_checkpoint as ldm

V0 = np.dtype("V0")  # a zero-byte element: the JAX export's copies of a leaf cost no memory


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(**cfg)


def _eval_shape(jmodel, init):
    """The JAX module's param tree by ``jax.eval_shape`` (the ``rbg`` key, as
    ``test_torch_models.init_shapes`` traces)."""
    with jax.default_prng_impl("rbg"):
        return jax.eval_shape(lambda r: init(jmodel, r), jax.random.PRNGKey(0))["params"]


def _jax_paths(tree) -> dict[str, tuple]:
    return {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _transform_name(tr):
    return ("_SplitLinear", tr.n, tr.j) if type(tr).__name__ == "_SplitLinear" else getattr(tr, "__name__", tr)


def _check_maps(module, tree, port_map, jax_map):
    """Every port parameter is a leaf of the JAX tree and gets the JAX map's
    key and a transform of its name."""
    paths = {it.flax_path(module, name) for name, _ in module.named_parameters()}
    assert paths == set(_jax_paths(tree))
    for path in paths:
        (key, tr), (jkey, jtr) = port_map(path), jax_map(path)
        assert key == jkey and _transform_name(tr) == _transform_name(jtr), path


def _check_canonical(module, key_map, canonical: dict):
    """The port's export has the canonical keys and shapes, and a strict
    import of the canonical set consumes every key."""
    exported = it.export_params(module, key_map)
    assert {k: tuple(v.shape) for k, v in exported.items()} == {k: tuple(s) for k, s in canonical.items()}
    sd = {k: torch.empty(s, device="meta") for k, s in canonical.items()}
    assert it.import_params(module, sd, key_map, strict=True) == set(canonical)


def _sdxl_case(name):
    if name == "unet":
        b = 1
        return (_meta(UNet2DConditionModel, UNET_PRESETS["sdxl"]), JaxUNet.from_config("sdxl"),
                lambda m, r: m.init(r, jnp.zeros((b, 32, 32, 4)), jnp.zeros((b,)), jnp.zeros((b, 77, 2048)), None,
                                    {"time_ids": jnp.zeros((b, 6)), "text_embeds": jnp.zeros((b, 1280))}),
                it.unet_key_map, jit_.unet_key_map, diffusers_sdxl_unet_keys())
    if name == "vae":
        return (_meta(AutoencoderKL, VAE_PRESETS["sdxl"]), JaxVAE.from_config("sdxl"),
                lambda m, r: m.init(r, jnp.zeros((1, 64, 64, 3)), r),
                it.vae_key_map, jit_.vae_key_map, diffusers_sdxl_vae_keys())
    hidden, layers, inter, proj = {"clip_l": (768, 12, 3072, False), "clip_bigg": (1280, 32, 5120, True)}[name]
    extra = {"projection_dim": hidden} if proj else {}
    return (_meta(CLIPTextModel, {**CLIP_PRESETS[name], **extra}), JaxCLIP.from_config(name, **extra),
            lambda m, r: m.init(r, jnp.zeros((1, 77), jnp.int32)),
            it.clip_text_key_map, jit_.clip_text_key_map, hf_clip_text_keys(hidden, layers, inter, proj))


@pytest.mark.parametrize("name", ["unet", "vae", "clip_l", "clip_bigg"])
def test_sdxl_key_maps_at_full_width_match_jax(name):
    module, jmodel, init, port_map, jax_map, canonical = _sdxl_case(name)
    tree = _eval_shape(jmodel, init)
    _check_maps(module, tree, port_map, jax_map)
    _check_canonical(module, port_map, canonical)


def _family_case(name):
    """(port module, JAX module, init, port map, JAX map) at the preset's
    widths, two blocks."""
    if name == "t5":
        cfg = {**T5_PRESETS["t5_xxl"], "num_layers": 2}
        return (_meta(T5EncoderModel, cfg), JaxT5.from_config("t5_xxl", num_layers=2),
                lambda m, r: m.init(r, jnp.zeros((1, 8), jnp.int32)), it.t5_key_map, jit_.t5_key_map)
    if name == "dit":
        return (_meta(DiT, {**DIT_PRESETS["dit_xl_2"], "depth": 2}), JaxDiT.from_config("dit_xl_2", depth=2),
                lambda m, r: m.init(r, jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32)),
                it.dit_key_map, jit_.dit_key_map)
    ctx = jnp.zeros((1, 8, 4096))
    if name == "mmdit":
        port_map = lambda p: it.mmdit_key_map(p, depth=2)  # noqa: E731
        return (_meta(MMDiT, {**MMDIT_PRESETS["sd3_medium"], "depth": 2}), JaxMMDiT.from_config("sd3_medium", depth=2),
                lambda m, r: m.init(r, jnp.zeros((1, 32, 32, 16)), jnp.zeros((1,)), ctx, None,
                                    {"text_embeds": jnp.zeros((1, 2048))}),
                port_map, lambda p: jit_.mmdit_key_map(p, depth=2))
    return (_meta(Flux, {**FLUX_PRESETS["flux_dev"], "depth": 1, "depth_single": 1}),
            JaxFlux.from_config("flux_dev", depth=1, depth_single=1),
            lambda m, r: m.init(r, jnp.zeros((1, 32, 32, 16)), jnp.zeros((1,)), ctx, None,
                                {"text_embeds": jnp.zeros((1, 768)), "guidance": jnp.zeros((1,))}),
            it.flux_key_map, jit_.flux_key_map)


@pytest.mark.parametrize("name", ["t5", "mmdit", "flux", "dit"])
def test_family_key_maps_at_preset_width_match_jax(name):
    module, jmodel, init, port_map, jax_map = _family_case(name)
    tree = _eval_shape(jmodel, init)
    _check_maps(module, tree, port_map, jax_map)
    zero = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), V0), s.shape), tree)
    canonical = {k: v.shape for k, v in jit_.export_params(zero, jax_map, dtype=V0).items()}
    _check_canonical(module, port_map, canonical)


@functools.lru_cache(maxsize=None)
def _tiny_params():
    """name -> (JAX params drawn from numpy, a function making the port module,
    the port's map, the JAX map) at the tiny presets, drawn once."""
    rng = np.random.default_rng(0)
    x4 = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = np.zeros((1,), np.float32)
    ctx48 = rng.standard_normal((1, 5, 48)).astype(np.float32)
    added = {"time_ids": np.zeros((1, 6), np.float32), "text_embeds": np.zeros((1, 16), np.float32)}
    ids = np.arange(1, 9, dtype=np.int32)[None]
    pooled24 = {"text_embeds": np.zeros((1, 24), np.float32)}
    return {
        "unet": (random_params(JaxUNet.from_config("tiny_sdxl"), x4, t, np.zeros((1, 7, 32), np.float32), None, added,
                               like=UNet2DConditionModel.from_config("tiny_sdxl", device="cpu")),
                 lambda: UNet2DConditionModel.from_config("tiny_sdxl", device="cpu"),
                 it.unet_key_map, jit_.unet_key_map),
        "vae": (random_params(JaxVAE.from_config("tiny"), np.zeros((1, 16, 16, 3), np.float32), jax.random.PRNGKey(1),
                              like=AutoencoderKL.from_config("tiny", device="cpu")),
                lambda: AutoencoderKL.from_config("tiny", device="cpu"), it.vae_key_map, jit_.vae_key_map),
        "clip": (random_params(JaxCLIP.from_config("tiny", projection_dim=24), ids,
                               like=CLIPTextModel.from_config("tiny", device="cpu", projection_dim=24)),
                 lambda: CLIPTextModel.from_config("tiny", device="cpu", projection_dim=24),
                 it.clip_text_key_map, jit_.clip_text_key_map),
        "t5": (random_params(JaxT5.from_config("tiny"), ids, like=T5EncoderModel.from_config("tiny", device="cpu")),
               lambda: T5EncoderModel.from_config("tiny", device="cpu"),
               it.t5_key_map, jit_.t5_key_map),
        "mmdit": (random_params(JaxMMDiT.from_config("tiny"), x4, t, ctx48, None, pooled24,
                                like=MMDiT.from_config("tiny", device="cpu")),
                  lambda: MMDiT.from_config("tiny", device="cpu"),
                  lambda p: it.mmdit_key_map(p, depth=2), lambda p: jit_.mmdit_key_map(p, depth=2)),
        "flux": (random_params(JaxFlux.from_config("tiny"), x4, t, ctx48, None,
                               {**pooled24, "guidance": np.ones((1,), np.float32)},
                               like=Flux.from_config("tiny", device="cpu")),
                 lambda: Flux.from_config("tiny", device="cpu"), it.flux_key_map, jit_.flux_key_map),
        "dit": (random_params(JaxDiT.from_config("tiny"), x4, t, np.zeros((1,), np.int32),
                              like=DiT.from_config("tiny", device="cpu")),
                lambda: DiT.from_config("tiny", device="cpu"), it.dit_key_map, jit_.dit_key_map),
    }


def test_tiny_imports_equal_load_jax_params_and_export_inverts_them():
    for name, (params, build, port_map, jax_map) in _tiny_params().items():
        sd = {k: torch.from_numpy(v) for k, v in jit_.export_params(params, jax_map).items()}
        ref = load_jax_params(build(), params).state_dict()
        module = build()
        with torch.no_grad():
            for p in module.parameters():
                p.zero_()
        assert it.import_params(module, sd, port_map) == set(sd), name
        for key, value in module.state_dict().items():
            assert torch.equal(value, ref[key]), (name, key)
        back = it.export_params(module, port_map)
        assert set(back) == set(sd), name
        for key in sd:
            assert torch.equal(back[key], sd[key]) and back[key].is_contiguous(), (name, key)


def _sdxl_components(seed=1):
    """Tiny SDXL-layout diffusers-named components, numpy from the JAX export
    and torch from the port's, of the same params."""
    cases = _tiny_params()
    comps = {}
    for name in ("unet", "vae"):
        params, build, port_map, jax_map = cases[name]
        comps[name] = (jit_.export_params(params, jax_map),
                       it.export_params(load_jax_params(build(), params), port_map))
    clip_params, _, port_map, jax_map = cases["clip"]
    rng = np.random.default_rng(seed)
    tes = []
    for proj in (False, True):  # CLIP-L (HF naming in the bundle), bigG with its projection (OpenCLIP naming)
        params = jax.tree_util.tree_map(lambda a: (a + rng.standard_normal(a.shape)).astype(np.float32), clip_params)
        if not proj:
            params = {k: v for k, v in params.items() if k != "text_projection"}
        module = CLIPTextModel.from_config("tiny", device="cpu", **({"projection_dim": 24} if proj else {}))
        tes.append((jit_.export_params(params, jax_map), it.export_params(load_jax_params(module, params), port_map)))
    return comps["unet"], comps["vae"], tes


def _assert_equal_dicts(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], torch.from_numpy(np.ascontiguousarray(want[k]))), k


def test_single_file_bundle_and_split_equal_jax():
    (j_unet, unet), (j_vae, vae), tes = _sdxl_components()
    want = jldm.diffusers_to_ldm(j_unet, j_vae, [j for j, _ in tes])
    got = ldm.diffusers_to_ldm(unet, vae, [t for _, t in tes])
    _assert_equal_dicts(got, want)
    assert "conditioner.embedders.1.model.transformer.resblocks.0.attn.in_proj_weight" in got
    assert "conditioner.embedders.1.model.text_projection" in got and ldm.is_ldm_checkpoint(got)
    for only in (None, "unet", "vae", "text_encoders"):
        jparts, parts = jldm.ldm_to_diffusers(want, only=only), ldm.ldm_to_diffusers(got, only=only)
        assert set(parts) == set(jparts)
        for key in parts:
            if key == "text_encoders":
                for p, jp in zip(parts[key], jparts[key], strict=True):
                    _assert_equal_dicts(p, jp)
            else:
                _assert_equal_dicts(parts[key], jparts[key])
    # the bare OpenCLIP projection is transposed into the HF Linear; its .weight form is not
    sub = {"text_projection.weight": got["conditioner.embedders.1.model.text_projection"]}
    assert torch.equal(ldm.openclip_text_to_hf(sub)["text_projection.weight"], sub["text_projection.weight"])
    for arch in ("sd1", "sd2"):
        _assert_equal_dicts(ldm.diffusers_to_ldm(unet, vae, [tes[0][1]], arch=arch),
                            jldm.diffusers_to_ldm(j_unet, j_vae, [tes[0][0]], arch=arch))


def test_safetensors_reader_equals_safetensors(tmp_path):
    from safetensors.torch import load_file, save_file

    rng = np.random.default_rng(2)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal(7).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32)).bfloat16(),
        "i64": torch.arange(5), "empty": torch.zeros((0, 4)), "scalar": torch.tensor(2.5),
    }
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got, meta = it.read_safetensors(str(path))
    want = load_file(str(path))
    assert meta == {"format": "pt"} and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert set(it.load_torch_state_dict(str(path))) == set(want)
    torch.save({"state_dict": tensors}, tmp_path / "t.ckpt")
    back = it.load_torch_state_dict(str(tmp_path / "t.ckpt"))
    assert all(torch.equal(back[k], tensors[k]) for k in tensors)


def test_apply_load_config_single_file(tmp_path):
    from safetensors.torch import save_file

    (_, unet_sd), (_, vae_sd), tes = _sdxl_components(seed=3)
    bundle = ldm.diffusers_to_ldm(unet_sd, vae_sd, [t for _, t in tes])
    path = str(tmp_path / "sdxl.safetensors")
    save_file({k: v.half() for k, v in bundle.items()}, path)
    clip = CLIPTextModel.from_config("tiny", device="cpu", projection_dim=24)
    timings = {}
    apply_load_config(clip, ModelLoadConfig(path, te_index=1, param_dtype="float16"), timings)
    assert set(timings) == {"read", "map", "copy"} and clip.loaded_keys == set(tes[1][1])
    assert clip.token_embedding.weight.dtype == torch.bfloat16  # float16 -> bfloat16, as in the JAX package
    assert torch.equal(clip.token_embedding.weight,
                       tes[1][1]["text_model.embeddings.token_embedding.weight"].half().bfloat16())
    unet = UNet2DConditionModel.from_config("tiny_sdxl", device="cpu")
    apply_load_config(unet, ModelLoadConfig(path))  # the importer found from the class
    assert unet.loaded_keys == set(unet_sd)
    with pytest.raises(ValueError, match="te_index=2"):
        apply_load_config(clip, ModelLoadConfig(path, te_index=2))
    with pytest.raises(KeyError, match="missing"):  # bigG's projection is not in CLIP-L's component
        apply_load_config(CLIPTextModel.from_config("tiny", device="cpu", projection_dim=24), ModelLoadConfig(path))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3e"):  # an Orbax directory
        apply_load_config(clip, ModelLoadConfig(str(tmp_path)))
    with pytest.raises(FileNotFoundError):  # .npz exports are read (tests/test_torch_fit.py); this one is absent
        apply_load_config(clip, ModelLoadConfig(str(tmp_path / "p.npz")))
    unet_only = str(tmp_path / "unet_only.safetensors")
    save_file({k: v for k, v in bundle.items() if k.startswith("model.diffusion_model.")}, unet_only)
    with pytest.raises(ValueError, match="no vae"):
        apply_load_config(AutoencoderKL.from_config("tiny", device="cpu"), ModelLoadConfig(unet_only))


def test_apply_load_config_sub_dict_and_read_single_file(tmp_path):
    """``state_dict_key``/``state_dict_prefix`` pick the sub-dict as the JAX
    package's ``extract_state_dict`` does; ``read_single_file`` splits a
    bundle once into the components ``apply_load_config`` loads one by one."""
    from safetensors.torch import save_file

    from uwudiff_tpu_torch.loader import read_single_file

    (_, unet_sd), (_, vae_sd), tes = _sdxl_components(seed=4)
    clip_sd = tes[1][1]
    nested = {"ema": {**{"te." + k: v for k, v in clip_sd.items()}, "other.w": torch.ones(2)}, "step": 3}
    torch.save(nested, tmp_path / "nested.pt")
    got = it.extract_state_dict(it.load_torch_state_dict(str(tmp_path / "nested.pt")), "ema", "te.")
    want = jit_.extract_state_dict({"ema": {k: v.numpy() for k, v in nested["ema"].items()}}, "ema", "te.")
    _assert_equal_dicts(got, want)
    clip = CLIPTextModel.from_config("tiny", device="cpu", projection_dim=24)
    apply_load_config(clip, ModelLoadConfig(str(tmp_path / "nested.pt"), state_dict_key="ema",
                                            state_dict_prefix="te."))
    assert clip.loaded_keys == set(clip_sd)
    assert torch.equal(clip.token_embedding.weight, clip_sd["text_model.embeddings.token_embedding.weight"])

    path = str(tmp_path / "sdxl.safetensors")
    save_file(ldm.diffusers_to_ldm(unet_sd, vae_sd, [t for _, t in tes]), path)
    timings = {}
    parts = read_single_file(path, timings)
    assert set(timings) == {"read", "map"} and len(parts["text_encoders"]) == 2
    _assert_equal_dicts(parts["unet"], {k: v.numpy() for k, v in unet_sd.items()})
    _assert_equal_dicts(parts["text_encoders"][1], {k: v.numpy() for k, v in clip_sd.items()})
    with pytest.raises(ValueError, match="not a single-file"):
        read_single_file(str(tmp_path / "nested.pt"))


def test_sdxl_pipeline_from_one_file(tmp_path, monkeypatch):
    """``sdxl_pipeline(ckpt_path=)`` reads the file once, builds on ``meta``
    and imports every component strictly; bigG's projection width is the
    file's. Its presets are cut to the tiny ones here."""
    from safetensors.torch import save_file

    from uwudiff_tpu_torch.serving import sdxl_pipeline

    (_, unet_sd), (_, vae_sd), tes = _sdxl_components(seed=5)
    path = str(tmp_path / "sdxl.safetensors")
    save_file(ldm.diffusers_to_ldm(unet_sd, vae_sd, [t for _, t in tes]), path)
    monkeypatch.setitem(UNET_PRESETS, "sdxl", UNET_PRESETS["tiny_sdxl"])
    monkeypatch.setitem(VAE_PRESETS, "sdxl", VAE_PRESETS["tiny"])
    for name in ("clip_l", "clip_bigg"):
        monkeypatch.setitem(CLIP_PRESETS, name, CLIP_PRESETS["tiny"])
    timings = {}
    pipe = sdxl_pipeline("cpu", torch.float32, ckpt_path=path, load_timings=timings)
    assert set(timings) == {"read", "map", "copy"}
    clip_l, clip_bigg = pipe.te.module.text_models
    assert clip_bigg.text_projection.out_features == 24
    for module, key_map, want in ((pipe.unet, it.unet_key_map, unet_sd), (pipe.vae, it.vae_key_map, vae_sd),
                                  (clip_l, it.clip_text_key_map, tes[0][1]),
                                  (clip_bigg, it.clip_text_key_map, tes[1][1])):
        assert module.loaded_keys == set(want)
        _assert_equal_dicts(it.export_params(module, key_map), {k: v.numpy() for k, v in want.items()})
    assert all(p.device.type == "cpu" for m in (pipe.unet, pipe.te.module, pipe.vae) for p in m.parameters())
