"""The port's adapters, kohya LoRA files and int8 weights against the JAX package, on the CPU.

The tiny SDXL-layout UNet and the tiny MMDiT carry the JAX package's own
parameter trees (``jax.eval_shape`` of ``init``, filled from numpy and
loaded into the port, which raises on any leaf the trees do not share),
so the same regexes meet the same flax paths. Adapters are made by the
JAX ``LycorisAdapter.create`` (for its target specs) with factors redrawn
from numpy, and handed to the port as they are: threefry draws are not
reproduced. Tolerances, each stated where it is used: adapter deltas in
fp32 within 1e-6 of their largest element (another product order), merged
bf16 weights within one bf16 ulp, int8 values and scales bitwise, the
quantized pipeline within the serving test's 1e-4 of the latents' scale.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_models import FAST_COMPILE, compile_fast, random_params
from test_torch_serving import TE_CFGS, UNET_OVERRIDES
from uwudiff_tpu.diffusion.schedules import NoiseSchedule as JaxSchedule
from uwudiff_tpu.models.import_torch import mmdit_key_map as jax_mmdit_key_map
from uwudiff_tpu.models.mmdit import MMDiT as JaxMMDiT
from uwudiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from uwudiff_tpu.ops import quantize as jq
from uwudiff_tpu.sampling.cfg import build_cfg_fn as jax_build_cfg_fn
from uwudiff_tpu.sampling.euler import sample_euler_ancestral as jax_sample
from uwudiff_tpu.sampling.wrapper import KDiffusionDenoiser as JaxDenoiser
from uwudiff_tpu.serving import Txt2ImgPipeline as JaxPipeline
from uwudiff_tpu.training import adapters as ja
from uwudiff_tpu.training import kohya_lora as jk
from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
from uwudiff_tpu_torch.diffusion import NoiseSchedule
from uwudiff_tpu_torch.models import ConcatTextEncoders, MMDiT, SimpleTokenizer, TextEncodingPipeline
from uwudiff_tpu_torch.models import UNet2DConditionModel
from uwudiff_tpu_torch.models.import_torch import flax_path, mmdit_key_map
from uwudiff_tpu_torch.ops import quantize as tq
from uwudiff_tpu_torch.sampling import encode_cfg_inputs
from uwudiff_tpu_torch.sampling import sampling as tsampling
from uwudiff_tpu_torch.serving import BatchingServer, Request, Txt2ImgPipeline
from uwudiff_tpu_torch.training import adapters as ta
from uwudiff_tpu_torch.training import kohya_lora as tk

TOML = "configs/lycoris/sdxl-adapters.toml"
MMDIT_SWITCHES = dict(depth=3, context_pre_only=True, pos_embed_max_size=16, pos_embed_base_size=8)
CONFIGS = {
    "toml": TOML,  # LoKr on attention and feed-forward, LoRA on the rest of Transformer2DModel's match
    "lora_conv": {"targets": [{"pattern": r".*res_\d/conv\d/kernel$", "dim": 2, "alpha": 2.0},
                              {"pattern": r".*attn\d/(to_q|to_k|to_v|to_out)/kernel$", "dim": 4, "alpha": 2.0},
                              {"pattern": r".*/ff/(proj_in|proj_out)/kernel$", "dim": 3}],
                  "enable_conv": True, "multiplier": 0.7},
}


@pytest.fixture(scope="module")
def unet_pair():
    """The tiny SDXL-layout UNet's tree (the port module's, which
    ``test_quantized_pipeline_matches_jax`` runs through the JAX UNet, whose
    ``apply`` refuses any other) and the port's module holding it."""
    junet = JaxUNet.from_config("tiny_sdxl", **UNET_OVERRIDES)
    unet = UNet2DConditionModel.from_config("tiny_sdxl", device="cpu", **UNET_OVERRIDES)
    params = random_params(junet, seed=2, like=unet)
    return junet, params, load_jax_params(unet, params)


@pytest.fixture(scope="module")
def mmdit_pair():
    """The tiny MMDiT with SD3's switches (its tree JAX's, as ``test_torch_mmdit`` holds)."""
    model = MMDiT.from_config("tiny", device="cpu", **MMDIT_SWITCHES)
    params = random_params(JaxMMDiT.from_config("tiny", **MMDIT_SWITCHES), seed=3, like=model)
    return None, params, load_jax_params(model, params)


def jax_specs(params, cfg):
    """The JAX ``create``'s specs, factor shapes and multiplier, traced (no draw runs)."""
    box = {}

    def create(p):
        adapter = ja.LycorisAdapter.create(None, p, ja.build_adapter_config(cfg), jax.random.PRNGKey(0))
        box.update(specs=adapter.specs, multiplier=adapter.multiplier)
        return adapter.params

    shapes = jax.eval_shape(create, params)
    return box["specs"], shapes, box["multiplier"]


def jax_adapter(params, cfg, seed):
    """The JAX package's adapter on ``params``, every factor drawn from numpy (no zero factor)."""
    specs, shapes, multiplier = jax_specs(params, cfg)
    rng = np.random.default_rng(seed)
    return ja.LycorisAdapter(specs, {name: {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in leaves.items()}
                                     for name, leaves in shapes.items()}, multiplier)


def port_adapter(jadapter):
    """The JAX adapter's specs and factors as a port adapter."""
    params = {name: {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
              for name, leaves in jadapter.params.items()}
    return ta.LycorisAdapter(dict(jadapter.specs), params, jadapter.multiplier)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(leaves):
    """``flat``'s inverse (a leaf may be a dict: a quantized leaf's)."""
    tree = {}
    for path, v in leaves.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def port_layout(path, x):
    """A flax leaf (or its int8 values or scale) in the port's layout."""
    x = np.asarray(x)
    if path.endswith("kernel"):
        return x.T if x.ndim == 2 else x.transpose(3, 2, 0, 1)
    return x


@pytest.mark.parametrize("cfg", [TOML, {"targets": [{"pattern": r".*to_q/kernel$", "dim": 2}], "multiplier": 0.5},
                                 {"config": {"algo": "lokr", "linear_dim": 8}, "preset": {
                                     "target_module": ["Transformer2DModel", "proj_out"], "enable_conv": True}}],
                         ids=["toml", "native", "lycoris_dict"])
def test_build_adapter_config_matches_jax(cfg):
    assert dataclasses.asdict(ta.build_adapter_config(cfg)) == dataclasses.asdict(ja.build_adapter_config(cfg))
    assert all(ta._factorization(n, f) == ja._factorization(n, f) for n in (320, 640, 1280, 2048, 5120, 77)
               for f in (-1, 4, 6, 64))


@pytest.mark.parametrize("model,cfg", [("unet", "toml"), ("unet", "lora_conv"), ("mmdit", "toml")])
def test_adapted_paths_match_jax(model, cfg, unet_pair, mmdit_pair):
    """The same flax paths adapted with the same specs and factor shapes
    (``Transformer2DModel``'s pattern also takes every ``proj_in``/``proj_out``
    and block Linear); ``create``'s zero factor leaves the merge the base,
    bitwise."""
    _, params, module = unet_pair if model == "unet" else mmdit_pair
    specs, shapes, _ = jax_specs(params, CONFIGS[cfg])
    adapter = ta.LycorisAdapter.create(module, ta.build_adapter_config(CONFIGS[cfg]), torch.Generator().manual_seed(0))
    assert adapter.specs and adapter.specs == specs
    assert {k: {n: tuple(v.shape) for n, v in p.items()} for k, p in adapter.params.items()} == {
        k: {n: tuple(v.shape) for n, v in p.items()} for k, p in shapes.items()}
    state = dict(module.named_parameters())
    merged = adapter.merge(state)
    assert all(torch.equal(merged[k], v) for k, v in state.items())


MERGED = ("toml", "lora_conv")


@pytest.fixture(scope="module")
def merges(unet_pair):
    """For each config of MERGED: the JAX adapter (factors from numpy), and
    its merge into the bf16 tree and its fp32 deltas, from one program."""
    params = unet_pair[1]
    adapters = {cfg: jax_adapter(params, CONFIGS[cfg], seed=4) for cfg in MERGED}
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)

    def run(factors, base):
        out = {}
        for cfg, ja_ in adapters.items():
            a = ja.LycorisAdapter(ja_.specs, factors[cfg], ja_.multiplier)
            out[cfg] = a.merge(base), {name: a._delta(name) for name in a.specs}
        return out

    factors = {cfg: a.params for cfg, a in adapters.items()}
    out = compile_fast(run, factors, bf16)(factors, bf16)
    return {cfg: (adapters[cfg], *out[cfg]) for cfg in MERGED}


@pytest.mark.parametrize("cfg", MERGED)
def test_merge_matches_jax(cfg, unet_pair, merges):
    """Deltas in fp32 within 1e-6 of their largest element; merged bf16
    weights within one bf16 ulp of JAX's; the input state untouched."""
    unet = unet_pair[2]
    jadapter, want, deltas = merges[cfg]
    adapter = port_adapter(jadapter)
    for name, ref in deltas.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(adapter._delta(name).numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
    want = flat(want)
    state = {k: v.detach().to(torch.bfloat16) for k, v in unet.named_parameters()}
    before = {k: v.clone() for k, v in state.items()}
    merged = adapter.merge(state)
    assert all(torch.equal(state[k], before[k]) for k in state)
    for path in jadapter.specs:
        got = merged[ta.port_name(path)].float().numpy()
        ref = port_layout(path, np.asarray(want[path], np.float32))
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(got - ref) <= ulp).all(), path


def test_npz_loads_in_both_packages(unet_pair, tmp_path):
    _, params, unet = unet_pair
    jadapter = jax_adapter(params, TOML, seed=5)
    jadapter.save(str(tmp_path / "jax.npz"))
    fresh = ta.LycorisAdapter.create(unet, ta.build_adapter_config(TOML))
    loaded = fresh.load(str(tmp_path / "jax.npz"))
    adapter = port_adapter(jax_adapter(params, TOML, seed=6))
    adapter.save(str(tmp_path / "port.npz"))
    jloaded = jadapter.load(str(tmp_path / "port.npz"))
    for name, leaves in jadapter.params.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(loaded.params[name][k].numpy(), v)
            np.testing.assert_array_equal(np.asarray(jloaded.params[name][k]), adapter.params[name][k].numpy())


class _Tables(torch.nn.Module):
    """A module with an Embedding (the SDXL UNet has none), a Linear and a conv."""

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(64, 128)
        self.proj = torch.nn.Linear(128, 48)
        self.conv = torch.nn.Conv2d(16, 32, 3)
        with torch.no_grad():
            self.proj.weight[3] = 0.0  # a zero row: its scale is 0, taken as 1


@pytest.fixture(scope="module")
def quant_cases(unet_pair):
    """Each case's port module in its dtype, its flax leaves, and the JAX
    ``quantize_tree`` and ``dequantize_tree`` of the leaves JAX selects, all
    cases in one compiled program."""
    torch.manual_seed(7)
    tables = _Tables()
    cases = {"unet": (unet_pair[2], None), "tables": (tables, None), "tables_bf16": (tables, torch.bfloat16)}
    modules, leaves, picked = {}, {}, {}
    for case, (module, dtype) in cases.items():
        jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        leaves[case] = {p: jnp.asarray(x, jdtype) for p, x in flat(to_jax_params(module)).items()}
        picked[case] = {p: x for p, x in leaves[case].items() if jq._is_quantizable(x, 4096)}
        modules[case] = copy.deepcopy(module).to(dtype) if dtype is not None else copy.deepcopy(module)
    # the JAX pipeline quantizes eagerly, op by op; compiled, XLA's algebraic
    # simplifier would turn the division by the constant 127 into a product
    # with its reciprocal (one ulp off), so that pass is off here
    def quantize(t):
        q = jq.quantize_tree(t)
        return q, jq.dequantize_tree(q)

    q, deq = jax.jit(quantize).lower(picked).compile({**FAST_COMPILE, "xla_disable_hlo_passes": "algsimp"})(picked)
    return {case: (modules[case], leaves[case], q[case], deq[case]) for case in cases}


@pytest.mark.parametrize("case", ["unet", "tables", "tables_bf16"])
def test_quantize_tree_bitwise_against_jax(case, quant_cases):
    """The same leaves selected; int8 values and scales bitwise the JAX
    function's in the port's layout (Linear, Conv2d, and Embedding scaled
    per column), the dequantized bf16 weights bitwise; the byte counts
    equal; quantized in place, each weight the module reads is the
    dequantized one in the module's dtype."""
    module, leaves, jq8, jdeq = quant_cases[case]
    got = tq.quantize_tree(module)
    deq = tq.dequantize_tree(got)
    quantized = [name for name, v in got.items() if isinstance(v, dict)]
    assert quantized and sorted(flax_path(module, n) for n in quantized) == sorted(jq8)
    for name in quantized:
        path = flax_path(module, name)
        np.testing.assert_array_equal(got[name]["__q8__"].numpy(), port_layout(path, jq8[path]["__q8__"]))
        np.testing.assert_array_equal(got[name]["scale"].numpy(), port_layout(path, jq8[path]["scale"]))
        np.testing.assert_array_equal(deq[name].float().numpy(), port_layout(path, np.asarray(jdeq[path], np.float32)))
    jtree = {**{p: x for p, x in leaves.items() if p not in jq8}, **jq8}
    assert tq.quantized_bytes(got) == jq.quantized_bytes(jtree)

    dtypes = {name: p.dtype for name, p in module.named_parameters()}
    module = copy.deepcopy(module)
    assert tq.quantize_module_(module) == quantized
    assert tq.quantized_bytes(module) == tq.quantized_bytes(got)
    for name in quantized:
        owner, _, attr = name.rpartition(".")
        assert name not in dict(module.named_parameters())
        assert torch.equal(getattr(module.get_submodule(owner), attr), deq[name].to(dtypes[name]))


KOHYA = {  # per model: the adapter's targets, the JAX and the port key maps
    "unet": (CONFIGS["lora_conv"], {}, {}),  # LoCon on the resnets' convs, LoRA on attention and feed-forward
    "mmdit": ({"targets": [{"pattern": r".*(attn\d|mlp_x|mlp_ctx|t_fc\d|final_proj)/.*kernel$", "dim": 3,
                            "alpha": 1.5}]},
              {"key_map": functools.partial(jax_mmdit_key_map, depth=3)},
              {"key_map": functools.partial(mmdit_key_map, depth=3)}),
}


@pytest.mark.parametrize("model", ["unet", "mmdit"])
def test_kohya_lora_cross_packages(model, unet_pair, mmdit_pair, tmp_path):
    """Either package's kohya export, as a dict and as a ``.safetensors``
    file, imports in the other to the same factors, bitwise (so to the same
    merged weights: ``test_merge_matches_jax``); the exports are equal key
    for key. The kohya-addressable kernels are the same (no fused
    projection, no swap-halves head)."""
    _, params, module = unet_pair if model == "unet" else mmdit_pair
    cfg, jkw, tkw = KOHYA[model]
    assert tk._module_table(module, **tkw) == {k: v[0] for k, v in jk._module_table(params, **jkw).items()}
    jadapter = jax_adapter(params, cfg, seed=8)
    adapter = port_adapter(jadapter)
    jsd, sd = jk.export_kohya_lora(jadapter, params, **jkw), tk.export_kohya_lora(adapter, module, **tkw)
    assert list(sd) == list(jsd) and any(v.ndim == 4 for v in sd.values()) == (model == "unet")
    for key, v in jsd.items():
        np.testing.assert_array_equal(sd[key].numpy(), v)
    tk.save_kohya_lora(adapter, module, str(tmp_path / "port.safetensors"), **tkw)
    jk.save_kohya_lora(jadapter, params, str(tmp_path / "jax.safetensors"), **jkw)
    ports = [tk.import_kohya_lora(jsd, module, **tkw), tk.load_kohya_lora(str(tmp_path / "jax.safetensors"), module, **tkw)]
    jaxes = [jk.import_kohya_lora({k: v.numpy() for k, v in sd.items()}, params, **jkw),
             jk.load_kohya_lora(str(tmp_path / "port.safetensors"), params, **jkw)]
    for back in ports + jaxes:
        assert back.specs == jadapter.specs
        for name, leaves in jadapter.params.items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(np.asarray(back.params[name][k]), v)


@pytest.mark.parametrize("module_name,skipped_by_prefix", [
    ("lora_te_text_model_encoder_layers_0_mlp_fc1", True),  # a text tower's: outside lora_unet
    ("lora_unet_mid_block_attentions_9_to_nowhere", False),  # no such layer
    # the original LDM UNet's naming, which some community files use: neither package maps it
    ("lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q", False),
])
def test_kohya_unmatched_modules(module_name, skipped_by_prefix, unet_pair):
    """A file module outside the prefix is ignored; one that matches no
    kernel raises under ``strict`` and is skipped without it, in both."""
    _, params, module = unet_pair
    jadapter = jax_adapter(params, KOHYA["unet"][0], seed=9)
    sd = jk.export_kohya_lora(jadapter, params)
    sd.update({f"{module_name}.lora_down.weight": np.zeros((4, 64), np.float32),
               f"{module_name}.lora_up.weight": np.zeros((64, 4), np.float32), f"{module_name}.alpha": np.float32(4)})
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    for strict in (True, False):
        if strict and not skipped_by_prefix:
            with pytest.raises(KeyError):
                jk.import_kohya_lora(sd, params)
            with pytest.raises(KeyError):
                tk.import_kohya_lora(tsd, module)
            continue
        want = jk.import_kohya_lora(sd, params, strict=strict)
        got = tk.import_kohya_lora(tsd, module, strict=strict)
        assert sorted(got.specs) == sorted(want.specs) == sorted(jadapter.specs)


def test_quantized_pipeline_matches_jax(unet_pair, quant_cases, monkeypatch):
    """``Txt2ImgPipeline(quantize_weights=True)`` against the JAX
    ``Txt2ImgPipeline(quantize_weights=True)``'s UNet function on its int8
    tree, through the same CFG Euler-ancestral steps: the port's text
    conditioning (held to JAX's by ``test_torch_serving``), init and step
    noise given to both. Within 1e-4 of the latents' scale, the serving
    test's tolerance (the same bf16-rounded weights in fp32 compute)."""
    prompts, negs, seeds = ["a cat on a mat", "a dog"], ["blurry", ""], [5, 9]
    w = h = 64
    steps, cfg = 3, 5.0
    junet, params, unet = unet_pair
    torch.manual_seed(1)
    te_pipe = TextEncodingPipeline(ConcatTextEncoders.from_config(TE_CFGS, device="cpu"),
                                   [SimpleTokenizer(), SimpleTokenizer()], device="cpu")
    # the pipeline's quantize_tree (eager: a compile for each op and shape)
    # gives the tree quant_cases compiled at once, bitwise
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    monkeypatch.setattr(jq, "quantize_tree", lambda tree: unflatten({**flat(tree), **quant_cases["unet"][2]}))
    jpipe = JaxPipeline(lambda p, x, t, ctx, mask, added: junet.apply({"params": p}, x, t, ctx, mask, added),
                        None, None, JaxSchedule.sdxl(), unet_params=jparams, quantize_weights=True)
    monkeypatch.undo()
    pipe = Txt2ImgPipeline(copy.deepcopy(unet), te_pipe, None, NoiseSchedule.sdxl(), device="cpu",
                           quantize_weights=True)
    assert tq.quantized_bytes(pipe.unet)[0] == jq.quantized_bytes(jpipe.unet_params)[0] > 0
    with torch.no_grad():
        enc = encode_cfg_inputs(prompts, negs, w, h, te_pipe)
    jenc = jax.tree_util.tree_map(lambda v: v.numpy(), enc)

    sigmas = pipe.sigmas(steps)
    rng = np.random.default_rng(3)
    init = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((steps, 2, 8, 8, 4)).astype(np.float32)
    x0 = init * np.float32(np.sqrt(np.float32(1.0) + sigmas[0] ** 2))
    def jeps(x, t, **kw):
        return jpipe.unet_fn(jpipe.unet_params, x, t, kw["encoder_hidden_states"], kw["encoder_attention_mask"],
                             kw["added_cond"])

    ladder = jnp.asarray(sigmas[:-1])
    jcfg = jax_build_cfg_fn(JaxDenoiser(model_fn=jeps, schedule=JaxSchedule.sdxl()), jenc, cfg)
    sample = functools.partial(jax_sample, jcfg, noise_sampler=lambda rng_, shape, s, s_next: jnp.asarray(noise)[
        jnp.argmin(jnp.abs(ladder - s))])
    ref = np.asarray(compile_fast(sample, x0, sigmas)(x0, sigmas))

    monkeypatch.setattr(tsampling, "per_sample_init_noise", lambda *a, **k: torch.from_numpy(init))
    monkeypatch.setattr(tsampling, "make_per_sample_noise_sampler", lambda *a, **k: (
        lambda shape, s, s_next: torch.from_numpy(noise[int(np.argmin(np.abs(sigmas[:-1] - s)))])))
    out, _ = pipe.sample_device(prompts, negs, num_steps=steps, num_samples=2, cfg_scale=cfg, width=w, height=h,
                                seed=seeds, return_latents=True)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def _inputs(model):
    """A batch of 1 for the tiny UNet or MMDiT of the fixtures."""
    gen = torch.Generator().manual_seed(12)
    x, t = torch.randn((1, 8, 8, 4), generator=gen), torch.tensor([321.5])
    if model == "unet":
        return x, t, torch.randn((1, 77, 64), generator=gen), None, {
            "text_embeds": torch.randn((1, 32), generator=gen), "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]])}
    return x, t, torch.randn((1, 7, 48), generator=gen), torch.ones((1, 7), dtype=torch.int32), {
        "text_embeds": torch.randn((1, 24), generator=gen)}


@pytest.mark.parametrize("model", ["unet", "mmdit"])
def test_int8_module_reads_its_dequantized_weights(model, unet_pair, mmdit_pair):
    """A module quantized in place computes, bitwise, what the same module
    computes with its dequantized weights as parameters: every read of a
    weight (the UNet's ``conv_in`` for its dtype, the MMDiT's patch
    embedding) goes through the dequantizing property."""
    module = copy.deepcopy((unet_pair if model == "unet" else mmdit_pair)[2])
    ref = copy.deepcopy(module)
    with torch.no_grad():
        for name, w in tq.dequantize_tree(tq.quantize_tree(ref)).items():
            ref.get_parameter(name).copy_(w)
        assert tq.quantize_module_(module)
        assert torch.equal(module(*_inputs(model)), ref(*_inputs(model)))


@pytest.mark.parametrize("model", ["unet", "mmdit"])
@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_set_adapter_swaps_in_place(quantize, model, unet_pair, mmdit_pair):
    """After each swap the denoiser (the UNet, or the MMDiT that
    ``sd3_pipeline`` serves) holds ``merge`` of the base (composed in order;
    under int8 ``quantize_tree`` of it), bitwise; ``None`` restores every
    tensor bitwise; a swap to the names served writes nothing; an unknown
    name raises and changes nothing; no tensor is reallocated."""
    _, params, denoiser = unet_pair if model == "unet" else mmdit_pair
    module = copy.deepcopy(denoiser).to(torch.bfloat16)
    base = {k: v.detach().clone() for k, v in module.named_parameters()}
    pipe = Txt2ImgPipeline(module, None, None, NoiseSchedule.sdxl(), device="cpu", quantize_weights=quantize)
    assert bool(pipe._quantized) == quantize
    a = port_adapter(jax_adapter(params, TOML, 10))
    b = port_adapter(jax_adapter(params, CONFIGS["lora_conv"] if model == "unet" else KOHYA["mmdit"][0], 11))
    pipe.register_adapter("a", a).register_adapter("b", b)

    def tensors():
        return {**dict(module.named_parameters()), **dict(module.named_buffers())}

    ptrs = {k: v.data_ptr() for k, v in tensors().items()}
    start = {k: v.clone() for k, v in tensors().items()}

    def check(*adapters):
        merged = base
        for adapter in adapters:
            merged = adapter.merge(merged)
        want = tq.quantize_tree(module, merged) if quantize else merged
        held = tensors()
        for name, v in want.items():
            if isinstance(v, dict):
                owner = name[: -len("weight")]
                assert torch.equal(held[owner + "weight_q8"], v["__q8__"]), name
                assert torch.equal(held[owner + "weight_scale"], v["scale"]), name
            else:
                assert torch.equal(held[name], v), name
        assert {k: v.data_ptr() for k, v in held.items()} == ptrs

    def restored():
        return all(torch.equal(v, start[k]) for k, v in tensors().items())

    for served, adapters in (("a", [a]), ("b", [b]), (["a", "b"], [a, b]), (["b", "a"], [b, a])):
        pipe.set_adapter(served)
        check(*adapters)
        assert not restored()
    pipe.set_adapter(None)
    assert restored() and pipe._active_adapter is None
    pipe.set_adapter("a")
    versions = {k: v._version for k, v in tensors().items()}
    pipe.set_adapter("a")  # the names already served: nothing written
    assert {k: v._version for k, v in tensors().items()} == versions
    pipe.set_adapter(a)  # an adapter object always re-merges
    assert {k: v._version for k, v in tensors().items()} != versions
    check(a)
    held = {k: v.clone() for k, v in tensors().items()}
    with pytest.raises(KeyError):
        pipe.set_adapter(["a", "no_such_adapter"])
    assert all(torch.equal(v, held[k]) for k, v in tensors().items())
    pipe.set_adapter(None)
    assert restored()


class _AdapterPipeline:
    """A stand-in pipeline that records the adapters served to each call."""

    def __init__(self, known):
        self.known, self.calls, self._active_adapter = known, [], None

    def set_adapter(self, adapter=None):
        names = tuple(adapter or ())
        missing = [n for n in names if n not in self.known]
        if missing:
            raise KeyError(missing)
        self._active_adapter = names or None

    def sample_device(self, seed, num_samples, **kw):
        self.calls.append((self._active_adapter, num_samples, list(seed)))
        return torch.stack([torch.full((2, 2), float(s)) for s in seed]), False


def test_server_groups_by_adapter():
    """One group per adapter key, each served with its adapters; a base
    group after an adapted one restores the base; an unknown name fails its
    own request only."""
    pipe = _AdapterPipeline({"a", "b"})
    server = BatchingServer(pipe, buckets=[(64, 64)], max_batch=4, max_wait_s=0.1).start()
    keyed = [(None, 1), (None, 2), ("a", 3), ("a", 4), ("b", 5), (("a", "b"), 6), ("nope", 7), (None, 8)]
    try:
        futs = [server.submit(Request(prompt="p", seed=s, width=64, height=64, adapter=k)) for k, s in keyed]
        outs = [f.exception(timeout=30) or float(f.result()[0, 0]) for f in futs]
    finally:
        server.stop()
    assert isinstance(outs[6], KeyError) and outs[:6] + outs[7:] == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0]
    served = {(k,) if isinstance(k, str) else k: [] for k, _ in keyed if k != "nope"}
    for active, _, call_seeds in pipe.calls:  # a group pads with copies of its last request
        served[active] += sorted(set(call_seeds))
    assert served == {None: [1, 2, 8], ("a",): [3, 4], ("b",): [5], ("a", "b"): [6]}
