"""Single-file LDM/A1111 checkpoints (``uwudiff_tpu/models/ldm_checkpoint.py``).

Most community Stable Diffusion checkpoints are one ``.safetensors`` /
``.ckpt`` file in the CompVis/Stability "LDM" naming
(``model.diffusion_model.*`` UNet, ``first_stage_model.*`` VAE,
``cond_stage_model.*`` / ``conditioner.embedders.*`` text encoders). This
module renames that layout to the diffusers naming the key maps of
``import_torch.py`` read, and back, on torch tensors (views where it can).

Everything is a rename but three conventions:

- the VAE mid-block attention: LDM's q/k/v/proj_out are 1x1 convs
  ``[C, C, 1, 1]``, diffusers' Linears ``[C, C]`` (a reshape);
- OpenCLIP text towers (SD2.x ``cond_stage_model.model.*``, SDXL
  ``conditioner.embedders.1.model.*``): the fused ``attn.in_proj_weight``
  ``[3D, D]`` splits into q/k/v, ``ln_1/ln_2/c_fc/c_proj`` rename to HF,
  and the bare ``text_projection`` matrix (applied as ``x @ P``)
  transposes into an HF Linear weight, while its ``.weight`` form does not;
- ``position_ids`` / ``model_ema`` / ``logit_scale`` entries are dropped.

The UNet's block indices (LDM's flat ``input_blocks.N`` against diffusers'
``down_blocks.i.resnets.j``) are derived from the key set by classifying
each sub-layer, so any layers-per-block and attention placement maps.
"""

from __future__ import annotations

import re
from typing import Any

import torch

__all__ = [
    "is_ldm_checkpoint",
    "split_ldm_checkpoint",
    "ldm_unet_to_diffusers",
    "diffusers_unet_to_ldm",
    "ldm_vae_to_diffusers",
    "diffusers_vae_to_ldm",
    "openclip_text_to_hf",
    "hf_text_to_openclip",
    "ldm_to_diffusers",
    "diffusers_to_ldm",
]


# ---------------------------------------------------------------------
# layout detection / component split
# ---------------------------------------------------------------------

_UNET_PREFIX = "model.diffusion_model."
_VAE_PREFIX = "first_stage_model."
# (prefix, already_hf) per architecture generation
_TE_PREFIXES = [
    ("cond_stage_model.transformer.", True),  # SD1.x (HF CLIP-L inside)
    ("cond_stage_model.model.", False),  # SD2.x (OpenCLIP-H)
    ("conditioner.embedders.0.transformer.", True),  # SDXL TE1 (CLIP-L)
    ("conditioner.embedders.1.model.", False),  # SDXL TE2 (OpenCLIP-bigG)
]


def is_ldm_checkpoint(sd: dict) -> bool:
    """True if the state dict uses the single-file LDM layout."""
    return any(k.startswith(_UNET_PREFIX) for k in sd)


def _strip(sd: dict, prefix: str) -> dict:
    return {
        k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
    }


def split_ldm_checkpoint(sd: dict) -> dict[str, Any]:
    """Partition a single-file checkpoint into raw (still LDM-named)
    component dicts: ``unet``, ``vae``, ``text_encoders`` (a list of
    ``(subdict, already_hf)`` in conditioning order)."""
    out: dict[str, Any] = {
        "unet": _strip(sd, _UNET_PREFIX),
        "vae": _strip(sd, _VAE_PREFIX),
        "text_encoders": [],
    }
    for prefix, is_hf in _TE_PREFIXES:
        sub = _strip(sd, prefix)
        if sub:
            out["text_encoders"].append((sub, is_hf))
    return out


# ---------------------------------------------------------------------
# UNet: model.diffusion_model.* <-> diffusers UNet2DConditionModel
# ---------------------------------------------------------------------

# sub-layer-internal renames (same both directions, applied per pair)
_RESNET_LEAVES = [
    ("in_layers.0.", "norm1."),
    ("in_layers.2.", "conv1."),
    ("emb_layers.1.", "time_emb_proj."),
    ("out_layers.0.", "norm2."),
    ("out_layers.3.", "conv2."),
    ("skip_connection.", "conv_shortcut."),
]


def _sub_layers(keys, prefix_re):
    """Group keys by the ``{i}.{j}`` indices under e.g. input_blocks."""
    groups: dict[tuple[int, int], list[str]] = {}
    for k in keys:
        m = re.match(prefix_re, k)
        if m:
            groups.setdefault(
                (int(m.group(1)), int(m.group(2))), []
            ).append(k)
    return groups


def _classify(rest_keys: list[str]) -> str:
    joined = " ".join(rest_keys)
    if "in_layers" in joined:
        return "resnet"
    if "transformer_blocks" in joined or "proj_in" in joined:
        return "attention"
    if ".op." in joined or joined.startswith("op."):
        return "downsample"
    return "upsample"  # bare conv.{weight,bias}


def _rename_resnet(rest: str) -> str:
    for ldm, diff in _RESNET_LEAVES:
        if rest.startswith(ldm):
            return diff + rest[len(ldm):]
    raise KeyError(f"unrecognized LDM resnet leaf {rest!r}")


def _rename_resnet_inv(rest: str) -> str:
    for ldm, diff in _RESNET_LEAVES:
        if rest.startswith(diff):
            return ldm + rest[len(diff):]
    raise KeyError(f"unrecognized diffusers resnet leaf {rest!r}")


def _unet_table_from_ldm(keys) -> dict[str, str]:
    """{ldm_key: diffusers_key} for a UNet key set, structure inferred
    by classifying every flat ``input/middle/output_blocks`` sub-layer.

    LDM numbers layers flatly and consecutively: a down block's layers
    are ``input_blocks.N`` runs ending in a downsample (the deepest
    block has none); up blocks are fixed-size runs whose LAST member
    carries the upsample (the final block has none), so the per-block
    size is the distance to the first upsample-bearing index + 1."""
    table: dict[str, str] = {}
    for ldm, diff in [
        ("time_embed.0.", "time_embedding.linear_1."),
        ("time_embed.2.", "time_embedding.linear_2."),
        ("label_emb.0.0.", "add_embedding.linear_1."),
        ("label_emb.0.2.", "add_embedding.linear_2."),
        ("input_blocks.0.0.", "conv_in."),
        ("out.0.", "conv_norm_out."),
        ("out.2.", "conv_out."),
    ]:
        for k in keys:
            if k.startswith(ldm):
                table[k] = diff + k[len(ldm):]
    for ldm, diff, resnet in [
        ("middle_block.0.", "mid_block.resnets.0.", True),
        ("middle_block.1.", "mid_block.attentions.0.", False),
        ("middle_block.2.", "mid_block.resnets.1.", True),
    ]:
        for k in keys:
            if k.startswith(ldm):
                rest = k[len(ldm):]
                table[k] = diff + (_rename_resnet(rest) if resnet else rest)

    def kinds(section, skip_zero):
        groups = _sub_layers(keys, rf"^{section}\.(\d+)\.(\d+)\.(.+)$")
        flat: dict[int, dict] = {}
        for (i, j) in sorted(groups):
            if skip_zero and i == 0:
                continue
            plen = len(f"{section}.{i}.{j}.")
            rests = [k[plen:] for k in groups[(i, j)]]
            flat.setdefault(i, {})[j] = (_classify(rests), groups[(i, j)])
        return flat

    def rest_of(k, i, j):
        return k.split(f".{i}.{j}.", 1)[1]

    # --- down path: a new block starts after each downsample.
    din = kinds("input_blocks", skip_zero=True)
    bi = ri = 0
    for i in sorted(din):
        if any(kind == "downsample" for kind, _ in din[i].values()):
            for j, (kind, ks) in din[i].items():
                for k in ks:
                    table[k] = (f"down_blocks.{bi}.downsamplers.0.conv." +
                                rest_of(k, i, j).split("op.", 1)[1])
            bi += 1
            ri = 0
            continue
        for j in sorted(din[i]):
            kind, ks = din[i][j]
            if kind == "resnet":
                for k in ks:
                    table[k] = (f"down_blocks.{bi}.resnets.{ri}." +
                                _rename_resnet(rest_of(k, i, j)))
            elif kind == "attention":
                for k in ks:
                    table[k] = (f"down_blocks.{bi}.attentions.{ri}." +
                                rest_of(k, i, j))
        ri += 1

    # --- up path: fixed-size runs; upsampler rides the run's last slot.
    dout = kinds("output_blocks", skip_zero=False)
    ups = [
        i for i in sorted(dout)
        if any(kind == "upsample" for kind, _ in dout[i].values())
    ]
    per_block = (ups[0] + 1) if ups else len(dout)
    for i in sorted(dout):
        bi, ri = divmod(i, per_block)
        for j in sorted(dout[i]):
            kind, ks = dout[i][j]
            if kind == "resnet":
                for k in ks:
                    table[k] = (f"up_blocks.{bi}.resnets.{ri}." +
                                _rename_resnet(rest_of(k, i, j)))
            elif kind == "attention":
                for k in ks:
                    table[k] = (f"up_blocks.{bi}.attentions.{ri}." +
                                rest_of(k, i, j))
            else:  # upsample
                for k in ks:
                    table[k] = (f"up_blocks.{bi}.upsamplers.0." +
                                rest_of(k, i, j))
    return table


def ldm_unet_to_diffusers(sd: dict) -> dict:
    """Rename a ``model.diffusion_model``-stripped UNet state dict to
    diffusers ``UNet2DConditionModel`` naming."""
    table = _unet_table_from_ldm(sd.keys())
    missing = [k for k in sd if k not in table]
    if missing:
        raise KeyError(f"unmapped LDM UNet keys: {missing[:5]}")
    return {table[k]: v for k, v in sd.items()}


def _unet_table_from_diffusers(keys) -> dict[str, str]:
    """{ldm_key: diffusers_key} built by replaying LDM's flat layer
    numbering over a diffusers key set (for export)."""
    keys = list(keys)
    table: dict[str, str] = {}
    for ldm, diff in [
        ("time_embed.0.", "time_embedding.linear_1."),
        ("time_embed.2.", "time_embedding.linear_2."),
        ("label_emb.0.0.", "add_embedding.linear_1."),
        ("label_emb.0.2.", "add_embedding.linear_2."),
        ("input_blocks.0.0.", "conv_in."),
        ("out.0.", "conv_norm_out."),
        ("out.2.", "conv_out."),
    ]:
        for k in keys:
            if k.startswith(diff):
                table["%s%s" % (ldm, k[len(diff):])] = k

    def block_struct(section):
        """per diffusers block index: (n_resnets, has_attn, has_sampler)"""
        st: dict[int, dict] = {}
        pat = re.compile(
            rf"^{section}_blocks\.(\d+)\.(resnets|attentions|downsamplers|"
            rf"upsamplers)\.(\d+)\."
        )
        for k in keys:
            m = pat.match(k)
            if m:
                b = st.setdefault(int(m.group(1)), {
                    "resnets": set(), "attentions": set(), "sampler": False
                })
                if m.group(2) in ("downsamplers", "upsamplers"):
                    b["sampler"] = True
                else:
                    b[m.group(2)].add(int(m.group(3)))
        return st

    def emit(dst_prefix, src_prefix, resnet=False):
        for k in keys:
            if k.startswith(src_prefix):
                rest = k[len(src_prefix):]
                table[dst_prefix + (_rename_resnet_inv(rest) if resnet
                                    else rest)] = k

    # down path: flat index starts at 1 (0 is conv_in)
    st = block_struct("down")
    flat = 1
    for b in sorted(st):
        for r in sorted(st[b]["resnets"]):
            emit(f"input_blocks.{flat}.0.",
                 f"down_blocks.{b}.resnets.{r}.", resnet=True)
            if r in st[b]["attentions"]:
                emit(f"input_blocks.{flat}.1.",
                     f"down_blocks.{b}.attentions.{r}.")
            flat += 1
        if st[b]["sampler"]:
            emit(f"input_blocks.{flat}.0.op.",
                 f"down_blocks.{b}.downsamplers.0.conv.")
            flat += 1

    emit("middle_block.0.", "mid_block.resnets.0.", resnet=True)
    emit("middle_block.1.", "mid_block.attentions.0.")
    emit("middle_block.2.", "mid_block.resnets.1.", resnet=True)

    st = block_struct("up")
    flat = 0
    for b in sorted(st):
        for r in sorted(st[b]["resnets"]):
            emit(f"output_blocks.{flat}.0.",
                 f"up_blocks.{b}.resnets.{r}.", resnet=True)
            sub = 1
            if r in st[b]["attentions"]:
                emit(f"output_blocks.{flat}.1.",
                     f"up_blocks.{b}.attentions.{r}.")
                sub = 2
            if st[b]["sampler"] and r == max(st[b]["resnets"]):
                emit(f"output_blocks.{flat}.{sub}.",
                     f"up_blocks.{b}.upsamplers.0.")
            flat += 1
    return table


def diffusers_unet_to_ldm(sd: dict) -> dict:
    table = _unet_table_from_diffusers(sd.keys())
    inv = {v: k for k, v in table.items()}
    missing = [k for k in sd if k not in inv]
    if missing:
        raise KeyError(f"unmapped diffusers UNet keys: {missing[:5]}")
    return {inv[k]: v for k, v in sd.items()}


# ---------------------------------------------------------------------
# VAE: first_stage_model.* <-> diffusers AutoencoderKL
# ---------------------------------------------------------------------

_VAE_ATTN_LEAVES = [  # (ldm, diffusers, needs [C,C,1,1]<->[C,C] reshape)
    ("norm.", "group_norm.", False),
    ("q.", "to_q.", True),
    ("k.", "to_k.", True),
    ("v.", "to_v.", True),
    ("proj_out.", "to_out.0.", True),
]


def _vae_up_count(keys) -> int:
    n = -1
    for k in keys:
        m = re.match(r"^decoder\.up\.(\d+)\.", k)
        if m:
            n = max(n, int(m.group(1)))
        m = re.match(r"^decoder\.up_blocks\.(\d+)\.", k)
        if m:
            n = max(n, int(m.group(1)))
    return n + 1


def _vae_table(keys, from_ldm: bool):
    """[(ldm_key, diffusers_key, reshape_attn)] covering the key set."""
    nup = _vae_up_count(keys)
    pairs = []
    fixed = [
        ("quant_conv.", "quant_conv."),
        ("post_quant_conv.", "post_quant_conv."),
        ("encoder.conv_in.", "encoder.conv_in."),
        ("encoder.conv_out.", "encoder.conv_out."),
        ("encoder.norm_out.", "encoder.conv_norm_out."),
        ("decoder.conv_in.", "decoder.conv_in."),
        ("decoder.conv_out.", "decoder.conv_out."),
        ("decoder.norm_out.", "decoder.conv_norm_out."),
    ]
    re_pairs = [
        (r"^encoder\.down\.(\d+)\.block\.(\d+)\.",
         lambda m: f"encoder.down_blocks.{m.group(1)}.resnets.{m.group(2)}."),
        (r"^encoder\.down\.(\d+)\.downsample\.conv\.",
         lambda m: f"encoder.down_blocks.{m.group(1)}.downsamplers.0.conv."),
        (r"^decoder\.up\.(\d+)\.block\.(\d+)\.",
         lambda m: f"decoder.up_blocks.{nup - 1 - int(m.group(1))}"
                   f".resnets.{m.group(2)}."),
        (r"^decoder\.up\.(\d+)\.upsample\.conv\.",
         lambda m: f"decoder.up_blocks.{nup - 1 - int(m.group(1))}"
                   f".upsamplers.0.conv."),
        (r"^(encoder|decoder)\.mid\.block_(\d)\.",
         lambda m: f"{m.group(1)}.mid_block.resnets.{int(m.group(2)) - 1}."),
    ]
    inv_re_pairs = [
        (r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.",
         lambda m: f"encoder.down.{m.group(1)}.block.{m.group(2)}."),
        (r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.",
         lambda m: f"encoder.down.{m.group(1)}.downsample.conv."),
        (r"^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.",
         lambda m: f"decoder.up.{nup - 1 - int(m.group(1))}"
                   f".block.{m.group(2)}."),
        (r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.",
         lambda m: f"decoder.up.{nup - 1 - int(m.group(1))}.upsample.conv."),
        (r"^(encoder|decoder)\.mid_block\.resnets\.(\d)\.",
         lambda m: f"{m.group(1)}.mid.block_{int(m.group(2)) + 1}."),
    ]
    attn_re = (r"^(encoder|decoder)\.mid\.attn_1\." if from_ldm
               else r"^(encoder|decoder)\.mid_block\.attentions\.0\.")
    for k in keys:
        hit = False
        for src, dst in ([(a, b) for a, b in fixed] if from_ldm
                         else [(b, a) for a, b in fixed]):
            if k.startswith(src):
                rest = k[len(src):]
                # LDM VAE resnets use the same norm1/conv1/... names as
                # diffusers except nin_shortcut
                pairs.append((k, dst + rest) if from_ldm
                             else (dst + rest, k))
                hit = True
                break
        if hit:
            continue
        m = re.match(attn_re, k)
        if m:
            rest = k[m.end():]
            for ldm_leaf, diff_leaf, reshape in _VAE_ATTN_LEAVES:
                src_leaf = ldm_leaf if from_ldm else diff_leaf
                if rest.startswith(src_leaf):
                    tail = rest[len(src_leaf):]
                    ldm_k = (f"{m.group(1)}.mid.attn_1." + ldm_leaf + tail)
                    diff_k = (f"{m.group(1)}.mid_block.attentions.0." +
                              diff_leaf + tail)
                    pairs.append((ldm_k, diff_k, reshape))
                    hit = True
                    break
        if hit:
            continue
        for pat, repl in (re_pairs if from_ldm else inv_re_pairs):
            m = re.match(pat, k)
            if m:
                rest = k[m.end():]
                if from_ldm:
                    diff_rest = (
                        "conv_shortcut." + rest[len("nin_shortcut."):]
                        if rest.startswith("nin_shortcut.") else rest)
                    pairs.append((k, repl(m) + diff_rest))
                else:
                    ldm_rest = (
                        "nin_shortcut." + rest[len("conv_shortcut."):]
                        if rest.startswith("conv_shortcut.") else rest)
                    pairs.append((repl(m) + ldm_rest, k))
                hit = True
                break
        if not hit:
            raise KeyError(f"unmapped VAE key {k!r}")
    # normalize to 3-tuples
    return [p if len(p) == 3 else (p[0], p[1], False) for p in pairs]


def ldm_vae_to_diffusers(sd: dict) -> dict:
    out = {}
    for ldm_k, diff_k, reshape in _vae_table(sd.keys(), from_ldm=True):
        v = sd[ldm_k]
        if reshape and v.dim() == 4:
            v = v.reshape(v.shape[0], v.shape[1])
        out[diff_k] = v
    return out


def diffusers_vae_to_ldm(sd: dict) -> dict:
    out = {}
    for ldm_k, diff_k, reshape in _vae_table(sd.keys(), from_ldm=False):
        v = sd[diff_k]
        if reshape and v.dim() == 2:
            v = v.reshape(v.shape[0], v.shape[1], 1, 1)
        out[ldm_k] = v
    return out


# ---------------------------------------------------------------------
# OpenCLIP text towers <-> HF CLIPTextModel(WithProjection)
# ---------------------------------------------------------------------


def openclip_text_to_hf(sd: dict) -> dict:
    """``cond_stage_model.model.``-stripped OpenCLIP text weights ->
    HF ``CLIPTextModel(WithProjection)`` naming (the layout
    ``clip_text_key_map`` imports)."""
    out: dict[str, Any] = {}
    fixed = {
        "token_embedding.weight":
            "text_model.embeddings.token_embedding.weight",
        "positional_embedding":
            "text_model.embeddings.position_embedding.weight",
        "ln_final.weight": "text_model.final_layer_norm.weight",
        "ln_final.bias": "text_model.final_layer_norm.bias",
    }
    for k, v in sd.items():
        if k in fixed:
            out[fixed[k]] = v
            continue
        if k == "logit_scale":
            continue
        if k == "text_projection":
            # bare parameter matrix applied as x @ P; the HF Linear
            # weight is its transpose
            out["text_projection.weight"] = v.t()
            continue
        if k == "text_projection.weight":
            # open_clip sometimes saves it wrapped as a Linear already
            # — that form is [proj, d] and needs no transpose
            out[k] = v
            continue
        m = re.match(r"^transformer\.resblocks\.(\d+)\.(.+)$", k)
        if not m:
            if k.endswith("attn_mask") or k.endswith("position_ids"):
                continue
            raise KeyError(f"unmapped OpenCLIP key {k!r}")
        i, rest = m.group(1), m.group(2)
        base = f"text_model.encoder.layers.{i}."
        if rest.startswith("attn.in_proj_"):
            kind = rest.split("attn.in_proj_", 1)[1]  # weight | bias
            q, kk, vv = v.chunk(3, dim=0)
            for name, part in (("q", q), ("k", kk), ("v", vv)):
                out[base + f"self_attn.{name}_proj.{kind}"] = part
            continue
        leaf_map = {
            "ln_1.": "layer_norm1.",
            "ln_2.": "layer_norm2.",
            "attn.out_proj.": "self_attn.out_proj.",
            "mlp.c_fc.": "mlp.fc1.",
            "mlp.c_proj.": "mlp.fc2.",
        }
        for src, dst in leaf_map.items():
            if rest.startswith(src):
                out[base + dst + rest[len(src):]] = v
                break
        else:
            raise KeyError(f"unmapped OpenCLIP resblock leaf {k!r}")
    return out


def hf_text_to_openclip(sd: dict) -> dict:
    """Inverse of :func:`openclip_text_to_hf` (for single-file export).
    Fuses q/k/v back into ``attn.in_proj_*`` and transposes
    ``text_projection`` back to the bare-matrix convention."""
    out: dict[str, Any] = {}
    fixed = {
        "text_model.embeddings.token_embedding.weight":
            "token_embedding.weight",
        "text_model.embeddings.position_embedding.weight":
            "positional_embedding",
        "text_model.final_layer_norm.weight": "ln_final.weight",
        "text_model.final_layer_norm.bias": "ln_final.bias",
    }
    pending: dict[str, dict[str, Any]] = {}
    for k, v in sd.items():
        if k in fixed:
            out[fixed[k]] = v
            continue
        if k == "text_projection.weight":
            out["text_projection"] = v.t()
            continue
        if k.endswith("position_ids"):
            continue
        m = re.match(r"^text_model\.encoder\.layers\.(\d+)\.(.+)$", k)
        if not m:
            raise KeyError(f"unmapped HF CLIP key {k!r}")
        i, rest = m.group(1), m.group(2)
        base = f"transformer.resblocks.{i}."
        m2 = re.match(r"^self_attn\.([qkv])_proj\.(weight|bias)$", rest)
        if m2:
            pending.setdefault(base + "attn.in_proj_" + m2.group(2), {})[
                m2.group(1)] = v
            continue
        leaf_map = {
            "layer_norm1.": "ln_1.",
            "layer_norm2.": "ln_2.",
            "self_attn.out_proj.": "attn.out_proj.",
            "mlp.fc1.": "mlp.c_fc.",
            "mlp.fc2.": "mlp.c_proj.",
        }
        for src, dst in leaf_map.items():
            if rest.startswith(src):
                out[base + dst + rest[len(src):]] = v
                break
        else:
            raise KeyError(f"unmapped HF CLIP leaf {k!r}")
    for key, parts in pending.items():
        out[key] = torch.cat([parts["q"], parts["k"], parts["v"]], dim=0)
    return out


# ---------------------------------------------------------------------
# whole-checkpoint conversion
# ---------------------------------------------------------------------


def ldm_to_diffusers(sd: dict, only: str | None = None) -> dict[str, Any]:
    """Full single-file checkpoint -> diffusers-named component dicts:
    ``{"unet": ..., "vae": ..., "text_encoders": [...]}`` (components
    absent from the file are empty/omitted). ``only`` restricts the
    conversion to one of ``unet``/``vae``/``text_encoders`` — an SDXL
    pipeline loading 4 components from one file would otherwise
    re-convert everything (incl. the copying OpenCLIP in_proj splits)
    per component load."""
    parts = split_ldm_checkpoint(sd)
    out: dict[str, Any] = {}
    if parts["unet"] and only in (None, "unet"):
        out["unet"] = ldm_unet_to_diffusers(parts["unet"])
    if parts["vae"] and only in (None, "vae"):
        out["vae"] = ldm_vae_to_diffusers(parts["vae"])
    if only in (None, "text_encoders"):
        tes = []
        for sub, is_hf in parts["text_encoders"]:
            if is_hf:
                tes.append({k: v for k, v in sub.items()
                            if not k.endswith("position_ids")})
            else:
                tes.append(openclip_text_to_hf(sub))
        if tes:
            out["text_encoders"] = tes
    return out


def diffusers_to_ldm(
    unet: dict | None = None,
    vae: dict | None = None,
    text_encoders: list[dict] | None = None,
    arch: str = "auto",
) -> dict:
    """Bundle diffusers-named component dicts into ONE single-file LDM
    state dict (A1111/ComfyUI loadable). ``arch``: ``sd1`` (HF CLIP-L
    under ``cond_stage_model.transformer``), ``sd2`` (OpenCLIP under
    ``cond_stage_model.model``), ``sdxl`` (CLIP-L + OpenCLIP-bigG under
    ``conditioner.embedders.{0,1}``), or ``auto`` (sdxl iff two TEs,
    else sd1)."""
    if arch == "auto":
        if text_encoders and len(text_encoders) > 1:
            arch = "sdxl"
        elif text_encoders:
            # single TE: distinguish SD1 (CLIP-L, hidden 768 / 12
            # layers) from SD2 (OpenCLIP-H, hidden 1024 / 23 layers) —
            # defaulting SD2 exports to sd1 would write HF-named CLIP
            # keys a single-file SD2 loader can't read
            te = text_encoders[0]
            emb = te.get("text_model.embeddings.token_embedding.weight")
            hidden = None if emb is None else int(emb.shape[-1])
            n_layers = len({
                k.split(".")[3]
                for k in te
                if k.startswith("text_model.encoder.layers.")
            })
            arch = "sd2" if (hidden or 0) > 768 or n_layers > 12 else "sd1"
    out: dict[str, Any] = {}
    if unet:
        for k, v in diffusers_unet_to_ldm(unet).items():
            out[_UNET_PREFIX + k] = v
    if vae:
        for k, v in diffusers_vae_to_ldm(vae).items():
            out[_VAE_PREFIX + k] = v
    for idx, te in enumerate(text_encoders or []):
        if arch == "sd1":
            prefix, convert = "cond_stage_model.transformer.", False
        elif arch == "sd2":
            prefix, convert = "cond_stage_model.model.", True
        elif arch == "sdxl":
            prefix = f"conditioner.embedders.{idx}."
            convert = idx == 1
            prefix += "model." if convert else "transformer."
        else:
            raise ValueError(f"unknown arch {arch!r}")
        sub = hf_text_to_openclip(te) if convert else te
        for k, v in sub.items():
            out[prefix + k] = v
    # the transposes and splits above are views: a writer takes the raw
    # buffer, so the bundle is made contiguous
    return {k: v.contiguous() for k, v in out.items()}
