"""Torch checkpoints into the port's modules (``uwudiff_tpu/models/import_torch.py``).

Reads local ``.safetensors`` (the port's own memory-mapped reader: the
8-byte little-endian header length, the JSON header, each tensor a
``torch.frombuffer`` view of the mapped file, so no ``safetensors``
package and no host copy) and ``.pt``/``.bin``/``.ckpt`` files
(``torch.load(weights_only=True, mmap=True)``), always as torch tensors: a
BF16 file has no numpy form, and an fp32 copy of SDXL would take ~14 GB of
host memory.

The key maps are the JAX package's rule tables, over the flax paths the
port's parameter names stand for (``a.b.weight`` of a Linear or Conv2d is
``a/b/kernel``, of an Embedding ``a/b/embedding``, of a norm ``a/b/scale``;
``convert.py``). Each rule gives a torch key and a transform named as the
JAX one, but acting in torch layout: the JAX transform composed with
``convert.py``'s flip. A transposed Linear or Conv2d weight flips back,
so ``_t_linear``, ``_t_conv``, ``_identity`` and ``"proj"`` (a 1x1 conv or
a Linear, by the file's rank) hand over the file's tensor itself, a view;
``_SplitLinear`` a slice of a fused tensor, also a view;
``_t_concat_linear`` and the modulation-order swaps
(``_t_swap_halves_linear``, ``_swap_halves``) a new tensor. Each leaf is
copied once, into the module's parameter (dtype and device are the
module's). ``export_params`` is the inverse: a module -> a torch-named
state dict.

The ControlNet, CLIP-vision and Inception maps are not ported: no module
of the port uses them (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import re
import struct
import time
from typing import Callable

import numpy as np
import torch

__all__ = [
    "clip_text_key_map",
    "dit_key_map",
    "export_params",
    "extract_state_dict",
    "flax_path",
    "flux_key_map",
    "import_params",
    "load_torch_state_dict",
    "mmdit_key_map",
    "t5_key_map",
    "unet_key_map",
    "vae_key_map",
]

# safetensors' dtype names
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """A ``.safetensors`` file -> (tensors, ``__metadata__``). Each tensor is
    a read-only-in-effect view of the file mapped copy-on-write: pages are
    read when a tensor is first touched, and nothing is written back."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    start = 8 + n
    mapped = np.memmap(path, dtype=np.uint8, mode="c") if header else None
    out = {}
    for key, info in header.items():
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape, count = tuple(info["shape"]), end - begin
        out[key] = (torch.frombuffer(mapped, dtype=dtype, count=count // dtype.itemsize, offset=start + begin)
                    .view(shape) if count else torch.empty(shape, dtype=dtype))
    return out, metadata


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A torch checkpoint's tensors, on the CPU, in the file's dtypes."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)[0]
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:  # a legacy (non-zip) file cannot be mapped
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def extract_state_dict(state_dict: dict, key: str | None = None, prefix: str | None = None) -> dict:
    """The sub-dict under ``key``, then the entries under ``prefix`` with it stripped."""
    if key is not None:
        state_dict = state_dict[key]
    if prefix is None:
        return state_dict
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


# --- transforms: the JAX package's, composed with the flax -> torch flip ---


def _t_linear(w):  # [out, in] file -> Linear.weight [out, in]
    return w


def _t_conv(w):  # OIHW file -> Conv2d.weight OIHW
    return w


def _identity(w):
    return w


def _t_concat_linear(ws):  # N x [out, in] -> [N * out, in]
    return torch.cat(list(ws), dim=0)


class _SplitLinear:
    """One torch tensor stacked along dim 0 feeding several leaves (a fused
    ``qkv.weight [3D, D]`` into separate q/k/v): part ``j`` of ``n``, a view."""

    def __init__(self, n: int, j: int):
        self.n, self.j = n, j

    def __call__(self, w):
        return w.chunk(self.n, dim=0)[self.j]


def _t_swap_halves_linear(w):
    """The two output halves swapped: diffusers' scale-first
    ``AdaLayerNormContinuous`` against the shift-first modulation heads."""
    a, b = w.chunk(2, dim=0)
    return torch.cat([b, a], dim=0)


def _swap_halves(w):  # the bias's (its own inverse)
    a, b = w.chunk(2, dim=0)
    return torch.cat([b, a], dim=0)


# --- path translation rules (the JAX package's tables) ---
# each rule: (regex on the flax "/"-joined path, torch key template, transform)

_UNET_RULES: list[tuple[str, str, Callable | None]] = [
    (r"^conv_in/kernel$", "conv_in.weight", _t_conv),
    (r"^conv_in/bias$", "conv_in.bias", _identity),
    (r"^conv_out/kernel$", "conv_out.weight", _t_conv),
    (r"^conv_out/bias$", "conv_out.bias", _identity),
    (r"^conv_norm_out/scale$", "conv_norm_out.weight", _identity),
    (r"^conv_norm_out/bias$", "conv_norm_out.bias", _identity),
    (r"^time_embedding/linear_(\d)/kernel$", r"time_embedding.linear_\1.weight", _t_linear),
    (r"^time_embedding/linear_(\d)/bias$", r"time_embedding.linear_\1.bias", _identity),
    (r"^add_embedding/linear_(\d)/kernel$", r"add_embedding.linear_\1.weight", _t_linear),
    (r"^add_embedding/linear_(\d)/bias$", r"add_embedding.linear_\1.bias", _identity),
    (r"^down_(\d+)_res_(\d+)/", r"down_blocks.\1.resnets.\2.", None),
    (r"^up_(\d+)_res_(\d+)/", r"up_blocks.\1.resnets.\2.", None),
    (r"^mid_res_(\d+)/", r"mid_block.resnets.\1.", None),
    (r"^down_(\d+)_attn_(\d+)/", r"down_blocks.\1.attentions.\2.", None),
    (r"^up_(\d+)_attn_(\d+)/", r"up_blocks.\1.attentions.\2.", None),
    (r"^mid_attn/", r"mid_block.attentions.0.", None),
    (r"^down_(\d+)_downsample/", r"down_blocks.\1.downsamplers.0.", None),
    (r"^up_(\d+)_upsample/", r"up_blocks.\1.upsamplers.0.", None),
]

# fused projections: one leaf gathers several torch tensors
_FUSED_LEAF_RULES: list[tuple[str, list[str], Callable]] = [
    (r"(.*\.)blocks_(\d+)/attn(\d)/to_qkv/kernel$",
     [r"\1transformer_blocks.\2.attn\3.to_q.weight", r"\1transformer_blocks.\2.attn\3.to_k.weight",
      r"\1transformer_blocks.\2.attn\3.to_v.weight"], _t_concat_linear),
    (r"(.*\.)blocks_(\d+)/attn(\d)/to_kv/kernel$",
     [r"\1transformer_blocks.\2.attn\3.to_k.weight", r"\1transformer_blocks.\2.attn\3.to_v.weight"],
     _t_concat_linear),
]

# within-module leaves (after the block-prefix rewrite)
_LEAF_RULES: list[tuple[str, str, Callable | None]] = [
    (r"(.*\.)norm(\d)/scale$", r"\1norm\2.weight", _identity),
    (r"(.*\.)norm(\d)/bias$", r"\1norm\2.bias", _identity),
    (r"(.*\.)conv(\d)/kernel$", r"\1conv\2.weight", _t_conv),
    (r"(.*\.)conv(\d)/bias$", r"\1conv\2.bias", _identity),
    (r"(.*\.)conv_shortcut/kernel$", r"\1conv_shortcut.weight", _t_conv),
    (r"(.*\.)conv_shortcut/bias$", r"\1conv_shortcut.bias", _identity),
    (r"(.*\.)time_emb_proj/kernel$", r"\1time_emb_proj.weight", _t_linear),
    (r"(.*\.)time_emb_proj/bias$", r"\1time_emb_proj.bias", _identity),
    (r"(.*\.)conv/kernel$", r"\1conv.weight", _t_conv),
    (r"(.*\.)conv/bias$", r"\1conv.bias", _identity),
    (r"(.*\.)norm/scale$", r"\1norm.weight", _identity),
    (r"(.*\.)norm/bias$", r"\1norm.bias", _identity),
    (r"(.*\.)proj_in/kernel$", r"\1proj_in.weight", None),  # conv or linear
    (r"(.*\.)proj_in/bias$", r"\1proj_in.bias", _identity),
    (r"(.*\.)proj_out/kernel$", r"\1proj_out.weight", None),
    (r"(.*\.)proj_out/bias$", r"\1proj_out.bias", _identity),
    (r"(.*\.)blocks_(\d+)/norm(\d)/scale$", r"\1transformer_blocks.\2.norm\3.weight", _identity),
    (r"(.*\.)blocks_(\d+)/norm(\d)/bias$", r"\1transformer_blocks.\2.norm\3.bias", _identity),
    (r"(.*\.)blocks_(\d+)/attn(\d)/to_(q|k|v)/kernel$", r"\1transformer_blocks.\2.attn\3.to_\4.weight", _t_linear),
    (r"(.*\.)blocks_(\d+)/attn(\d)/to_out/kernel$", r"\1transformer_blocks.\2.attn\3.to_out.0.weight", _t_linear),
    (r"(.*\.)blocks_(\d+)/attn(\d)/to_out/bias$", r"\1transformer_blocks.\2.attn\3.to_out.0.bias", _identity),
    (r"(.*\.)blocks_(\d+)/ff/proj_in/kernel$", r"\1transformer_blocks.\2.ff.net.0.proj.weight", _t_linear),
    (r"(.*\.)blocks_(\d+)/ff/proj_in/bias$", r"\1transformer_blocks.\2.ff.net.0.proj.bias", _identity),
    (r"(.*\.)blocks_(\d+)/ff/proj_out/kernel$", r"\1transformer_blocks.\2.ff.net.2.weight", _t_linear),
    (r"(.*\.)blocks_(\d+)/ff/proj_out/bias$", r"\1transformer_blocks.\2.ff.net.2.bias", _identity),
]


def unet_key_map(our_path: str, use_linear_projection: bool = True):
    """A UNet flax path -> (diffusers key, transform)."""
    path = our_path
    for pat, repl, tr in _UNET_RULES:
        if re.match(pat, path):
            if repl.endswith("."):  # block-prefix rewrite; the leaf rules follow
                path = re.sub(pat, repl, path)
                break
            return re.sub(pat, repl, path), tr
    for pat, repls, tr in _FUSED_LEAF_RULES:
        if re.match(pat, path):
            return [re.sub(pat, r, path) for r in repls], tr
    for pat, repl, tr in _LEAF_RULES:
        if re.match(pat, path):
            return re.sub(pat, repl, path), "proj" if tr is None else tr
    raise KeyError(f"no torch mapping for UNet param {our_path!r}")


_CLIP_RULES = [
    (r"^token_embedding/embedding$", "text_model.embeddings.token_embedding.weight", _identity),
    (r"^position_embedding$", "text_model.embeddings.position_embedding.weight", _identity),
    (r"^final_layer_norm/scale$", "text_model.final_layer_norm.weight", _identity),
    (r"^final_layer_norm/bias$", "text_model.final_layer_norm.bias", _identity),
    (r"^text_projection/kernel$", "text_projection.weight", _t_linear),
    (r"^layers_(\d+)/layer_norm(\d)/scale$", r"text_model.encoder.layers.\1.layer_norm\2.weight", _identity),
    (r"^layers_(\d+)/layer_norm(\d)/bias$", r"text_model.encoder.layers.\1.layer_norm\2.bias", _identity),
    (r"^layers_(\d+)/(q|k|v|out)_proj/kernel$", r"text_model.encoder.layers.\1.self_attn.\2_proj.weight", _t_linear),
    (r"^layers_(\d+)/(q|k|v|out)_proj/bias$", r"text_model.encoder.layers.\1.self_attn.\2_proj.bias", _identity),
    (r"^layers_(\d+)/fc(\d)/kernel$", r"text_model.encoder.layers.\1.mlp.fc\2.weight", _t_linear),
    (r"^layers_(\d+)/fc(\d)/bias$", r"text_model.encoder.layers.\1.mlp.fc\2.bias", _identity),
]


def clip_text_key_map(our_path: str):
    """CLIP text tower -> HF ``CLIPTextModel(WithProjection)`` keys."""
    for pat, repl, tr in _CLIP_RULES:
        if re.match(pat, our_path):
            return re.sub(pat, repl, our_path), tr
    raise KeyError(f"no torch mapping for CLIP param {our_path!r}")


_T5_RULES = [
    (r"^token_embedding/embedding$", "shared.weight", _identity),
    (r"^relative_attention_bias/embedding$",
     "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", _identity),
    (r"^final_norm/scale$", "encoder.final_layer_norm.weight", _identity),
    (r"^layers_(\d+)/attn_norm/scale$", r"encoder.block.\1.layer.0.layer_norm.weight", _identity),
    (r"^layers_(\d+)/(q|k|v|o)/kernel$", r"encoder.block.\1.layer.0.SelfAttention.\2.weight", _t_linear),
    (r"^layers_(\d+)/ff_norm/scale$", r"encoder.block.\1.layer.1.layer_norm.weight", _identity),
    (r"^layers_(\d+)/(wi_0|wi_1|wo)/kernel$", r"encoder.block.\1.layer.1.DenseReluDense.\2.weight", _t_linear),
]


def t5_key_map(our_path: str):
    """T5 encoder -> HF ``T5EncoderModel`` keys."""
    for pat, repl, tr in _T5_RULES:
        if re.match(pat, our_path):
            return re.sub(pat, repl, our_path), tr
    raise KeyError(f"no torch mapping for T5 param {our_path!r}")


# facebookresearch-DiT naming; its ``pos_embed`` is recomputed, not imported
_DIT_RULES: list[tuple[str, str, Callable]] = [
    (r"^patch_embed/kernel$", "x_embedder.proj.weight", _t_conv),
    (r"^patch_embed/bias$", "x_embedder.proj.bias", _identity),
    (r"^t_fc1/kernel$", "t_embedder.mlp.0.weight", _t_linear),
    (r"^t_fc1/bias$", "t_embedder.mlp.0.bias", _identity),
    (r"^t_fc2/kernel$", "t_embedder.mlp.2.weight", _t_linear),
    (r"^t_fc2/bias$", "t_embedder.mlp.2.bias", _identity),
    (r"^label_embed/embedding$", "y_embedder.embedding_table.weight", _identity),
    (r"^blocks_(\d+)/adaLN_modulation/kernel$", r"blocks.\1.adaLN_modulation.1.weight", _t_linear),
    (r"^blocks_(\d+)/adaLN_modulation/bias$", r"blocks.\1.adaLN_modulation.1.bias", _identity),
    (r"^blocks_(\d+)/q/(kernel|bias)$", r"blocks.\1.attn.qkv.{leaf}", _SplitLinear(3, 0)),
    (r"^blocks_(\d+)/k/(kernel|bias)$", r"blocks.\1.attn.qkv.{leaf}", _SplitLinear(3, 1)),
    (r"^blocks_(\d+)/v/(kernel|bias)$", r"blocks.\1.attn.qkv.{leaf}", _SplitLinear(3, 2)),
    (r"^blocks_(\d+)/proj/kernel$", r"blocks.\1.attn.proj.weight", _t_linear),
    (r"^blocks_(\d+)/proj/bias$", r"blocks.\1.attn.proj.bias", _identity),
    (r"^blocks_(\d+)/mlp_fc(\d)/kernel$", r"blocks.\1.mlp.fc\2.weight", _t_linear),
    (r"^blocks_(\d+)/mlp_fc(\d)/bias$", r"blocks.\1.mlp.fc\2.bias", _identity),
    (r"^final_modulation/kernel$", "final_layer.adaLN_modulation.1.weight", _t_linear),
    (r"^final_modulation/bias$", "final_layer.adaLN_modulation.1.bias", _identity),
    (r"^final_proj/kernel$", "final_layer.linear.weight", _t_linear),
    (r"^final_proj/bias$", "final_layer.linear.bias", _identity),
]


def dit_key_map(our_path: str):
    """DiT -> facebookresearch-DiT keys."""
    for pat, repl, tr in _DIT_RULES:
        if re.match(pat, our_path):
            key = re.sub(pat, repl, our_path)
            if "{leaf}" in key:
                key = key.replace("{leaf}", "weight" if our_path.endswith("kernel") else "bias")
            return key, tr
    raise KeyError(f"no torch mapping for DiT param {our_path!r}")


# diffusers SD3Transformer2DModel top-level keys; its baked ``pos_embed`` is recomputed
_MMDIT_TOP_RULES: list[tuple[str, str, Callable]] = [
    (r"^patch_embed/kernel$", "pos_embed.proj.weight", _t_conv),
    (r"^patch_embed/bias$", "pos_embed.proj.bias", _identity),
    (r"^context_embedder/kernel$", "context_embedder.weight", _t_linear),
    (r"^context_embedder/bias$", "context_embedder.bias", _identity),
    (r"^t_fc1/kernel$", "time_text_embed.timestep_embedder.linear_1.weight", _t_linear),
    (r"^t_fc1/bias$", "time_text_embed.timestep_embedder.linear_1.bias", _identity),
    (r"^t_fc2/kernel$", "time_text_embed.timestep_embedder.linear_2.weight", _t_linear),
    (r"^t_fc2/bias$", "time_text_embed.timestep_embedder.linear_2.bias", _identity),
    (r"^pool_fc1/kernel$", "time_text_embed.text_embedder.linear_1.weight", _t_linear),
    (r"^pool_fc1/bias$", "time_text_embed.text_embedder.linear_1.bias", _identity),
    (r"^pool_fc2/kernel$", "time_text_embed.text_embedder.linear_2.weight", _t_linear),
    (r"^pool_fc2/bias$", "time_text_embed.text_embedder.linear_2.bias", _identity),
    # norm_out is AdaLayerNormContinuous: scale-first, so the halves swap
    (r"^final_modulation/kernel$", "norm_out.linear.weight", _t_swap_halves_linear),
    (r"^final_modulation/bias$", "norm_out.linear.bias", _swap_halves),
    (r"^final_proj/kernel$", "proj_out.weight", _t_linear),
    (r"^final_proj/bias$", "proj_out.bias", _identity),
]

# within a joint block: attn1 the image stream, attn2 the context stream
_MMDIT_BLOCK_LEAVES: list[tuple[str, str, Callable]] = [
    (r"^adaLN_x/kernel$", "norm1.linear.weight", _t_linear),
    (r"^adaLN_x/bias$", "norm1.linear.bias", _identity),
    (r"^adaLN_ctx/kernel$", "norm1_context.linear.weight", _t_linear),
    (r"^adaLN_ctx/bias$", "norm1_context.linear.bias", _identity),
    (r"^attn1/to_(q|k|v)/kernel$", r"attn.to_\1.weight", _t_linear),
    (r"^attn1/to_(q|k|v)/bias$", r"attn.to_\1.bias", _identity),
    (r"^attn1/to_out/kernel$", "attn.to_out.0.weight", _t_linear),
    (r"^attn1/to_out/bias$", "attn.to_out.0.bias", _identity),
    (r"^attn1/norm_(q|k)/scale$", r"attn.norm_\1.weight", _identity),
    (r"^attn2/to_q/kernel$", "attn.add_q_proj.weight", _t_linear),
    (r"^attn2/to_q/bias$", "attn.add_q_proj.bias", _identity),
    (r"^attn2/to_k/kernel$", "attn.add_k_proj.weight", _t_linear),
    (r"^attn2/to_k/bias$", "attn.add_k_proj.bias", _identity),
    (r"^attn2/to_v/kernel$", "attn.add_v_proj.weight", _t_linear),
    (r"^attn2/to_v/bias$", "attn.add_v_proj.bias", _identity),
    (r"^attn2/to_out/kernel$", "attn.to_add_out.weight", _t_linear),
    (r"^attn2/to_out/bias$", "attn.to_add_out.bias", _identity),
    (r"^attn2/norm_(q|k)/scale$", r"attn.norm_added_\1.weight", _identity),
    (r"^mlp_x/fc1/kernel$", "ff.net.0.proj.weight", _t_linear),
    (r"^mlp_x/fc1/bias$", "ff.net.0.proj.bias", _identity),
    (r"^mlp_x/fc2/kernel$", "ff.net.2.weight", _t_linear),
    (r"^mlp_x/fc2/bias$", "ff.net.2.bias", _identity),
    (r"^mlp_ctx/fc1/kernel$", "ff_context.net.0.proj.weight", _t_linear),
    (r"^mlp_ctx/fc1/bias$", "ff_context.net.0.proj.bias", _identity),
    (r"^mlp_ctx/fc2/kernel$", "ff_context.net.2.weight", _t_linear),
    (r"^mlp_ctx/fc2/bias$", "ff_context.net.2.bias", _identity),
]


def _block_leaf(prefix: str, rest: str, leaves):
    for pat, repl, tr in leaves:
        if re.match(pat, rest):
            return prefix + re.sub(pat, repl, rest), tr
    return None


def mmdit_key_map(our_path: str, depth: int | None = None):
    """MMDiT -> diffusers ``SD3Transformer2DModel`` keys. ``depth`` places
    ``final_block`` (``context_pre_only``) at torch index ``depth - 1``; its
    ``adaLN_ctx`` is scale-first as the torch one, so no halves swap."""
    for pat, repl, tr in _MMDIT_TOP_RULES:
        if re.match(pat, our_path):
            return re.sub(pat, repl, our_path), tr
    m = re.match(r"^(blocks_(\d+)|final_block)/(.*)$", our_path)
    if m:
        if m.group(1) == "final_block":
            if depth is None:
                raise KeyError(f"mmdit_key_map needs depth= to place {our_path!r}"
                               " (final_block maps to transformer_blocks.depth-1)")
            idx = depth - 1
        else:
            idx = int(m.group(2))
        hit = _block_leaf(f"transformer_blocks.{idx}.", m.group(3), _MMDIT_BLOCK_LEAVES)
        if hit:
            return hit
    raise KeyError(f"no torch mapping for MMDiT param {our_path!r}")


# diffusers FluxTransformer2DModel top-level keys; its final head is
# scale-first as the torch one, so no halves swap
_FLUX_TOP_RULES: list[tuple[str, str, Callable]] = [
    (r"^x_embedder/kernel$", "x_embedder.weight", _t_linear),
    (r"^x_embedder/bias$", "x_embedder.bias", _identity),
    (r"^context_embedder/kernel$", "context_embedder.weight", _t_linear),
    (r"^context_embedder/bias$", "context_embedder.bias", _identity),
    (r"^t_fc1/kernel$", "time_text_embed.timestep_embedder.linear_1.weight", _t_linear),
    (r"^t_fc1/bias$", "time_text_embed.timestep_embedder.linear_1.bias", _identity),
    (r"^t_fc2/kernel$", "time_text_embed.timestep_embedder.linear_2.weight", _t_linear),
    (r"^t_fc2/bias$", "time_text_embed.timestep_embedder.linear_2.bias", _identity),
    (r"^g_fc1/kernel$", "time_text_embed.guidance_embedder.linear_1.weight", _t_linear),
    (r"^g_fc1/bias$", "time_text_embed.guidance_embedder.linear_1.bias", _identity),
    (r"^g_fc2/kernel$", "time_text_embed.guidance_embedder.linear_2.weight", _t_linear),
    (r"^g_fc2/bias$", "time_text_embed.guidance_embedder.linear_2.bias", _identity),
    (r"^pool_fc1/kernel$", "time_text_embed.text_embedder.linear_1.weight", _t_linear),
    (r"^pool_fc1/bias$", "time_text_embed.text_embedder.linear_1.bias", _identity),
    (r"^pool_fc2/kernel$", "time_text_embed.text_embedder.linear_2.weight", _t_linear),
    (r"^pool_fc2/bias$", "time_text_embed.text_embedder.linear_2.bias", _identity),
    (r"^final_modulation/kernel$", "norm_out.linear.weight", _t_linear),
    (r"^final_modulation/bias$", "norm_out.linear.bias", _identity),
    (r"^final_proj/kernel$", "proj_out.weight", _t_linear),
    (r"^final_proj/bias$", "proj_out.bias", _identity),
]

# single-stream block leaves (FluxSingleTransformerBlock)
_FLUX_SINGLE_LEAVES: list[tuple[str, str, Callable]] = [
    (r"^adaLN/kernel$", "norm.linear.weight", _t_linear),
    (r"^adaLN/bias$", "norm.linear.bias", _identity),
    (r"^attn1/to_(q|k|v)/kernel$", r"attn.to_\1.weight", _t_linear),
    (r"^attn1/to_(q|k|v)/bias$", r"attn.to_\1.bias", _identity),
    (r"^attn1/norm_(q|k)/scale$", r"attn.norm_\1.weight", _identity),
    (r"^proj_mlp/kernel$", "proj_mlp.weight", _t_linear),
    (r"^proj_mlp/bias$", "proj_mlp.bias", _identity),
    (r"^proj_out/kernel$", "proj_out.weight", _t_linear),
    (r"^proj_out/bias$", "proj_out.bias", _identity),
]


def flux_key_map(our_path: str):
    """Flux -> diffusers ``FluxTransformer2DModel`` keys; the double-stream
    blocks share the SD3 joint block's leaf names."""
    for pat, repl, tr in _FLUX_TOP_RULES:
        if re.match(pat, our_path):
            return re.sub(pat, repl, our_path), tr
    m = re.match(r"^single_blocks_(\d+)/(.*)$", our_path)
    if m:
        hit = _block_leaf(f"single_transformer_blocks.{int(m.group(1))}.", m.group(2), _FLUX_SINGLE_LEAVES)
        if hit:
            return hit
    m = re.match(r"^blocks_(\d+)/(.*)$", our_path)
    if m:
        hit = _block_leaf(f"transformer_blocks.{int(m.group(1))}.", m.group(2), _MMDIT_BLOCK_LEAVES)
        if hit:
            return hit
    raise KeyError(f"no torch mapping for Flux param {our_path!r}")


_VAE_RULES = [
    (r"^quant_conv/kernel$", "quant_conv.weight", _t_conv),
    (r"^quant_conv/bias$", "quant_conv.bias", _identity),
    (r"^post_quant_conv/kernel$", "post_quant_conv.weight", _t_conv),
    (r"^post_quant_conv/bias$", "post_quant_conv.bias", _identity),
    (r"^(encoder|decoder)/conv_in/", r"\1.conv_in.", None),
    (r"^(encoder|decoder)/conv_out/", r"\1.conv_out.", None),
    (r"^(encoder|decoder)/conv_norm_out/", r"\1.conv_norm_out.", None),
    (r"^encoder/down_(\d+)_res_(\d+)/", r"encoder.down_blocks.\1.resnets.\2.", None),
    (r"^encoder/down_(\d+)_downsample/conv/", r"encoder.down_blocks.\1.downsamplers.0.conv.", None),
    (r"^decoder/up_(\d+)_res_(\d+)/", r"decoder.up_blocks.\1.resnets.\2.", None),
    (r"^decoder/up_(\d+)_upsample/conv/", r"decoder.up_blocks.\1.upsamplers.0.conv.", None),
    (r"^(encoder|decoder)/mid_res_(\d+)/", r"\1.mid_block.resnets.\2.", None),
    (r"^(encoder|decoder)/mid_attn/", r"\1.mid_block.attentions.0.", None),
]

_VAE_LEAF_RULES = _LEAF_RULES + [
    (r"(.*\.)group_norm/scale$", r"\1group_norm.weight", _identity),
    (r"(.*\.)group_norm/bias$", r"\1group_norm.bias", _identity),
    (r"(.*\.)to_(q|k|v|out)/kernel$", r"\1to_\2.weight", _t_linear),
    (r"(.*\.)to_(q|k|v)/bias$", r"\1to_\2.bias", _identity),
    (r"(.*\.)to_out/bias$", r"\1to_out.0.bias", _identity),
    (r"(.*\.)conv_in\.kernel$", r"\1conv_in.weight", _t_conv),
]


def vae_key_map(our_path: str):
    """VAE -> diffusers ``AutoencoderKL`` keys."""
    path = our_path
    for pat, repl, tr in _VAE_RULES:
        if re.match(pat, path):
            if repl.endswith("."):
                path = re.sub(pat, repl, path)
                break
            return re.sub(pat, repl, path), tr
    # the mid attention's norm is diffusers' group_norm, its to_out to_out.0
    if ".attentions." in path:
        path = path.replace("norm/scale", "group_norm/scale").replace("norm/bias", "group_norm/bias")
    for pat, repl, tr in _VAE_LEAF_RULES:
        if re.match(pat, path):
            key = re.sub(pat, repl, path)
            if key.endswith("to_out.weight"):
                key = key.replace("to_out.weight", "to_out.0.weight")
            return key, tr or _t_conv
    # plain conv/norm leaves after a prefix rewrite ("." once a rule rewrote the path)
    for suffix, torch_suffix, tr in (("kernel", "weight", _t_conv), ("scale", "weight", _identity),
                                     ("bias", "bias", _identity)):
        if path.endswith("/" + suffix) or path.endswith("." + suffix):
            return path[: -len(suffix) - 1].replace("/", ".") + "." + torch_suffix, tr
    raise KeyError(f"no torch mapping for VAE param {our_path!r}")


# --- import / export over a module ---


def flax_path(module: torch.nn.Module, name: str) -> str:
    """The flax path a parameter name of the port stands for: a Linear's or
    Conv2d's ``weight`` is ``kernel``, an Embedding's ``embedding``, a
    norm's 1-D ``weight`` ``scale``."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        owner = module.get_submodule(".".join(mods))
        if isinstance(owner, (torch.nn.Linear, torch.nn.Conv2d)):
            leaf = "kernel"
        elif isinstance(owner, torch.nn.Embedding):
            leaf = "embedding"
        elif getattr(owner, "weight").dim() == 1:
            leaf = "scale"
        else:
            raise ValueError(f"{name}: no flax name for a {type(owner).__name__} weight")
    return "/".join([*mods, leaf])


def _resolve(module, state_dict, key_map, strict):
    """[(param, source tensor, torch keys)] for every parameter the state
    dict holds; the missing and the unmapped."""
    plan, missing = [], []
    for name, param in module.named_parameters():
        our = flax_path(module, name)
        try:
            torch_key, tr = key_map(our)
        except KeyError:
            if strict:
                raise
            continue
        keys = list(torch_key) if isinstance(torch_key, (list, tuple)) else [torch_key]
        if any(k not in state_dict for k in keys):
            missing.append(keys[0])
            continue
        if isinstance(torch_key, (list, tuple)):
            w = tr([state_dict[k] for k in keys])
        else:
            w = state_dict[torch_key]
            w = w if tr == "proj" else tr(w)  # a 1x1 conv or a Linear, as the file and the module hold it
        if tuple(w.shape) != tuple(param.shape):
            raise ValueError(f"shape mismatch for {name} <- {torch_key}: {tuple(w.shape)} vs {tuple(param.shape)}")
        plan.append((param, w, keys))
    if strict and missing:
        raise KeyError(f"missing torch keys: {missing[:10]}...")
    return plan


def import_params(module: torch.nn.Module, state_dict: dict, key_map: Callable, strict: bool = True,
                  timings: dict | None = None) -> set[str]:
    """Fill ``module``'s parameters from a torch-named ``state_dict`` in
    place, one copy a leaf, into the module's dtype and device. ``strict``
    raises on a parameter the map or the file lacks; otherwise it keeps its
    value. Returns the state dict keys it consumed. ``timings`` gains the
    seconds of the name mapping (``map``) and of the copies (``copy``)."""
    t0 = time.perf_counter()
    plan = _resolve(module, state_dict, key_map, strict)
    t1 = time.perf_counter()
    with torch.no_grad():
        for param, w, _ in plan:
            param.copy_(w)
    if any(p.is_cuda for p, _, _ in plan):
        torch.cuda.synchronize()
    if timings is not None:
        timings["map"] = timings.get("map", 0.0) + t1 - t0
        timings["copy"] = timings.get("copy", 0.0) + time.perf_counter() - t1
    return {k for _, _, keys in plan for k in keys}


def export_params(module: torch.nn.Module, key_map: Callable, dtype: torch.dtype | None = None
                  ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`import_params`: ``module`` -> a torch-named state
    dict of new contiguous tensors (in ``dtype``, default the module's) on
    the module's device. Fused leaves split back into their torch keys,
    ``_SplitLinear`` parts concatenate into their one tensor."""
    out: dict[str, torch.Tensor] = {}
    pending: dict[str, list] = {}

    def fresh(w):
        return w.detach().to(dtype=dtype or w.dtype, memory_format=torch.contiguous_format, copy=True)

    for name, param in module.named_parameters():
        torch_key, tr = key_map(flax_path(module, name))
        if isinstance(torch_key, (list, tuple)):  # a fused concat, split
            for key, part in zip(torch_key, param.chunk(len(torch_key), dim=0)):
                out[key] = fresh(part)
        elif isinstance(tr, _SplitLinear):
            pending.setdefault(torch_key, [None] * tr.n)[tr.j] = param
        elif tr in (_t_linear, _t_conv, _identity, "proj"):
            out[torch_key] = fresh(param)
        elif tr in (_t_swap_halves_linear, _swap_halves):  # their own inverses
            out[torch_key] = fresh(tr(param.detach()))
        else:
            raise ValueError(f"no inverse for transform {tr!r} of {name} -> {torch_key}")
    for torch_key, parts in pending.items():
        if any(p is None for p in parts):
            raise ValueError(f"incomplete fused export for {torch_key}: missing parts")
        out[torch_key] = fresh(torch.cat([p.detach() for p in parts], dim=0))
    return out
