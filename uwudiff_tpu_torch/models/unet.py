"""Conditional UNet, SD1.x/SDXL class (``uwudiff_tpu/models/unet.py``).

Public layout is the JAX package's NHWC: ``sample`` ``[B, H, W, C]`` in,
``[B, H, W, C]`` fp32 out. Inside, feature maps are NCHW-logical in
channels-last memory. SDXL micro-conditioning (``text_time``) is ported;
ControlNet mode, FreeU, selective remat (``remat_policy``) and scanned
transformer stacks are not (ROADMAP.md, Queue 1 items 11 and 15). The
model computes in its parameters' dtype; it trains as it serves (the
GroupNorm and attention kernels carry their own backward).
``gradient_checkpointing`` recomputes every ResnetBlock2D and every
Transformer2DModel in the backward (``torch.utils.checkpoint``), as the
JAX module's ``nn.remat`` of those blocks does: their forwards run twice
a training step, the rest of the UNet once.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from uwudiff_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    get_timestep_embedding,
)
from uwudiff_tpu_torch.models.transformer import Transformer2DModel
from uwudiff_tpu_torch.utils import build_module

__all__ = ["UNet2DConditionModel", "UNET_PRESETS"]


def _per_block(value, n_blocks: int) -> tuple:
    if isinstance(value, (list, tuple)):
        if len(value) != n_blocks:
            raise ValueError(f"expected {n_blocks} per-block values, got {value}")
        return tuple(value)
    return (value,) * n_blocks


class UNet2DConditionModel(nn.Module):
    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 4,
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        down_block_types: Sequence[str] = (
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        layers_per_block: int = 2,
        transformer_layers_per_block: int | Sequence[int] = 1,
        num_attention_heads: int | Sequence[int] = 8,
        cross_attention_dim: int | None = 768,
        addition_embed_type: str | None = None,
        addition_time_embed_dim: int = 256,
        projection_class_embeddings_input_dim: int | None = None,
        use_linear_projection: bool = False,
        flip_sin_to_cos: bool = True,
        freq_shift: float = 0.0,
        norm_num_groups: int = 32,
        gradient_checkpointing: bool = False,
        remat_policy: str | None = None,
        scan_transformer_blocks: bool = False,
    ):
        super().__init__()
        if remat_policy is not None:
            raise NotImplementedError(f"remat_policy {remat_policy!r}: selective remat is not ported yet"
                                      " (ROADMAP.md, Queue 1 item 11)")
        if scan_transformer_blocks:
            raise NotImplementedError("scan_transformer_blocks is not ported yet (ROADMAP.md, Queue 1 item 11)")
        self.gradient_checkpointing = gradient_checkpointing
        boc = tuple(block_out_channels)
        n_blocks = len(boc)
        tf_layers = _per_block(transformer_layers_per_block, n_blocks)
        n_heads = _per_block(num_attention_heads, n_blocks)
        self.flip_sin_to_cos, self.freq_shift = flip_sin_to_cos, freq_shift
        self.addition_embed_type = addition_embed_type
        self.addition_time_embed_dim = addition_time_embed_dim
        self.cross_attention_dim = cross_attention_dim
        self.base_channels = boc[0]
        groups = norm_num_groups
        temb = boc[0] * 4

        def transformer(ch, heads, layers):
            return Transformer2DModel(
                ch, heads, ch // heads, layers, cross_attention_dim,
                use_linear_projection, groups,
            )

        self.time_embedding = TimestepEmbedding(boc[0], temb)
        if addition_embed_type == "text_time":
            if projection_class_embeddings_input_dim is None:
                raise ValueError("text_time needs projection_class_embeddings_input_dim")
            self.add_embedding = TimestepEmbedding(projection_class_embeddings_input_dim, temb)
        self.conv_in = nn.Conv2d(in_channels, boc[0], 3, padding=1)

        # (kind, name) in execution order; "skip" pushes, "cat" pops
        self.plan: list[tuple[str, str]] = []
        ch, skip_ch = boc[0], [boc[0]]
        for i, (block_type, out_ch) in enumerate(zip(down_block_types, boc)):
            for j in range(layers_per_block):
                self._add("resnet", f"down_{i}_res_{j}", ResnetBlock2D(ch, out_ch, temb, groups))
                ch = out_ch
                if block_type == "CrossAttnDownBlock2D":
                    self._add("attn", f"down_{i}_attn_{j}", transformer(ch, n_heads[i], tf_layers[i]))
                self.plan.append(("skip", ""))
                skip_ch.append(ch)
            if i < n_blocks - 1:
                self._add("plain", f"down_{i}_downsample", Downsample2D(ch, ch))
                self.plan.append(("skip", ""))
                skip_ch.append(ch)

        self._add("resnet", "mid_res_0", ResnetBlock2D(ch, ch, temb, groups))
        if cross_attention_dim is not None:
            self._add("attn", "mid_attn", transformer(ch, n_heads[-1], tf_layers[-1]))
        self._add("resnet", "mid_res_1", ResnetBlock2D(ch, ch, temb, groups))

        up_types = tuple(reversed(tuple(down_block_types)))
        for i, (block_type, out_ch) in enumerate(zip(up_types, reversed(boc))):
            heads, layers = n_heads[n_blocks - 1 - i], tf_layers[n_blocks - 1 - i]
            for j in range(layers_per_block + 1):
                self.plan.append(("cat", ""))
                in_ch = ch + skip_ch.pop()
                self._add("resnet", f"up_{i}_res_{j}", ResnetBlock2D(in_ch, out_ch, temb, groups))
                ch = out_ch
                if block_type == "CrossAttnDownBlock2D":
                    self._add("attn", f"up_{i}_attn_{j}", transformer(ch, heads, layers))
            if i < n_blocks - 1:
                self._add("plain", f"up_{i}_upsample", Upsample2D(ch, ch))

        # flax nn.GroupNorm (eps 1e-6) followed by silu: the fused kernel
        self.conv_norm_out = GroupNorm(boc[0], groups, eps=1e-6, silu=True)
        self.conv_out = nn.Conv2d(boc[0], out_channels, 3, padding=1)

    def _add(self, kind, name, module):
        self.add_module(name, module)
        self.plan.append((kind, name))

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides):
        cfg = dict(UNET_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        return build_module(cls, cfg, device, dtype)

    @property
    def dtype(self):
        return self.conv_in.weight.dtype

    def _run_block(self, block, *args):
        """``block(*args)``; with ``gradient_checkpointing`` while autograd
        records, recomputed in the backward from its inputs (the blocks draw
        no random numbers, so no RNG state is kept)."""
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(
        self,
        sample,  # [B, H, W, C]
        timesteps,  # [B] int or float
        encoder_hidden_states=None,  # [B, S, D]
        encoder_attention_mask=None,  # [B, S]
        added_cond: dict | None = None,
    ):
        dtype = self.dtype
        timesteps = torch.atleast_1d(timesteps)
        t_emb = get_timestep_embedding(
            timesteps, self.base_channels, self.flip_sin_to_cos, self.freq_shift
        ).to(dtype)
        emb = self.time_embedding(t_emb)
        if self.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("addition_embed_type='text_time' needs added_cond")
            time_ids, text_embeds = added_cond["time_ids"], added_cond["text_embeds"]
            time_ids_emb = get_timestep_embedding(
                time_ids.reshape(-1), self.addition_time_embed_dim,
                self.flip_sin_to_cos, self.freq_shift,
            ).reshape(time_ids.shape[0], -1)
            add_embeds = torch.cat([text_embeds, time_ids_emb.to(text_embeds.dtype)], dim=-1)
            emb = emb + self.add_embedding(add_embeds.to(dtype))
        ctx = encoder_hidden_states.to(dtype) if encoder_hidden_states is not None else None

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for kind, name in self.plan:
            if kind == "skip":
                skips.append(h)
            elif kind == "cat":
                h = torch.cat([h, skips.pop()], dim=1).contiguous(memory_format=torch.channels_last)
            elif kind == "resnet":
                h = self._run_block(getattr(self, name), h, emb)
            elif kind == "attn":
                h = self._run_block(getattr(self, name), h, ctx, encoder_attention_mask)
            else:
                h = getattr(self, name)(h)
        h = self.conv_out(self.conv_norm_out(h))
        return h.permute(0, 2, 3, 1).float()


UNET_PRESETS: dict[str, dict] = {
    # SD1.5-class UNet (768-dim CLIP context): head dims 40/80/160, 1x1-conv
    # transformer projections, no addition embedding
    "sd15": dict(
        in_channels=4,
        out_channels=4,
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        layers_per_block=2,
        transformer_layers_per_block=1,
        num_attention_heads=8,
        cross_attention_dim=768,
        use_linear_projection=False,
    ),
    # SDXL-base-class UNet (2048-dim dual-CLIP context + micro-conditioning)
    "sdxl": dict(
        in_channels=4,
        out_channels=4,
        block_out_channels=(320, 640, 1280),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        layers_per_block=2,
        transformer_layers_per_block=(1, 2, 10),
        num_attention_heads=(5, 10, 20),
        cross_attention_dim=2048,
        addition_embed_type="text_time",
        addition_time_embed_dim=256,
        projection_class_embeddings_input_dim=2816,
        use_linear_projection=True,
    ),
    # Tiny UNet for tests
    "tiny": dict(
        in_channels=4,
        out_channels=4,
        block_out_channels=(32, 64),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=1,
        num_attention_heads=2,
        cross_attention_dim=32,
        use_linear_projection=False,
        norm_num_groups=8,
    ),
    # Tiny SDXL-like (exercises the text_time addition embedding)
    "tiny_sdxl": dict(
        in_channels=4,
        out_channels=4,
        block_out_channels=(32, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=1,
        num_attention_heads=2,
        cross_attention_dim=32,
        addition_embed_type="text_time",
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=64,  # pooled 16 + 6*8
        use_linear_projection=True,
        norm_num_groups=8,
    ),
}
