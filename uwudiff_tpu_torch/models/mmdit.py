"""MMDiT, the SD3-class multimodal diffusion transformer
(``uwudiff_tpu/models/mmdit.py``).

Dual-stream joint attention: image tokens and text tokens keep their own
projections, MLPs and adaLN-Zero modulation and attend over the
concatenated [text; image] sequence in every block. ``context_pre_only``
makes the last block's text stream feed keys and values only (SD3's
released architecture); ``pos_embed_max_size`` gives SD3's centre-cropped
position grid. Public layout is the JAX package's NHWC: ``sample``
``[B, H, W, C]`` in, ``[B, H, W, C]`` fp32 out. Attribute names are the
flax module names (``blocks_{i}``, ``attn1``/``attn2``, ``adaLN_x``, ...)
so ``convert.load_jax_params`` loads a JAX tree, scanned or not.

As in the JAX module, the adaLN modulations and the final projection are
zero-initialised, which cuts the gradient from the output to the context
until they are trained or loaded. ``skip_layers`` bypasses joint blocks
for skip-layer guidance (SD3.5's recipe): the constructor's are the
module's default, and ``forward(skip_layers=...)`` runs the same weights
with others bypassed, so the degraded model of
``sampling/cfg.py::build_slg_cfg_fn`` is ``functools.partial(model,
skip_layers=(7, 8, 9))``, with no second copy of the parameters (the JAX
package clones the module). MoE, ``scan_blocks``, gradient checkpointing
and ``apply_block`` are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from uwudiff_tpu_torch.models.dit import _2d_sincos_pos_embed
from uwudiff_tpu_torch.models.layers import RMSNorm, _layer_norm, _modulation, _zero_linear, get_timestep_embedding
from uwudiff_tpu_torch.ops.attention import attention_bias_from_mask, dot_product_attention
from uwudiff_tpu_torch.utils import build_module

__all__ = ["MMDiT", "MMDiTBlock", "MMDIT_PRESETS"]

_UNPORTED = ("num_experts", "gradient_checkpointing", "scan_blocks")


class _StreamAttention(nn.Module):
    """One stream's q/k/v/out projections and per-head RMSNorm on q and k;
    ``pre_only`` drops the output projection."""

    def __init__(self, hidden_size, num_heads, qk_norm=True, pre_only=False):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.to_q = nn.Linear(hidden_size, hidden_size)
        self.to_k = nn.Linear(hidden_size, hidden_size)
        self.to_v = nn.Linear(hidden_size, hidden_size)
        if not pre_only:
            self.to_out = nn.Linear(hidden_size, hidden_size)
        self.qk_norm = qk_norm
        if qk_norm:
            self.norm_q = RMSNorm(hidden_size // num_heads)
            self.norm_k = RMSNorm(hidden_size // num_heads)

    def qkv(self, h):
        b, s, _ = h.shape
        shape = (b, s, self.num_heads, self.hidden_size // self.num_heads)
        q, k, v = self.to_q(h).view(shape), self.to_k(h).view(shape), self.to_v(h).view(shape)
        if self.qk_norm:
            q, k = self.norm_q(q), self.norm_k(k)
        return q, k, v

    def out(self, attn):
        b, s = attn.shape[:2]
        return self.to_out(attn.reshape(b, s, self.hidden_size))


class _MLP(nn.Module):
    def __init__(self, hidden_size, mlp_ratio=4.0):
        super().__init__()
        inner = int(hidden_size * mlp_ratio)
        self.fc1 = nn.Linear(hidden_size, inner)
        self.fc2 = nn.Linear(inner, hidden_size)

    def forward(self, h):
        return self.fc2(F.gelu(self.fc1(h), approximate="tanh"))


class MMDiTBlock(nn.Module):
    """Dual-stream joint-attention block: ``attn1``/``mlp_x`` for the image
    stream, ``attn2``/``mlp_ctx`` for the text stream. The modulation order
    is shift, scale, gate; a ``context_pre_only`` block's text stream takes
    a 2-vector scale-first modulation, no gates, no output path."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0, qk_norm=True, context_pre_only=False):
        super().__init__()
        self.context_pre_only = context_pre_only
        self.adaLN_x = _zero_linear(hidden_size, 6 * hidden_size)
        self.adaLN_ctx = _zero_linear(hidden_size, (2 if context_pre_only else 6) * hidden_size)
        self.attn1 = _StreamAttention(hidden_size, num_heads, qk_norm)
        self.attn2 = _StreamAttention(hidden_size, num_heads, qk_norm, pre_only=context_pre_only)
        self.mlp_x = _MLP(hidden_size, mlp_ratio)
        if not context_pre_only:
            self.mlp_ctx = _MLP(hidden_size, mlp_ratio)

    def forward(self, x, ctx, c, joint_bias=None):
        sx_a, scx_a, gx_a, sx_m, scx_m, gx_m = _modulation(self.adaLN_x, c, 6)
        if self.context_pre_only:
            scc_a, sc_a = _modulation(self.adaLN_ctx, c, 2)
        else:
            sc_a, scc_a, gc_a, sc_m, scc_m, gc_m = _modulation(self.adaLN_ctx, c, 6)
        qx, kx, vx = self.attn1.qkv(_layer_norm(x) * (1 + scx_a) + sx_a)
        qc, kc, vc = self.attn2.qkv(_layer_norm(ctx) * (1 + scc_a) + sc_a)
        attn = dot_product_attention(  # joint sequence [text; image]
            torch.cat([qc, qx], dim=1), torch.cat([kc, kx], dim=1), torch.cat([vc, vx], dim=1),
            bias=joint_bias,
        )
        t = ctx.shape[1]
        x = x + gx_a * self.attn1.out(attn[:, t:])
        if not self.context_pre_only:
            ctx = ctx + gc_a * self.attn2.out(attn[:, :t])
        x = x + gx_m * self.mlp_x(_layer_norm(x) * (1 + scx_m) + sx_m)
        if not self.context_pre_only:
            ctx = ctx + gc_m * self.mlp_ctx(_layer_norm(ctx) * (1 + scc_m) + sc_m)
        return x, ctx


class MMDiT(nn.Module):
    """SD3-class multimodal diffusion transformer."""

    addition_embed_type = "pooled_text"  # pooled text via added_cond["text_embeds"]

    def __init__(
        self,
        patch_size: int = 2,
        hidden_size: int = 1536,
        depth: int = 24,
        num_heads: int = 24,
        mlp_ratio: float = 4.0,
        in_channels: int = 16,
        context_dim: int = 4096,
        pooled_dim: int = 2048,
        qk_norm: bool = True,
        context_pre_only: bool = False,
        pos_embed_max_size: int | None = None,
        pos_embed_base_size: int | None = None,
        skip_layers: tuple[int, ...] = (),  # joint blocks bypassed by default; never the context_pre_only one
    ):
        super().__init__()
        self.skip_layers = tuple(skip_layers)
        self.depth = depth  # the importer's: final_block is the file's block depth - 1
        self.patch_size, self.hidden_size, self.in_channels = patch_size, hidden_size, in_channels
        self.pos_embed_max_size, self.pos_embed_base_size = pos_embed_max_size, pos_embed_base_size
        self.patch_embed = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)
        self.context_embedder = nn.Linear(context_dim, hidden_size)
        self.t_fc1 = nn.Linear(256, hidden_size)
        self.t_fc2 = nn.Linear(hidden_size, hidden_size)
        self.pool_fc1 = nn.Linear(pooled_dim, hidden_size)
        self.pool_fc2 = nn.Linear(hidden_size, hidden_size)
        n_blocks = depth - 1 if context_pre_only else depth
        self.block_names = [f"blocks_{i}" for i in range(n_blocks)]
        for name in self.block_names:
            self.add_module(name, MMDiTBlock(hidden_size, num_heads, mlp_ratio, qk_norm))
        if context_pre_only:
            self.final_block = MMDiTBlock(hidden_size, num_heads, mlp_ratio, qk_norm, context_pre_only=True)
        self.final_modulation = _zero_linear(hidden_size, 2 * hidden_size)
        self.final_proj = _zero_linear(hidden_size, patch_size * patch_size * in_channels)
        self._pos_cache: dict = {}

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides):
        cfg = dict(MMDIT_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        for key in _UNPORTED:
            if cfg.pop(key, None):
                raise NotImplementedError(f"MMDiT {key} is not ported yet (ROADMAP.md, Queue 1)")
        return build_module(cls, cfg, device, dtype)

    def _pos_embed(self, gh, gw, device, dtype):
        key = (gh, gw, device, dtype)
        pos = self._pos_cache.get(key)
        if pos is None:
            if self.pos_embed_max_size:
                # the centre crop of the baked max-size grid: sin-cos over
                # offset, base/max-scaled coordinates
                scale = (self.pos_embed_base_size or self.pos_embed_max_size) / self.pos_embed_max_size
                top = (self.pos_embed_max_size - gh) // 2
                left = (self.pos_embed_max_size - gw) // 2
                arr = _2d_sincos_pos_embed(self.hidden_size, gh, gw, h_coords=(top + np.arange(gh)) * scale,
                                           w_coords=(left + np.arange(gw)) * scale)
            else:
                arr = _2d_sincos_pos_embed(self.hidden_size, gh, gw)
            pos = self._pos_cache[key] = torch.as_tensor(arr, dtype=torch.float32).to(device=device, dtype=dtype)
        return pos

    def embed(self, sample, timesteps, encoder_hidden_states, pooled):
        b, h, w, _ = sample.shape
        p = self.patch_size
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(sample.to(dtype).permute(0, 3, 1, 2))  # [B, hidden, gh, gw]
        x = x.flatten(2).transpose(1, 2) + self._pos_embed(h // p, w // p, x.device, dtype)[None]
        t_emb = get_timestep_embedding(timesteps.reshape(-1), 256).to(dtype)
        c = self.t_fc2(F.silu(self.t_fc1(t_emb)))
        if pooled is not None:
            c = c + self.pool_fc2(F.silu(self.pool_fc1(pooled.to(dtype))))
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        return x, ctx, c

    def backbone(self, x, ctx, c, joint_bias=None, skip_layers=None):
        skip = self.skip_layers if skip_layers is None else tuple(skip_layers)
        if not all(0 <= i < len(self.block_names) for i in skip):
            raise ValueError(f"skip_layers {skip} outside the {len(self.block_names)} joint blocks")
        for i, name in enumerate(self.block_names):
            if i not in skip:
                x, ctx = getattr(self, name)(x, ctx, c, joint_bias)
        if hasattr(self, "final_block"):
            x, ctx = self.final_block(x, ctx, c, joint_bias)
        return x, ctx

    def head(self, x, c, sample_shape):
        b, h, w, _ = sample_shape
        p, ch = self.patch_size, self.in_channels
        shift, scale = _modulation(self.final_modulation, c, 2)  # shift first
        x = self.final_proj(_layer_norm(x) * (1 + scale) + shift)
        x = x.view(b, h // p, w // p, p, p, ch).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h, w, ch).float()

    def joint_bias(self, encoder_attention_mask, n_image_tokens: int):
        """Additive bias masking padded text keys of the joint sequence."""
        if encoder_attention_mask is None:
            return None
        m = encoder_attention_mask
        joint = torch.cat([m, torch.ones((m.shape[0], n_image_tokens), dtype=m.dtype, device=m.device)], dim=1)
        return attention_bias_from_mask(joint)

    def forward(self, sample, timesteps, encoder_hidden_states, encoder_attention_mask=None, added_cond=None,
                skip_layers=None):
        """``skip_layers`` (None: the module's) are the joint blocks bypassed."""
        pooled = added_cond.get("text_embeds") if added_cond else None
        x, ctx, c = self.embed(sample, timesteps, encoder_hidden_states, pooled)
        bias = self.joint_bias(encoder_attention_mask, x.shape[1])
        x, _ = self.backbone(x, ctx, c, bias, skip_layers)
        return self.head(x, c, sample.shape)


MMDIT_PRESETS: dict[str, dict] = {
    # SD3-medium: 24 joint blocks x 1536, the last context_pre_only, the
    # 192-grid cropped position embedding (base 64)
    "sd3_medium": dict(
        patch_size=2, hidden_size=1536, depth=24, num_heads=24, in_channels=16, context_dim=4096,
        pooled_dim=2048, context_pre_only=True, pos_embed_max_size=192, pos_embed_base_size=64,
    ),
    "tiny": dict(patch_size=2, hidden_size=32, depth=2, num_heads=2, in_channels=4, context_dim=48, pooled_dim=24),
}
