"""Transformer blocks for the UNet (``uwudiff_tpu/models/transformer.py``).

Pre-LN self-attention -> cross-attention -> GEGLU feed-forward, all
residual; every attention goes through ``ops.dot_product_attention``.
Separate q/k/v projections only: fused QKV, scanned stacks, RoPE and
IP-Adapter come in a later slice.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from uwudiff_tpu_torch.models.layers import GroupNorm, LayerNorm
from uwudiff_tpu_torch.ops.attention import attention_bias_from_mask, dot_product_attention

__all__ = ["Attention", "FeedForward", "BasicTransformerBlock", "Transformer2DModel"]

# diffusers BasicTransformerBlock norm_eps; flax's LayerNorm default is 1e-6
_LN_EPS = 1e-5


class Attention(nn.Module):
    def __init__(self, query_dim: int, num_heads: int, head_dim: int, kv_dim: int | None = None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim or query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, hidden_states, encoder_hidden_states=None, attention_mask=None):
        kv = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        b, sq = hidden_states.shape[:2]
        sk = kv.shape[1]
        q = self.to_q(hidden_states).view(b, sq, self.num_heads, self.head_dim)
        k = self.to_k(kv).view(b, sk, self.num_heads, self.head_dim)
        v = self.to_v(kv).view(b, sk, self.num_heads, self.head_dim)
        out = dot_product_attention(q, k, v, bias=attention_bias_from_mask(attention_mask))
        return self.to_out(out.reshape(b, sq, -1))


class FeedForward(nn.Module):
    """GEGLU feed-forward with exact (erf) gelu, as diffusers."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = nn.Linear(dim, dim * mult * 2)
        self.proj_out = nn.Linear(dim * mult, dim)

    def forward(self, x):
        x_part, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(x_part * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, cross_attention_dim: int | None = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=_LN_EPS)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.has_cross = cross_attention_dim is not None
        if self.has_cross:
            self.norm2 = LayerNorm(dim, eps=_LN_EPS)
            self.attn2 = Attention(dim, num_heads, head_dim, kv_dim=cross_attention_dim)
        self.norm3 = LayerNorm(dim, eps=_LN_EPS)
        self.ff = FeedForward(dim)

    def forward(self, hidden_states, encoder_hidden_states=None, encoder_attention_mask=None):
        hidden_states = hidden_states + self.attn1(self.norm1(hidden_states))
        if self.has_cross:
            hidden_states = hidden_states + self.attn2(
                self.norm2(hidden_states), encoder_hidden_states, encoder_attention_mask
            )
        return hidden_states + self.ff(self.norm3(hidden_states))


class Transformer2DModel(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks over [B, HW, C] ->
    proj_out -> residual. ``use_linear_projection`` picks Linear (SDXL)
    or 1x1-conv (SD1.5) projections. A 1x1 conv over a channels-last map is
    a matrix product over its [B*HW, C] rows, so both forms run as one
    over the NHWC view, in and out, with no layout copy; the conv keeps its
    ``Conv2d`` weight (and its flax name and shape)."""

    def __init__(
        self,
        in_channels: int,
        num_heads: int,
        head_dim: int,
        num_layers: int = 1,
        cross_attention_dim: int | None = None,
        use_linear_projection: bool = False,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
    ):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm(in_channels, norm_num_groups, norm_eps, silu=False)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, in_channels, 1)
        self.block_names = [f"blocks_{i}" for i in range(num_layers)]
        for name in self.block_names:
            self.add_module(
                name, BasicTransformerBlock(inner, num_heads, head_dim, cross_attention_dim)
            )

    @staticmethod
    def _project(proj, x):
        if isinstance(proj, nn.Linear):
            return proj(x)
        return F.linear(x, proj.weight.flatten(1), proj.bias)  # the 1x1 conv's [out, in] matrix

    def forward(self, hidden_states, encoder_hidden_states=None, encoder_attention_mask=None):
        b, c, h, w = hidden_states.shape
        x = self.norm(hidden_states)
        x = self._project(self.proj_in, x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        for name in self.block_names:
            x = getattr(self, name)(x, encoder_hidden_states, encoder_attention_mask)
        x = self._project(self.proj_out, x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + hidden_states
