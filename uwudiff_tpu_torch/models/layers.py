"""Shared building blocks (``uwudiff_tpu/models/layers.py``).

Feature maps are NCHW-logical tensors in ``torch.channels_last`` memory,
so ``x.permute(0, 2, 3, 1)`` is the contiguous ``[N, H, W, C]`` view the
GroupNorm kernels read with no copy. Attribute names are the flax module
names, so ``convert.load_jax_params`` maps parameters mechanically.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from uwudiff_tpu_torch.ops.groupnorm_silu import group_norm_silu

__all__ = [
    "get_timestep_embedding",
    "TimestepEmbedding",
    "GroupNorm",
    "LayerNorm",
    "RMSNorm",
    "ResnetBlock2D",
    "Downsample2D",
    "Upsample2D",
]


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal timestep embeddings (diffusers ``Timesteps``); float
    timesteps allowed. Returns [B, embedding_dim] fp32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting sinusoidal features to the time channel."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class GroupNorm(nn.Module):
    """GroupNorm with an optional fused SiLU, through the GroupNorm+SiLU
    kernels (``GroupNormSiLU`` and flax ``nn.GroupNorm`` in the JAX
    package; its flax ``scale``/``bias`` load as ``weight``/``bias``).

    Takes ``[N, C, H, W]`` channels-last feature maps or ``[N, S, C]``
    token tensors. The eps is explicit: flax's GroupNorm default is
    1e-6, the fused module's 1e-5."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5, silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if x.dim() == 3:
            return group_norm_silu(x, self.weight, self.bias, self.groups, self.eps, self.silu)
        y = group_norm_silu(
            x.permute(0, 2, 3, 1), self.weight, self.bias, self.groups, self.eps, self.silu
        )
        return y.permute(0, 3, 1, 2)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed as flax's ``LayerNorm`` computes it: the
    statistics, the affine and, in the backward, the weight and bias
    gradients in fp32, the output in the input's dtype. CUDA's kernel does
    so for a bf16 input; the CPU's sums a bf16 input's weight and bias
    gradients in bf16 (some 5 % off over 512 rows), so there a narrower
    input is widened first."""

    def forward(self, x):
        if x.device.type != "cpu" or x.dtype == torch.float32:
            return super().forward(x)
        w, b = (None if t is None else t.float() for t in (self.weight, self.bias))
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm over the last dim, computed in fp32, output in the input's
    dtype (T5's ``RMSNorm`` and flax ``nn.RMSNorm``: eps 1e-6, a ``scale``
    that loads as ``weight``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def _conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv3x3 -> (+time proj) -> GN -> SiLU -> (dropout) ->
    conv3x3, residual with a 1x1 shortcut when the width changes. Both
    GN+SiLU pairs run through the kernels. The dropout acts in train mode
    only and defaults to 0.0, as in the JAX package."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int | None = None,
        groups: int = 32,
        eps: float = 1e-5,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.dropout = dropout
        self.norm1 = GroupNorm(in_channels, groups, eps)
        self.conv1 = _conv3x3(in_channels, out_channels)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, groups, eps)
        self.conv2 = _conv3x3(out_channels, out_channels)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, hidden_states, temb=None):
        h = self.conv1(self.norm1(hidden_states))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.norm2(h)
        if self.dropout > 0:
            h = F.dropout(h, self.dropout, self.training)
        h = self.conv2(h)
        residual = hidden_states
        if hasattr(self, "conv_shortcut"):
            residual = self.conv_shortcut(residual)
        return h + residual


class Downsample2D(nn.Module):
    """3x3 stride-2 conv downsample."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _conv3x3(in_channels, out_channels, stride=2)

    def forward(self, hidden_states):
        return self.conv(hidden_states)


class Upsample2D(nn.Module):
    """Nearest-neighbour 2x upsample + 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _conv3x3(in_channels, out_channels)

    def forward(self, hidden_states):
        return self.conv(F.interpolate(hidden_states, scale_factor=2.0, mode="nearest"))
