"""AutoencoderKL decoder (``uwudiff_tpu/models/vae.py``).

This slice serves images, so it ports ``post_quant_conv`` + ``Decoder``
and ``AutoencoderKL.decode``; the encoder, ``quant_conv`` and tiled
decode come later. The weight converter skips the JAX module's
``encoder``/``quant_conv`` subtrees by name (:attr:`jax_skip_subtrees`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from uwudiff_tpu_torch.models.layers import GroupNorm, ResnetBlock2D, Upsample2D
from uwudiff_tpu_torch.ops.attention import dot_product_attention
from uwudiff_tpu_torch.utils import build_module

__all__ = ["AutoencoderKL", "Decoder", "VAE_PRESETS"]


class _MidAttention(nn.Module):
    """Single-head spatial self-attention of the mid block (D = C = 512 at
    SDXL width: the einsum path, as in the JAX package)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels, 32, eps=1e-6, silu=False)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = dot_product_attention(self.to_q(t), self.to_k(t), self.to_v(t))
        out = self.to_out(out.reshape(b, h * w, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Decoder(nn.Module):
    def __init__(
        self,
        block_out_channels: Sequence[int],
        layers_per_block: int,
        out_channels: int,
        latent_channels: int,
        norm_num_groups: int = 32,
    ):
        super().__init__()
        channels = tuple(reversed(tuple(block_out_channels)))
        g = norm_num_groups
        self.conv_in = nn.Conv2d(latent_channels, channels[0], 3, padding=1)
        self.mid_res_0 = ResnetBlock2D(channels[0], channels[0], None, g)
        self.mid_attn = _MidAttention(channels[0])
        self.mid_res_1 = ResnetBlock2D(channels[0], channels[0], None, g)
        self.up_names = []
        ch = channels[0]
        for i, out_ch in enumerate(channels):
            for j in range(layers_per_block + 1):
                self._add(f"up_{i}_res_{j}", ResnetBlock2D(ch, out_ch, None, g))
                ch = out_ch
            if i < len(channels) - 1:
                self._add(f"up_{i}_upsample", Upsample2D(ch, ch))
        # flax nn.GroupNorm (eps 1e-6) followed by silu: the fused kernel
        self.conv_norm_out = GroupNorm(ch, g, eps=1e-6, silu=True)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1)

    def _add(self, name, module):
        self.add_module(name, module)
        self.up_names.append(name)

    def forward(self, z):
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        for name in self.up_names:
            h = getattr(self, name)(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    jax_skip_subtrees = ("encoder", "quant_conv")

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2,
        latent_channels: int = 4,
        norm_num_groups: int = 32,
        scaling_factor: float = 0.13025,
    ):
        super().__init__()
        del in_channels  # the encoder's; kept for preset compatibility
        self.scaling_factor = scaling_factor
        self.latent_channels = latent_channels
        self.downscale = 2 ** (len(block_out_channels) - 1)
        self.decoder = Decoder(
            block_out_channels, layers_per_block, out_channels, latent_channels, norm_num_groups
        )
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides):
        cfg = dict(VAE_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        return build_module(cls, cfg, device, dtype)

    def decode(self, z):
        """[B, h, w, latent] latents -> [B, H, W, 3] images in [-1, 1] (fp32)."""
        dtype = self.post_quant_conv.weight.dtype
        h = self.post_quant_conv(z.to(dtype).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1).float()


VAE_PRESETS: dict[str, dict] = {
    "sdxl": dict(
        block_out_channels=(128, 256, 512, 512),
        layers_per_block=2,
        latent_channels=4,
        scaling_factor=0.13025,
    ),
    "tiny": dict(
        block_out_channels=(16, 32),
        layers_per_block=1,
        latent_channels=4,
        norm_num_groups=8,
        scaling_factor=0.18215,
    ),
}
