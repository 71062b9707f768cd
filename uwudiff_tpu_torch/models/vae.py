"""AutoencoderKL (``uwudiff_tpu/models/vae.py``): encoder -> diagonal
Gaussian latents -> decoder, with the SD scaling-factor convention (the
samplers' latents are ``(x - vae_mean) / vae_std``, ``vae_std =
1 / scaling_factor``).

``encode`` and ``decode`` take and return NHWC tensors; the modules run
channels-last NCHW, the GroupNorms through the kernels.
:meth:`AutoencoderKL.decode_tiled` and :meth:`AutoencoderKL.encode_tiled`
cut the input into overlapping tiles, run them one at a time (the
activations held are one tile's) and blend the outputs with a normalised
linear-ramp window (:func:`overlap_add`). Each tile normalises with its own
GroupNorm statistics, as in the JAX package, so a tiled result differs
from the untiled one near and away from the seams.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from uwudiff_tpu_torch.models.layers import Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D
from uwudiff_tpu_torch.ops.attention import dot_product_attention
from uwudiff_tpu_torch.utils import build_module

__all__ = ["AutoencoderKL", "Decoder", "DiagonalGaussian", "Encoder", "VAE_PRESETS", "overlap_add"]


def _tile_starts(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    return list(range(0, size - tile, stride)) + [size - tile]  # the last tile snaps to the border


def _ramp_window(n: int, ov: int, device) -> torch.Tensor:
    """1-D blend weights: linear ramps of width ``ov`` at both ends, never
    0, so a border pixel one tile covers keeps its full weight."""
    w = torch.ones((n,), dtype=torch.float32, device=device)
    if ov > 0:
        r = (torch.arange(ov, dtype=torch.float32, device=device) + 1.0) / (ov + 1.0)
        w[:ov] = r
        w[n - ov:] = r.flip(0)
    return w


def overlap_add(tiles, positions: list[tuple[int, int]], out_hw: tuple[int, int], overlap: int) -> torch.Tensor:
    """Normalised windowed overlap-add of NHWC ``[B, th, tw, C]`` tiles (an
    iterable, which may produce them one at a time) at ``positions``, their
    top-left corners: each tile weighted by a separable ramp window, the sum
    divided by the summed window, so the blend is exact wherever the tiles
    agree. Returns fp32 ``[B, *out_hw, C]``."""
    out = wsum = win = None
    for tile, (i, j) in zip(tiles, positions):
        th, tw = tile.shape[1], tile.shape[2]
        if out is None:
            dev = tile.device
            win = (_ramp_window(th, overlap, dev)[:, None] * _ramp_window(tw, overlap, dev)[None])[None, :, :, None]
            out = torch.zeros((tile.shape[0], *out_hw, tile.shape[-1]), dtype=torch.float32, device=dev)
            wsum = torch.zeros((1, *out_hw, 1), dtype=torch.float32, device=dev)
        out[:, i:i + th, j:j + tw] += tile.float() * win
        wsum[:, i:i + th, j:j + tw] += win
    return out / wsum


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: torch.Generator | None = None, noise: torch.Tensor | None = None) -> torch.Tensor:
        """``mean + std * noise``; the noise drawn from ``generator`` unless
        given."""
        std = torch.exp(0.5 * self.logvar.clamp(-30.0, 20.0))
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        logvar = self.logvar.clamp(-30.0, 20.0)
        return 0.5 * (self.mean**2 + torch.exp(logvar) - 1.0 - logvar).sum(dim=tuple(range(1, self.mean.dim())))


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


class _Blocks(nn.Module):
    """Named submodules run in the order they were added."""

    def __init__(self):
        super().__init__()
        self.order = []

    def _add(self, name, module):
        self.add_module(name, module)
        self.order.append(name)

    def _run(self, h):
        for name in self.order:
            h = getattr(self, name)(h)
        return h


class Encoder(_Blocks):
    def __init__(
        self,
        block_out_channels: Sequence[int],
        layers_per_block: int,
        in_channels: int,
        latent_channels: int,
        norm_num_groups: int = 32,
    ):
        super().__init__()
        g = norm_num_groups
        ch = block_out_channels[0]
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        for i, out_ch in enumerate(block_out_channels):
            for j in range(layers_per_block):
                self._add(f"down_{i}_res_{j}", ResnetBlock2D(ch, out_ch, None, g))
                ch = out_ch
            if i < len(block_out_channels) - 1:
                self._add(f"down_{i}_downsample", Downsample2D(ch, ch))
        self.mid_res_0 = ResnetBlock2D(ch, ch, None, g)
        self.mid_attn = _MidAttention(ch)
        self.mid_res_1 = ResnetBlock2D(ch, ch, None, g)
        # flax nn.GroupNorm (eps 1e-6) followed by silu: the fused kernel
        self.conv_norm_out = GroupNorm(ch, g, eps=1e-6, silu=True)
        self.conv_out = nn.Conv2d(ch, 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        h = self._run(self.conv_in(x))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        return self.conv_out(self.conv_norm_out(h))


class Decoder(_Blocks):
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
        ch = channels[0]
        for i, out_ch in enumerate(channels):
            for j in range(layers_per_block + 1):
                self._add(f"up_{i}_res_{j}", ResnetBlock2D(ch, out_ch, None, g))
                ch = out_ch
            if i < len(channels) - 1:
                self._add(f"up_{i}_upsample", Upsample2D(ch, ch))
        self.conv_norm_out = GroupNorm(ch, g, eps=1e-6, silu=True)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        return self.conv_out(self.conv_norm_out(self._run(h)))


class AutoencoderKL(nn.Module):
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
        self.scaling_factor = scaling_factor
        self.latent_channels = latent_channels
        self.downscale = 2 ** (len(block_out_channels) - 1)
        self.encoder = Encoder(block_out_channels, layers_per_block, in_channels, latent_channels, norm_num_groups)
        self.decoder = Decoder(block_out_channels, layers_per_block, out_channels, latent_channels, norm_num_groups)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides):
        cfg = dict(VAE_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        return build_module(cls, cfg, device, dtype)

    def _nchw(self, x):
        """NHWC input -> the modules' dtype as a channels-last NCHW view."""
        return x.to(self.post_quant_conv.weight.dtype).contiguous().permute(0, 3, 1, 2)

    def encode(self, x) -> DiagonalGaussian:
        """[B, H, W, in] images in [-1, 1] -> the latent Gaussian, fp32
        [B, h, w, latent] mean and log-variance."""
        moments = self.quant_conv(self.encoder(self._nchw(x))).permute(0, 2, 3, 1).float()
        mean, logvar = moments.chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z):
        """[B, h, w, latent] latents -> [B, H, W, 3] images in [-1, 1] (fp32)."""
        return self.decoder(self.post_quant_conv(self._nchw(z))).permute(0, 2, 3, 1).float()

    def decode_tiled(self, z, tile: int = 64, overlap: int = 16):
        """Decode in overlapping ``tile``-latent tiles (``overlap`` latents,
        at most half a tile), one tile at a time: the decoder's activations
        are one tile's. Input within one tile: :meth:`decode` itself."""
        _, h, w, _ = z.shape
        if h <= tile and w <= tile:
            return self.decode(z)
        overlap = min(overlap, tile // 2)
        f = self.downscale
        starts = [(i, j) for i in _tile_starts(h, tile, tile - overlap) for j in _tile_starts(w, tile, tile - overlap)]
        tiles = (self.decode(z[:, i:i + tile, j:j + tile]) for i, j in starts)
        return overlap_add(tiles, [(i * f, j * f) for i, j in starts], (h * f, w * f), overlap * f)

    def encode_tiled(self, x, tile: int = 512, overlap: int = 128) -> DiagonalGaussian:
        """Tiled :meth:`encode` (``tile``/``overlap`` in pixels); the mean and
        log-variance blend with the same window."""
        _, h, w, _ = x.shape
        if h <= tile and w <= tile:
            return self.encode(x)
        overlap = min(overlap, tile // 2)
        f = self.downscale
        starts = [(i, j) for i in _tile_starts(h, tile, tile - overlap) for j in _tile_starts(w, tile, tile - overlap)]
        tiles = (torch.cat(self.encode(x[:, i:i + tile, j:j + tile]), dim=-1) for i, j in starts)
        mean, logvar = overlap_add(tiles, [(i // f, j // f) for i, j in starts], (h // f, w // f),
                                   overlap // f).chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar)


VAE_PRESETS: dict[str, dict] = {
    "sdxl": dict(
        block_out_channels=(128, 256, 512, 512),
        layers_per_block=2,
        latent_channels=4,
        scaling_factor=0.13025,
    ),
    # SD1.x's VAE (the DiT family's too): SDXL's architecture, its own scale
    "sd15": dict(
        block_out_channels=(128, 256, 512, 512),
        layers_per_block=2,
        latent_channels=4,
        scaling_factor=0.18215,
    ),
    "tiny": dict(
        block_out_channels=(16, 32),
        layers_per_block=1,
        latent_channels=4,
        norm_num_groups=8,
        scaling_factor=0.18215,
    ),
}
