"""DiT, the class-conditional diffusion transformer (``uwudiff_tpu/models/dit.py``).

Patchify (a ``patch_size`` stride convolution) plus the fixed 2D sin-cos
position embedding, ``depth`` adaLN-Zero blocks (a 6x modulation from
``silu(c)``; q/k/v/proj attention at head dim ``hidden_size / num_heads``,
72 at ``dit_xl_2``'s width; a 4x MLP with tanh GELU; gated residuals;
LayerNorms without scale or bias at flax's eps, 1e-6), then the final
adaLN, a projection and the unpatchify. The conditioning ``c`` is the
timestep MLP (``get_timestep_embedding(t, 256)``, cos first) plus the
class embedding; ``label_embed`` has ``num_classes + 1`` rows, the last
the null class that classifier-free guidance and label dropout use.

Public layout is the JAX package's NHWC, as the port's MMDiT and Flux
take it: ``sample`` ``[B, H, W, C]`` in, fp32 ``[B, H, W, C * (2 if
learn_sigma else 1)]`` out; timesteps on the DDPM scale ``[0, 1000)``.
Attribute names are the flax module names (``blocks_{i}``,
``adaLN_modulation``, ``patch_embed``, ``label_embed``, ...), so
``convert.load_jax_params`` loads a JAX tree, scanned or not. As in the
JAX module, ``adaLN_modulation``, ``final_modulation`` and ``final_proj``
are zero-initialised: a freshly built DiT outputs zeros
(``training.bench_setup.fill_zero_initialised`` draws them).

Label dropout (``train=True`` with ``class_dropout_prob > 0``) replaces a
label by the null class where a Bernoulli draw from ``generator`` says so;
``drop_mask`` (``[B]`` bool) replaces that draw, as the loss's noise can be
given. ``gradient_checkpointing`` recomputes each block in the backward
(``torch.utils.checkpoint``), as the JAX module's ``nn.remat`` does. The
MoE blocks (``num_experts``), the axial RoPE (``use_rope``) and
``scan_blocks`` are not ported and raise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uwudiff_tpu_torch.models.layers import _layer_norm, _modulation, _zero_linear, get_timestep_embedding
from uwudiff_tpu_torch.ops.attention import dot_product_attention
from uwudiff_tpu_torch.utils import build_module

__all__ = ["DIT_PRESETS", "DiT", "DiTBlock"]


def _2d_sincos_pos_embed(dim: int, h: int, w: int, h_coords=None, w_coords=None) -> np.ndarray:
    """Fixed 2D sin-cos position embedding, ``[h*w, dim]``, with the public
    MAE/DiT/diffusers layout: ``np.meshgrid(w, h)`` puts the w-coordinates
    first, so it is [w-emb | h-emb]. Explicit coordinates give SD3's
    cropped-grid positions."""

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(h, dtype=np.float64) if h_coords is None else np.asarray(h_coords, np.float64)
    gw = np.arange(w, dtype=np.float64) if w_coords is None else np.asarray(w_coords, np.float64)
    grid = np.meshgrid(gw, gh)  # grid[0] = w-coords, grid[1] = h-coords
    emb_first = _1d(dim // 2, np.asarray(grid[0]).reshape(-1))
    emb_second = _1d(dim // 2, np.asarray(grid[1]).reshape(-1))
    return np.concatenate([emb_first, emb_second], axis=1)


class DiTBlock(nn.Module):
    """adaLN-Zero block: ``adaLN_modulation`` gives shift, scale and gate for
    the attention and the MLP from ``silu(c)``."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        inner = int(hidden_size * mlp_ratio)
        self.adaLN_modulation = _zero_linear(hidden_size, 6 * hidden_size)
        self.q = nn.Linear(hidden_size, hidden_size)
        self.k = nn.Linear(hidden_size, hidden_size)
        self.v = nn.Linear(hidden_size, hidden_size)
        self.proj = nn.Linear(hidden_size, hidden_size)
        self.mlp_fc1 = nn.Linear(hidden_size, inner)
        self.mlp_fc2 = nn.Linear(inner, hidden_size)

    def forward(self, x, c):
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = _modulation(self.adaLN_modulation, c, 6)
        h = _layer_norm(x) * (1 + scale_a) + shift_a
        b, s, _ = h.shape
        shape = (b, s, self.num_heads, self.hidden_size // self.num_heads)
        attn = dot_product_attention(self.q(h).view(shape), self.k(h).view(shape), self.v(h).view(shape))
        x = x + gate_a * self.proj(attn.reshape(b, s, self.hidden_size))
        h = _layer_norm(x) * (1 + scale_m) + shift_m
        return x + gate_m * self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))


class DiT(nn.Module):
    """Class-conditional diffusion transformer (NHWC latents in and out)."""

    addition_embed_type = None  # no pooled text or micro-conditioning: the labels are the conditioning

    def __init__(
        self,
        patch_size: int = 2,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        in_channels: int = 4,
        num_classes: int = 1000,
        class_dropout_prob: float = 0.1,
        learn_sigma: bool = False,
        gradient_checkpointing: bool = False,
        use_rope: bool = False,
        num_experts: int = 0,
        scan_blocks: bool = False,
        **moe,
    ):
        super().__init__()
        if num_experts:
            raise NotImplementedError("DiT num_experts > 0 (DiT-MoE, models/moe.py) is not ported yet"
                                      " (ROADMAP.md, Queue 1 item 15)")
        if use_rope:
            raise NotImplementedError("DiT use_rope (models/rope.py::AxialRoPE) is not ported yet"
                                      " (ROADMAP.md, Queue 1 item 15)")
        if scan_blocks:
            raise NotImplementedError("DiT scan_blocks is not ported yet (ROADMAP.md, Queue 1 item 15)")
        unknown = set(moe) - {"moe_top_k", "moe_capacity_factor", "moe_group_size", "moe_router_type"}
        if unknown:
            raise TypeError(f"DiT got unexpected arguments {sorted(unknown)}")
        self.patch_size, self.hidden_size, self.in_channels = patch_size, hidden_size, in_channels
        self.num_classes, self.class_dropout_prob = num_classes, class_dropout_prob
        self.out_channels = in_channels * (2 if learn_sigma else 1)
        self.gradient_checkpointing = gradient_checkpointing
        self.patch_embed = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)
        self.t_fc1 = nn.Linear(256, hidden_size)
        self.t_fc2 = nn.Linear(hidden_size, hidden_size)
        self.label_embed = nn.Embedding(num_classes + 1, hidden_size)  # row num_classes: the null class
        self.block_names = [f"blocks_{i}" for i in range(depth)]
        for name in self.block_names:
            self.add_module(name, DiTBlock(hidden_size, num_heads, mlp_ratio))
        self.final_modulation = _zero_linear(hidden_size, 2 * hidden_size)
        self.final_proj = _zero_linear(hidden_size, patch_size * patch_size * self.out_channels)
        self._pos_cache: dict = {}

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides) -> "DiT":
        """A preset name or a config dict (the JAX ``from_config``'s), built
        on ``device`` in ``dtype``."""
        cfg = dict(DIT_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        cfg.pop("dtype", None)  # the JAX configs' compute dtype; the port takes ``dtype``
        return build_module(cls, cfg, device, dtype)

    def pos_embed(self, gh: int, gw: int, device, dtype):
        """The fixed position embedding ``[1, gh*gw, hidden]`` in ``dtype``,
        cached per grid."""
        key = (gh, gw, device, dtype)
        pos = self._pos_cache.get(key)
        if pos is None:
            table = _2d_sincos_pos_embed(self.hidden_size, gh, gw).astype(np.float32)
            pos = self._pos_cache[key] = torch.as_tensor(table)[None].to(device=device, dtype=dtype)
        return pos

    def embed(self, sample, timesteps, class_labels=None, train: bool = False, drop_mask=None, generator=None):
        """Patchify plus the position embedding, and the time (+ class)
        conditioning: ``(tokens [B, S, hidden], c [B, hidden])``. With
        ``train`` a label is dropped to the null class where ``drop_mask``
        is set, or, without one, with probability ``class_dropout_prob``
        from ``generator``."""
        b, h, w, _ = sample.shape
        p = self.patch_size
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(sample.to(dtype).permute(0, 3, 1, 2))  # [B, hidden, H/p, W/p]
        x = x.flatten(2).transpose(1, 2) + self.pos_embed(h // p, w // p, x.device, dtype)
        t = torch.as_tensor(timesteps, device=x.device).reshape(-1)
        c = self.t_fc2(F.silu(self.t_fc1(get_timestep_embedding(t, 256).to(dtype))))
        if class_labels is not None:
            labels = torch.as_tensor(class_labels, device=x.device).long()
            if train and self.class_dropout_prob > 0:
                if drop_mask is None:
                    drop_mask = torch.rand(b, generator=generator, device=x.device) < self.class_dropout_prob
                labels = torch.where(torch.as_tensor(drop_mask, device=x.device).bool(), self.num_classes, labels)
            c = c + self.label_embed(labels)
        return x, c

    def backbone(self, x, c):
        for name in self.block_names:
            block = getattr(self, name)
            if self.gradient_checkpointing and torch.is_grad_enabled():
                # the blocks draw no random numbers, so no RNG state is kept
                x = checkpoint(block, x, c, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, c)
        return x

    def head(self, x, c, sample_shape):
        """Final adaLN, the projection and the unpatchify (``bhwpqc ->
        bhpwqc``): fp32 ``[B, H, W, out_channels]``."""
        b, h, w, _ = sample_shape
        p = self.patch_size
        shift, scale = _modulation(self.final_modulation, c, 2)
        x = self.final_proj(_layer_norm(x) * (1 + scale) + shift)
        x = x.reshape(b, h // p, w // p, p, p, self.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h, w, self.out_channels).float()

    def forward(self, sample, timesteps, class_labels=None, train: bool = False, drop_mask=None, generator=None):
        x, c = self.embed(sample, timesteps, class_labels, train, drop_mask, generator)
        return self.head(self.backbone(x, c), c, sample.shape)


DIT_PRESETS: dict[str, dict] = {
    "dit_xl_2": dict(patch_size=2, hidden_size=1152, depth=28, num_heads=16),
    "dit_l_2": dict(patch_size=2, hidden_size=1024, depth=24, num_heads=16),
    "dit_b_2": dict(patch_size=2, hidden_size=768, depth=12, num_heads=12),
    "dit_s_2": dict(patch_size=2, hidden_size=384, depth=12, num_heads=6),
    "tiny": dict(patch_size=2, hidden_size=32, depth=2, num_heads=2, num_classes=10),
    # DiT-MoE: the constructor raises for num_experts (not ported yet)
    "dit_moe_s_2_8e": dict(patch_size=2, hidden_size=384, depth=12, num_heads=6, num_experts=8, moe_top_k=2),
    "dit_moe_b_2_8e": dict(patch_size=2, hidden_size=768, depth=12, num_heads=12, num_experts=8, moe_top_k=2),
    "tiny_moe": dict(patch_size=2, hidden_size=32, depth=2, num_heads=2, num_classes=10, num_experts=4, moe_top_k=2),
}
# prefixed aliases, as the JAX package's (bench.py routes by the "dit" prefix)
DIT_PRESETS["dit_tiny"] = DIT_PRESETS["tiny"]
DIT_PRESETS["dit_tiny_moe"] = DIT_PRESETS["tiny_moe"]
