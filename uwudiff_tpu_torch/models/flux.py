"""Flux, the rectified-flow transformer of Black Forest Labs
(``uwudiff_tpu/models/flux.py``).

Latents are packed 2x2 into tokens (16 channels -> 64 features, a plain
reshape) and embedded by one Linear; a 3-axis rotary embedding over
(id, row, col) token coordinates, text at the origin, rotates q and k;
``depth`` dual-stream blocks (the MMDiT's: per-stream projections, MLPs and
adaLN-Zero, joint attention over [text; image]) are followed by
``depth_single`` single-stream blocks, where attention and the 4x MLP read
one modulated pre-norm in parallel and one ``proj_out`` mixes both. The
conditioning is the timestep MLP plus, for flux-dev, a guidance MLP
(``added_cond["guidance"]``, default ``default_guidance``) plus the pooled
CLIP-L MLP (``added_cond["text_embeds"]``); the context is T5's sequence,
whose key mask becomes a key bias over the joint sequence. Every attention
is the flash forward at head dim ``hidden_size / num_heads`` (128 at
``flux_dev``'s width).

Public layout is the JAX package's NHWC: ``sample`` ``[B, H, W, C]`` in,
fp32 ``[B, H, W, C]`` out; timesteps on the DDPM scale ``[0, 1000)``.
Attribute names are the flax module names (``blocks_{i}``,
``single_blocks_{i}``, ``attn1``/``attn2``, ``adaLN_x``, ...), so
``convert.load_jax_params`` loads a JAX tree, scanned or not. As in the JAX
module, the adaLN modulations, ``final_modulation`` and ``final_proj`` are
zero-initialised: a freshly built model outputs zeros.
``gradient_checkpointing`` recomputes each block in the backward, as the
JAX module's ``nn.remat`` of every block does: while autograd records, a
block's forward runs under ``torch.utils.checkpoint`` (non-reentrant) and
keeps only its inputs, and the backward runs it again, its attention
through the flash forward once more. ``scan_blocks`` (a training option)
is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uwudiff_tpu_torch.models.layers import get_timestep_embedding
from uwudiff_tpu_torch.models.mmdit import _MLP, _layer_norm, _modulation, _StreamAttention, _zero_linear
from uwudiff_tpu_torch.ops.attention import attention_bias_from_mask, dot_product_attention
from uwudiff_tpu_torch.utils import build_module

__all__ = ["FLUX_PRESETS", "Flux", "FluxDoubleBlock", "FluxSingleBlock", "apply_flux_rope", "flux_rope_table"]

_UNPORTED = ("scan_blocks",)


def flux_rope_table(ids: np.ndarray, axes_dims, theta: float = 10000.0) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables ``[S, sum(axes_dims)]`` for token coordinates
    ``ids [S, n_axes]``: per axis ``pos * theta**(-2i/d)``, cos and sin
    repeated x2 (interleaved pairs), the axes concatenated. Computed in
    float64 on the host, returned as float32."""
    ids = np.asarray(ids, np.float64)
    cos_parts, sin_parts = [], []
    for a, dim in enumerate(axes_dims):
        omega = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        freqs = np.outer(ids[:, a], omega)
        cos_parts.append(np.repeat(np.cos(freqs), 2, axis=-1))
        sin_parts.append(np.repeat(np.sin(freqs), 2, axis=-1))
    return (np.concatenate(cos_parts, axis=-1).astype(np.float32),
            np.concatenate(sin_parts, axis=-1).astype(np.float32))


def apply_flux_rope(x, cos, sin):
    """Rotate ``x [B, S, H, D]`` by per-position tables broadcastable to it
    (``[1, S, 1, D]``): ``x * cos + interleave(-x_odd, x_even) * sin``, in
    x's dtype."""
    rotated = torch.stack((-x[..., 1::2], x[..., 0::2]), dim=-1).reshape(x.shape)
    return x * cos.to(x.dtype) + rotated * sin.to(x.dtype)


def _joint_ids(gh: int, gw: int, n_txt: int) -> np.ndarray:
    """``[n_txt + gh*gw, 3]`` (id, row, col) coordinates: text at the
    origin, image tokens on the (row, col) grid."""
    rows, cols = np.meshgrid(np.arange(gh, dtype=np.float64), np.arange(gw, dtype=np.float64), indexing="ij")
    img = np.stack([np.zeros(gh * gw), rows.reshape(-1), cols.reshape(-1)], axis=-1)
    return np.concatenate([np.zeros((n_txt, 3), np.float64), img], axis=0)


def _rope(q, k, rope):
    cos, sin = rope
    return apply_flux_rope(q, cos, sin), apply_flux_rope(k, cos, sin)


class FluxDoubleBlock(nn.Module):
    """Dual-stream block: ``attn1``/``mlp_x``/``adaLN_x`` for the image
    stream, ``attn2``/``mlp_ctx``/``adaLN_ctx`` for the text stream, both
    modulated shift, scale, gate; attention over the rotated [text; image]
    sequence."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0):
        super().__init__()
        self.adaLN_x = _zero_linear(hidden_size, 6 * hidden_size)
        self.adaLN_ctx = _zero_linear(hidden_size, 6 * hidden_size)
        self.attn1 = _StreamAttention(hidden_size, num_heads)
        self.attn2 = _StreamAttention(hidden_size, num_heads)
        self.mlp_x = _MLP(hidden_size, mlp_ratio)
        self.mlp_ctx = _MLP(hidden_size, mlp_ratio)

    def forward(self, x, ctx, c, rope, joint_bias=None):
        sx_a, scx_a, gx_a, sx_m, scx_m, gx_m = _modulation(self.adaLN_x, c, 6)
        sc_a, scc_a, gc_a, sc_m, scc_m, gc_m = _modulation(self.adaLN_ctx, c, 6)
        qx, kx, vx = self.attn1.qkv(_layer_norm(x) * (1 + scx_a) + sx_a)
        qc, kc, vc = self.attn2.qkv(_layer_norm(ctx) * (1 + scc_a) + sc_a)
        q, k = _rope(torch.cat([qc, qx], dim=1), torch.cat([kc, kx], dim=1), rope)  # text first
        attn = dot_product_attention(q, k, torch.cat([vc, vx], dim=1), bias=joint_bias)
        t = ctx.shape[1]
        x = x + gx_a * self.attn1.out(attn[:, t:])
        ctx = ctx + gc_a * self.attn2.out(attn[:, :t])
        x = x + gx_m * self.mlp_x(_layer_norm(x) * (1 + scx_m) + sx_m)
        ctx = ctx + gc_m * self.mlp_ctx(_layer_norm(ctx) * (1 + scc_m) + sc_m)
        return x, ctx


class FluxSingleBlock(nn.Module):
    """Single-stream block: attention (no output projection of its own) and
    the 4x MLP both read one modulated pre-norm; ``proj_out`` maps
    ``[attn; gelu(mlp)]`` back to the residual, gated."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0):
        super().__init__()
        inner = int(hidden_size * mlp_ratio)
        self.adaLN = _zero_linear(hidden_size, 3 * hidden_size)
        self.attn1 = _StreamAttention(hidden_size, num_heads, pre_only=True)
        self.proj_mlp = nn.Linear(hidden_size, inner)
        self.proj_out = nn.Linear(hidden_size + inner, hidden_size)

    def forward(self, h, c, rope, joint_bias=None):
        shift, scale, gate = _modulation(self.adaLN, c, 3)
        hn = _layer_norm(h) * (1 + scale) + shift
        q, k, v = self.attn1.qkv(hn)
        q, k = _rope(q, k, rope)
        a = dot_product_attention(q, k, v, bias=joint_bias)
        a = a.reshape(a.shape[0], a.shape[1], -1)
        mlp = F.gelu(self.proj_mlp(hn), approximate="tanh")
        return h + gate * self.proj_out(torch.cat([a, mlp], dim=-1))


class Flux(nn.Module):
    """Flux-family rectified-flow transformer (NHWC latents in and out)."""

    addition_embed_type = "pooled_text"  # pooled CLIP via added_cond["text_embeds"]

    def __init__(
        self,
        patch_size: int = 2,
        hidden_size: int = 3072,
        depth: int = 19,
        depth_single: int = 38,
        num_heads: int = 24,
        mlp_ratio: float = 4.0,
        in_channels: int = 16,
        context_dim: int = 4096,
        pooled_dim: int = 768,
        guidance_embeds: bool = True,
        default_guidance: float = 3.5,
        axes_dims=(16, 56, 56),
        rope_theta: float = 10000.0,
        gradient_checkpointing: bool = False,
    ):
        super().__init__()
        if sum(axes_dims) != hidden_size // num_heads:
            raise ValueError(f"axes_dims {tuple(axes_dims)} must sum to the per-head dim {hidden_size // num_heads}")
        self.patch_size, self.in_channels = patch_size, in_channels
        self.context_dim, self.pooled_dim = context_dim, pooled_dim
        self.guidance_embeds, self.default_guidance = guidance_embeds, default_guidance
        self.axes_dims, self.rope_theta = tuple(axes_dims), rope_theta
        self.gradient_checkpointing = gradient_checkpointing
        self.x_embedder = nn.Linear(patch_size * patch_size * in_channels, hidden_size)
        self.context_embedder = nn.Linear(context_dim, hidden_size)
        self.t_fc1 = nn.Linear(256, hidden_size)
        self.t_fc2 = nn.Linear(hidden_size, hidden_size)
        if guidance_embeds:
            self.g_fc1 = nn.Linear(256, hidden_size)
            self.g_fc2 = nn.Linear(hidden_size, hidden_size)
        self.pool_fc1 = nn.Linear(pooled_dim, hidden_size)
        self.pool_fc2 = nn.Linear(hidden_size, hidden_size)
        self.block_names = [f"blocks_{i}" for i in range(depth)]
        for name in self.block_names:
            self.add_module(name, FluxDoubleBlock(hidden_size, num_heads, mlp_ratio))
        self.single_block_names = [f"single_blocks_{i}" for i in range(depth_single)]
        for name in self.single_block_names:
            self.add_module(name, FluxSingleBlock(hidden_size, num_heads, mlp_ratio))
        self.final_modulation = _zero_linear(hidden_size, 2 * hidden_size)
        self.final_proj = _zero_linear(hidden_size, patch_size * patch_size * in_channels)
        self._rope_cache: dict = {}

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides) -> "Flux":
        """A preset name or a config dict (the JAX ``from_config``'s),
        built on ``device`` directly in ``dtype``: ``flux_dev`` in bf16
        never holds an fp32 copy (48 GB)."""
        cfg = dict(FLUX_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        cfg.pop("dtype", None)  # the JAX configs' compute dtype; the port takes ``dtype``
        for key in _UNPORTED:
            if cfg.pop(key, None):
                raise NotImplementedError(f"Flux {key} is a training option not ported yet (ROADMAP.md, Queue 1)")
        return build_module(cls, cfg, device, dtype, construct_in_dtype=True)

    def _run_block(self, block, *args):
        """``block(*args)``; with ``gradient_checkpointing`` while autograd
        records, recomputed in the backward from its inputs (the blocks draw
        no random numbers, so no RNG state is kept)."""
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def _pack(self, sample):
        """[B, H, W, C] -> [B, (H/p)(W/p), C*p*p], features ordered (C, ph, pw)."""
        b, h, w, ch = sample.shape
        p = self.patch_size
        x = sample.reshape(b, h // p, p, w // p, p, ch).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, (h // p) * (w // p), ch * p * p)

    def _unpack(self, x, sample_shape):
        b, h, w, ch = sample_shape
        p = self.patch_size
        x = x.reshape(b, h // p, w // p, ch, p, p).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, h, w, ch)

    def rope(self, gh: int, gw: int, n_txt: int, device, dtype):
        """The rotary tables of the joint sequence, ``[1, n_txt + gh*gw, 1,
        head_dim]`` each, in ``dtype``, cached per grid."""
        key = (gh, gw, n_txt, device, dtype)
        tables = self._rope_cache.get(key)
        if tables is None:
            cos, sin = flux_rope_table(_joint_ids(gh, gw, n_txt), self.axes_dims, self.rope_theta)
            tables = self._rope_cache[key] = tuple(
                torch.as_tensor(t)[None, :, None, :].to(device=device, dtype=dtype) for t in (cos, sin))
        return tables

    def conditioning(self, timesteps, added_cond, batch: int, dtype):
        """c = timestep MLP (+ guidance MLP) (+ pooled-text MLP), [B, hidden]."""
        dev = self.t_fc1.weight.device
        c = self.t_fc2(F.silu(self.t_fc1(get_timestep_embedding(timesteps.reshape(-1), 256).to(dtype))))
        if self.guidance_embeds:
            guidance = added_cond.get("guidance") if added_cond else None
            if guidance is None:
                guidance = torch.full((batch,), self.default_guidance, device=dev)
            else:  # a scalar or one per sample
                guidance = torch.as_tensor(guidance, dtype=torch.float32, device=dev).reshape(-1).expand(batch)
            g_emb = get_timestep_embedding(guidance * 1000.0, 256).to(dtype)  # the timesteps' sinusoid scale
            c = c + self.g_fc2(F.silu(self.g_fc1(g_emb)))
        pooled = added_cond.get("text_embeds") if added_cond else None
        if pooled is not None:
            c = c + self.pool_fc2(F.silu(self.pool_fc1(pooled.to(dtype))))
        return c

    def forward(self, sample, timesteps, encoder_hidden_states, encoder_attention_mask=None, added_cond=None):
        b, h, w, _ = sample.shape
        p = self.patch_size
        gh, gw, n_txt = h // p, w // p, encoder_hidden_states.shape[1]
        dtype = self.x_embedder.weight.dtype
        x = self.x_embedder(self._pack(sample.to(dtype)))
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        c = self.conditioning(timesteps, added_cond, b, dtype)
        rope = self.rope(gh, gw, n_txt, x.device, dtype)
        bias = None
        if encoder_attention_mask is not None:  # text keys masked, image keys kept
            m = encoder_attention_mask
            bias = attention_bias_from_mask(torch.cat([m, m.new_ones((b, gh * gw))], dim=1))
        for name in self.block_names:
            x, ctx = self._run_block(getattr(self, name), x, ctx, c, rope, bias)
        hcat = torch.cat([ctx, x], dim=1)
        for name in self.single_block_names:
            hcat = self._run_block(getattr(self, name), hcat, c, rope, bias)
        x = hcat[:, n_txt:]
        scale, shift = _modulation(self.final_modulation, c, 2)  # scale first (AdaLayerNormContinuous)
        x = self.final_proj(_layer_norm(x) * (1 + scale) + shift)
        return self._unpack(x, sample.shape).float()


FLUX_PRESETS: dict[str, dict] = {
    # flux-dev: 19 double + 38 single blocks, 24 heads x 128 (~11.9 B)
    "flux_dev": dict(hidden_size=3072, depth=19, depth_single=38, num_heads=24, in_channels=16, context_dim=4096,
                     pooled_dim=768, guidance_embeds=True, axes_dims=(16, 56, 56)),
    # flux-schnell: the same trunk, no guidance embedding
    "flux_schnell": dict(hidden_size=3072, depth=19, depth_single=38, num_heads=24, in_channels=16,
                         context_dim=4096, pooled_dim=768, guidance_embeds=False, axes_dims=(16, 56, 56)),
    # the ~1 B scale point of bench.py's flux_1b recipe
    "flux_1b": dict(hidden_size=1536, depth=6, depth_single=12, num_heads=12, in_channels=16, context_dim=4096,
                    pooled_dim=768, guidance_embeds=True, axes_dims=(16, 56, 56)),
    "tiny": dict(hidden_size=32, depth=2, depth_single=2, num_heads=2, in_channels=4, context_dim=48, pooled_dim=24,
                 guidance_embeds=True, axes_dims=(4, 6, 6)),
}
