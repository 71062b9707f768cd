"""T5 encoder, v1.1 architecture (``uwudiff_tpu/models/t5.py``): the
SD3-style third text encoder.

RMSNorm (fp32, eps 1e-6, fp32 scale), one relative-position bias built
per forward and shared by every layer, attention without the 1/sqrt(d)
scale, a tanh-approximated gated-GELU feed-forward, no biases. The bias
is a learned parameter, so attention runs with ``bias_grad=True``: on the
card the backward's dQ pass is the dQ + dBias kernel (K5) in every layer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from uwudiff_tpu_torch.models.layers import RMSNorm
from uwudiff_tpu_torch.ops.attention import dot_product_attention
from uwudiff_tpu_torch.utils import build_module

__all__ = ["T5EncoderModel", "T5EncoderOutput", "T5_PRESETS", "relative_position_bucket"]


class T5EncoderOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    hidden_states: tuple


def relative_position_bucket(relative_position, num_buckets: int = 32, max_distance: int = 128):
    """Bidirectional T5 bucketing, in fp32 exactly as the JAX package
    computes it (a bucket off at a boundary is another model)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scaled = (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    )
    val_if_large = max_exact + scaled.to(torch.int32)  # truncation toward zero, as astype(int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class _T5Layer(nn.Module):
    def __init__(self, d_model, num_heads, d_kv, d_ff):
        super().__init__()
        self.num_heads, self.d_kv = num_heads, d_kv
        inner = num_heads * d_kv
        self.attn_norm = RMSNorm(d_model)
        self.q = nn.Linear(d_model, inner, bias=False)
        self.k = nn.Linear(d_model, inner, bias=False)
        self.v = nn.Linear(d_model, inner, bias=False)
        self.o = nn.Linear(inner, d_model, bias=False)
        self.ff_norm = RMSNorm(d_model)
        self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
        self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x, bias):
        h = self.attn_norm(x)
        b, s, _ = h.shape
        shape = (b, s, self.num_heads, self.d_kv)
        attn = dot_product_attention(
            self.q(h).view(shape), self.k(h).view(shape), self.v(h).view(shape),
            bias=bias, scale=1.0, bias_grad=True,
        )
        x = x + self.o(attn.reshape(b, s, -1))
        h = self.ff_norm(x)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h)


class T5EncoderModel(nn.Module):
    def __init__(
        self,
        vocab_size: int = 32128,
        d_model: int = 512,
        num_layers: int = 8,
        num_heads: int = 6,
        d_kv: int = 64,
        d_ff: int = 1024,
        relative_attention_num_buckets: int = 32,
        relative_attention_max_distance: int = 128,
    ):
        super().__init__()
        self.num_buckets = relative_attention_num_buckets
        self.max_distance = relative_attention_max_distance
        self.token_embedding = nn.Embedding(vocab_size, d_model)
        self.relative_attention_bias = nn.Embedding(relative_attention_num_buckets, num_heads)
        self.layer_names = [f"layers_{i}" for i in range(num_layers)]
        for name in self.layer_names:
            self.add_module(name, _T5Layer(d_model, num_heads, d_kv, d_ff))
        self.final_norm = RMSNorm(d_model)

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides):
        """The weights in ``dtype``, except the RMSNorm scales and the
        relative-attention bias table, which stay fp32 as in the JAX module."""
        cfg = dict(T5_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        model = build_module(cls, cfg, device, dtype)
        for m in model.modules():
            if isinstance(m, RMSNorm):
                m.float()
        model.relative_attention_bias.float()
        return model

    def forward(self, input_ids, attention_mask=None) -> T5EncoderOutput:
        b, s = input_ids.shape
        x = self.token_embedding(input_ids.long())
        pos = torch.arange(s, device=x.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets, self.max_distance)
        # [1, H, Sq, Sk] fp32, made contiguous once here so that the sum below
        # is too: the flash kernels take it uncopied in every layer
        bias = self.relative_attention_bias(buckets.long()).permute(2, 0, 1).contiguous()[None]
        if attention_mask is not None:
            zero = torch.zeros((), device=x.device)
            pad = torch.where(attention_mask.bool(), zero, zero + torch.finfo(torch.float32).min)
            bias = bias + pad[:, None, None, :]
        hidden_states = [x]
        for name in self.layer_names:
            x = getattr(self, name)(x, bias)
            hidden_states.append(x)
        x = self.final_norm(x)
        hidden_states.append(x)
        return T5EncoderOutput(last_hidden_state=x, hidden_states=tuple(hidden_states))


T5_PRESETS: dict[str, dict] = {
    # google/t5-v1_1-xxl encoder
    "t5_xxl": dict(d_model=4096, num_layers=24, num_heads=64, d_kv=64, d_ff=10240),
    "tiny": dict(vocab_size=1024, d_model=32, num_layers=2, num_heads=2, d_kv=16, d_ff=64),
}
