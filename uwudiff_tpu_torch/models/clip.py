"""CLIP text transformer (``uwudiff_tpu/models/clip.py``).

Returns every hidden state so callers pick ``layer_idx`` (SDXL uses -2)
and re-apply the final LayerNorm, as the JAX module does. Attention runs
through ``ops.dot_product_attention`` with the causal(+padding) mask as a
full additive bias, which the flash kernel takes at 77x77.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from uwudiff_tpu_torch.ops.attention import dot_product_attention
from uwudiff_tpu_torch.utils import build_module

__all__ = ["CLIPTextModel", "CLIPTextOutput", "CLIP_PRESETS"]

# HF CLIP's layer_norm_eps (flax's default is 1e-6)
_LN_EPS = 1e-5


class CLIPTextOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # final-LN applied
    pooler_output: torch.Tensor  # EOS-position hidden
    hidden_states: tuple  # embeddings + each layer (pre-final-LN)
    embedding: torch.Tensor  # hidden_states[layer_idx]
    normed_embedding: torch.Tensor  # final-LN re-applied to `embedding`
    text_embeds: torch.Tensor | None = None  # projected pooled


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x):
    # flax's nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS = {"quick_gelu": quick_gelu, "gelu": _gelu_tanh}


class _CLIPLayer(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size, hidden_act="quick_gelu"):
        super().__init__()
        self.num_heads = num_heads
        self.act = _ACTS[hidden_act]
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=_LN_EPS)
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=_LN_EPS)
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x, bias):
        h = self.layer_norm1(x)
        b, s, c = h.shape
        shape = (b, s, self.num_heads, c // self.num_heads)
        attn = dot_product_attention(
            self.q_proj(h).view(shape), self.k_proj(h).view(shape),
            self.v_proj(h).view(shape), bias=bias,
        )
        x = x + self.out_proj(attn.reshape(b, s, c))
        h = self.fc2(self.act(self.fc1(self.layer_norm2(x))))
        return x + h


class CLIPTextModel(nn.Module):
    def __init__(
        self,
        vocab_size: int = 49408,
        hidden_size: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        intermediate_size: int = 3072,
        max_position_embeddings: int = 77,
        hidden_act: str = "quick_gelu",
        eos_token_id: int | None = None,  # None -> argmax(input_ids)
        projection_dim: int | None = None,
    ):
        super().__init__()
        self.max_position_embeddings = max_position_embeddings
        self.eos_token_id = eos_token_id
        self.token_embedding = nn.Embedding(vocab_size, hidden_size)
        self.position_embedding = nn.Parameter(
            torch.randn(max_position_embeddings, hidden_size) * 0.01
        )
        self.layer_names = [f"layers_{i}" for i in range(num_layers)]
        for name in self.layer_names:
            self.add_module(
                name, _CLIPLayer(hidden_size, num_heads, intermediate_size, hidden_act)
            )
        self.final_layer_norm = nn.LayerNorm(hidden_size, eps=_LN_EPS)
        if projection_dim is not None:
            self.text_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    @classmethod
    def from_config(cls, config: str | dict, device="cuda", dtype=torch.float32, **overrides):
        cfg = dict(CLIP_PRESETS[config]) if isinstance(config, str) else dict(config)
        cfg.update(overrides)
        return build_module(cls, cfg, device, dtype)

    def forward(self, input_ids, attention_mask=None, layer_idx: int = -1) -> CLIPTextOutput:
        b, s = input_ids.shape
        ids = input_ids.long()
        x = self.token_embedding(ids) + self.position_embedding[:s].to(
            self.token_embedding.weight.dtype
        )

        # causal mask (+ key padding), additive fp32; padding adds finfo.min
        # a second time (-> -inf), which the flash kernel's clamp absorbs
        neg = torch.finfo(torch.float32).min
        zero = torch.zeros((), device=x.device)
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        bias = torch.where(causal, zero, zero + neg)[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask.bool(), zero, zero + neg)
            bias = bias + pad[:, None, None, :]

        hidden_states = [x]
        for name in self.layer_names:
            x = getattr(self, name)(x, bias)
            hidden_states.append(x)

        last_hidden = self.final_layer_norm(x)
        embedding = hidden_states[layer_idx]
        normed_embedding = self.final_layer_norm(embedding)
        if self.eos_token_id is None:
            eos_pos = ids.argmax(dim=-1)
        else:
            eos_pos = (ids == self.eos_token_id).int().argmax(dim=-1)
        pooled = last_hidden[torch.arange(b, device=ids.device), eos_pos]
        text_embeds = self.text_projection(pooled) if hasattr(self, "text_projection") else None
        return CLIPTextOutput(
            last_hidden_state=last_hidden,
            pooler_output=pooled,
            hidden_states=tuple(hidden_states),
            embedding=embedding,
            normed_embedding=normed_embedding,
            text_embeds=text_embeds,
        )


CLIP_PRESETS: dict[str, dict] = {
    # openai/clip-vit-large-patch14 text tower (SDXL TE-1)
    "clip_l": dict(
        hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
        hidden_act="quick_gelu",
    ),
    # laion CLIP-bigG text tower (SDXL TE-2)
    "clip_bigg": dict(
        hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
        hidden_act="gelu",
    ),
    "tiny": dict(
        vocab_size=1024, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position_embeddings=77,
    ),
}
