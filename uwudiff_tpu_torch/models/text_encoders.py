"""Multi-text-encoder conditioning (``uwudiff_tpu/models/text_encoders.py``).

``ConcatTextEncoders`` runs every text tower (CLIP, T5) and assembles the
context: feature concat within a bucket, sequence concat across buckets
after zero-padding features to the widest bucket (or ``pad_context_to``),
pooled concat, the key mask of the buckets that ask for one, and
optionally zeroed padding positions. SDXL is CLIP-L + CLIP-bigG in bucket
0; SD3 adds T5 in bucket 1. ``TextEncodingPipeline`` holds the host-side
tokenizers and runs ``encode``: plain, with A1111 emphasis
(``prompt_weighting``, ``models/prompt_weights.py``) and with prompts past
CLIP's 77 positions (``long_prompt``, ``models/long_prompt.py``): a CLIP
given ``[B, n * 77]`` tokens encodes them as ``[B * n, 77]`` in one call.
Nested caption lists come later.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from uwudiff_tpu_torch.models.clip import CLIPTextModel
from uwudiff_tpu_torch.models.t5 import T5EncoderModel
from uwudiff_tpu_torch.utils import resolve_device

__all__ = ["TextModelExtraConfig", "ConcatTextEncoders", "TextEncodingPipeline"]


@dataclasses.dataclass(frozen=True)
class TextModelExtraConfig:
    concat_bucket: int = 0
    use_pooled: bool = False
    layer_idx: int = -1
    need_mask: bool = False
    # contribute only the pooled vector (the sequence stays out of the context)
    pooled_only: bool = False


def _cat(parts, dim):
    return torch.cat(parts, dim=dim) if parts else None


def _build_text_model(cfg, device, dtype):
    cfg = dict(cfg)
    model_type = cfg.pop("model_type", "clip")
    cls = {"clip": CLIPTextModel, "t5": T5EncoderModel}.get(model_type)
    if cls is None:
        raise ValueError(f"Unknown text model_type {model_type!r}")
    cfg.pop("dtype", None)  # the JAX configs' compute dtype; the port takes ``dtype``
    preset = cfg.pop("preset", None)
    return cls.from_config(preset if preset else {}, device=device, dtype=dtype, **cfg)


class ConcatTextEncoders(nn.Module):
    """Returns ``(embedding, normed_embedding, pooled, attn_mask)``."""

    def __init__(
        self,
        text_models: Sequence[nn.Module],
        configs: Sequence[TextModelExtraConfig],
        zero_for_padding: bool = True,
        use_normed_ctx: bool = False,
        pad_context_to: int | None = None,
    ):
        super().__init__()
        self.configs = tuple(configs)
        self.zero_for_padding = zero_for_padding
        self.use_normed_ctx = use_normed_ctx
        self.pad_context_to = pad_context_to
        self.model_names = [f"text_models_{i}" for i in range(len(text_models))]
        for name, model in zip(self.model_names, text_models):
            self.add_module(name, model)

    @property
    def text_models(self) -> list[nn.Module]:
        return [getattr(self, name) for name in self.model_names]

    @classmethod
    def from_config(
        cls,
        text_model_and_configs: Sequence[tuple],
        device="cuda",
        dtype=torch.float32,
        zero_for_padding: bool = True,
        use_normed_ctx: bool = False,
        pad_context_to: int | None = None,
    ) -> "ConcatTextEncoders":
        """``[(model_cfg, extra_cfg), ...]`` with ``model_cfg`` a dict
        holding ``model_type`` (``clip`` or ``t5``), ``preset`` and/or the
        model's arguments."""
        models, configs = [], []
        for model_cfg, extra_cfg in text_model_and_configs:
            models.append(_build_text_model(model_cfg, device, dtype))
            if not isinstance(extra_cfg, TextModelExtraConfig):
                extra_cfg = TextModelExtraConfig(**extra_cfg)
            configs.append(extra_cfg)
        return cls(models, configs, zero_for_padding, use_normed_ctx, pad_context_to)

    def forward(self, tokenizer_outputs):
        n_buckets = max(c.concat_bucket for c in self.configs) + 1
        attn_masks = [None] * n_buckets
        embs = [[] for _ in range(n_buckets)]
        normed = [[] for _ in range(n_buckets)]
        pooled = [[] for _ in range(n_buckets)]
        for tokens, name, config in zip(tokenizer_outputs, self.model_names, self.configs):
            model = getattr(self, name)
            input_ids, attn_mask = tokens["input_ids"], tokens["attention_mask"]
            bucket = config.concat_bucket
            if attn_masks[bucket] is None and config.need_mask and not config.pooled_only:
                attn_masks[bucket] = attn_mask
            if isinstance(model, CLIPTextModel):
                b, s = input_ids.shape
                win = model.max_position_embeddings
                if s % win and s > win:
                    raise ValueError(f"sequence {s} is not a multiple of the CLIP window {win}: tokenize long"
                                     " prompts with encode(long_prompt=True)")
                n = max(s // win, 1)  # windows ride the batch: [B, n * win] -> [B * n, win]
                out = model(input_ids.reshape(b * n, -1), attn_mask.reshape(b * n, -1), layer_idx=config.layer_idx)
                embedding = out.embedding.reshape(b, s, -1)
                normed_embedding = out.normed_embedding.reshape(b, s, -1)
                pool = out.pooler_output.reshape(b, n, -1)[:, 0]  # the first window's
            else:  # T5: the last hidden state, no pooled vector
                out = model(input_ids, attn_mask)
                embedding = normed_embedding = out.last_hidden_state
                pool = None
            if self.zero_for_padding:
                m = attn_mask[..., None].to(embedding.dtype)
                embedding = embedding * m
                normed_embedding = normed_embedding * m
            if not config.pooled_only:
                embs[bucket].append(embedding)
                normed[bucket].append(normed_embedding)
            if config.use_pooled and pool is not None:
                pooled[bucket].append(pool)

        emb_b = [_cat(e, -1) for e in embs]
        normed_b = [_cat(e, -1) for e in normed]
        pooled_b = [_cat(p, -1) for p in pooled]
        max_dim = max(e.shape[-1] for e in emb_b if e is not None)
        if self.pad_context_to is not None:
            max_dim = max(max_dim, self.pad_context_to)

        def pad_feat(e):
            if e is None or e.shape[-1] == max_dim:
                return e
            return F.pad(e, (0, max_dim - e.shape[-1]))

        emb_b = [pad_feat(e) for e in emb_b]
        normed_b = [pad_feat(e) for e in normed_b]
        attn_mask_out = None
        if any(m is not None for m in attn_masks):
            full = [
                (torch.ones(e.shape[:2], dtype=torch.int32, device=e.device)
                 if attn_masks[i] is None else attn_masks[i].to(torch.int32))
                for i, e in enumerate(emb_b) if e is not None
            ]
            attn_mask_out = torch.cat(full, dim=1)
        pooled_out = _cat([p for p in pooled_b if p is not None], -1)
        embedding_out = torch.cat([e for e in emb_b if e is not None], dim=1)
        normed_out = torch.cat([e for e in normed_b if e is not None], dim=1)
        return embedding_out, normed_out, pooled_out, attn_mask_out


class TextEncodingPipeline:
    """Host-side companion: tokenizers + the encoder module on ``device``."""

    def __init__(self, module: ConcatTextEncoders, tokenizers: Sequence, device="cuda"):
        self.module = module
        self.tokenizers = list(tokenizers)
        self.device = resolve_device(device)

    @property
    def use_normed_ctx(self) -> bool:
        return self.module.use_normed_ctx

    def tokenize(self, text, **kwargs):
        return [tok(text, **kwargs) for tok in self.tokenizers]

    @torch.inference_mode()
    def forward(self, tokenizer_outputs):
        tensors = [
            {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in t.items()}
            for t in tokenizer_outputs
        ]
        return self.module(tensors)

    def encode(self, text, nested: bool = False, prompt_weighting: bool = False, long_prompt: bool = False,
               max_chunks: int | None = None, **kwargs):
        """str | list[str] -> (embedding, normed_embedding, pooled, mask).
        ``prompt_weighting`` parses ``(emphasis:1.3)`` and scales the token
        embeddings; ``long_prompt`` chunks past the CLIP window into
        ``max_chunks`` windows (default: as many as the longest prompt
        needs); the two compose."""
        if nested:
            if long_prompt or prompt_weighting:
                flag = "long_prompt" if long_prompt else "prompt_weighting"
                raise NotImplementedError(f"{flag} with nested caption lists is not supported")
            raise NotImplementedError("nested caption lists are not ported yet")
        if long_prompt:
            from uwudiff_tpu_torch.models.long_prompt import encode_long

            return encode_long(self, text, max_chunks=max_chunks, weighted=prompt_weighting)
        if prompt_weighting:
            from uwudiff_tpu_torch.models.prompt_weights import encode_weighted

            return encode_weighted(self, text)
        return self.forward(self.tokenize(text, **kwargs))
