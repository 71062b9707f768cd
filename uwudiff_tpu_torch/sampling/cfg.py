"""Classifier-free guidance (``uwudiff_tpu/sampling/cfg.py``).

Text encoding happens once per request batch (:func:`encode_cfg_inputs`:
SDXL's stack with its micro-conditioning ids, or Flux's, whose pooled
vector comes from the pooled-only CLIP slot and whose key mask is T5's;
a model without ``time_ids`` ignores them);
:func:`build_cfg_fn` returns ``model_fn(x, sigma)`` that runs
the denoiser on the doubled cond|uncond batch in one call and combines
with the CFG scale. The ``cfg_interval`` option waits for a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["default_time_ids", "encode_cfg_inputs", "apply_cfg_rescale", "build_cfg_fn"]


def default_time_ids(height: int, width: int, batch: int, device="cpu") -> torch.Tensor:
    """SDXL micro-conditioning ids: org_h/w, crop, target_h/w."""
    row = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32, device=device)
    return row.repeat(batch, 1)


def _pad_seq(emb, mask, target_len):
    cur = emb.shape[1]
    if cur >= target_len:
        return emb, mask
    emb = F.pad(emb, (0, 0, 0, target_len - cur))
    if mask is not None:
        mask = F.pad(mask, (0, target_len - cur))
    return emb, mask


def encode_cfg_inputs(prompt, neg_prompt, width: int, height: int, te, time_ids=None) -> dict:
    """Encode cond and uncond prompts and assemble the doubled-batch
    conditioning: ``{"ctx", "mask", "added_cond"}``."""
    n = len(prompt)
    if len(neg_prompt) == n:  # one TE forward for cond+uncond
        both = te.encode(list(prompt) + list(neg_prompt), padding=True, truncation=True)
        emb, normed_emb, pool, mask = (None if t is None else t[:n] for t in both)
        neg_emb, normed_neg_emb, neg_pool, neg_mask = (None if t is None else t[n:] for t in both)
    else:
        emb, normed_emb, pool, mask = te.encode(prompt, padding=True, truncation=True)
        neg_emb, normed_neg_emb, neg_pool, neg_mask = te.encode(
            neg_prompt, padding=True, truncation=True
        )
    if te.use_normed_ctx:
        emb, neg_emb = normed_emb, normed_neg_emb
    device = emb.device
    if time_ids is None:
        time_ids = default_time_ids(height, width, 2 * emb.shape[0], device)
    else:
        time_ids = torch.as_tensor(time_ids, device=device).repeat(2, 1)
    added_cond = (
        {"time_ids": time_ids, "text_embeds": torch.cat([pool, neg_pool])}
        if pool is not None else None
    )
    target = max(emb.shape[1], neg_emb.shape[1])
    emb, mask = _pad_seq(emb, mask, target)
    neg_emb, neg_mask = _pad_seq(neg_emb, neg_mask, target)
    attn_mask = torch.cat([mask, neg_mask]) if mask is not None and neg_mask is not None else None
    return {"ctx": torch.cat([emb, neg_emb]), "mask": attn_mask, "added_cond": added_cond}


def apply_cfg_rescale(cfg_output, cond, rescale: float):
    """CFG rescale (Lin et al. 2023 §3.4); ``rescale == 0`` is plain CFG."""
    if rescale == 0.0:
        return cfg_output
    dims = tuple(range(1, cfg_output.dim()))
    std_cond = cond.std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = cfg_output.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = cfg_output * (std_cond / std_cfg.clamp_min(1e-8))
    return rescale * rescaled + (1.0 - rescale) * cfg_output


def build_cfg_fn(unet: Callable, enc: dict, cfg: float, cfg_rescale: float = 0.0) -> Callable:
    """The doubled-batch model fn; ``cfg == 1`` runs the conditional half only."""
    if cfg == 1.0:
        n = enc["ctx"].shape[0] // 2

        def cond_fn(x, sigma):
            out = unet(
                x, sigma,
                encoder_hidden_states=enc["ctx"][:n],
                encoder_attention_mask=enc["mask"][:n] if enc["mask"] is not None else None,
                added_cond=(
                    {k: v[:n] for k, v in enc["added_cond"].items()}
                    if enc["added_cond"] is not None else None
                ),
            )
            return out, out

        return cond_fn

    def cfg_fn(x, sigma):
        out = unet(
            torch.cat([x, x]), torch.cat([sigma, sigma]),
            encoder_hidden_states=enc["ctx"], encoder_attention_mask=enc["mask"],
            added_cond=enc["added_cond"],
        )
        cond, uncond = out.chunk(2)
        cfg_output = uncond + (cond - uncond) * cfg
        return apply_cfg_rescale(cfg_output, cond, cfg_rescale), uncond

    return cfg_fn
