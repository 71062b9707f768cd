"""Classifier-free guidance (``uwudiff_tpu/sampling/cfg.py``).

Text encoding happens once per request batch (:func:`encode_cfg_inputs`:
SDXL's stack with its micro-conditioning ids, or Flux's, whose pooled
vector comes from the pooled-only CLIP slot and whose key mask is T5's;
a model without ``time_ids`` ignores them);
:func:`build_cfg_fn` returns ``model_fn(x, sigma, sigma_cond=None) ->
(guided, uncond)`` that runs the denoiser on the doubled cond|uncond batch
in one call and combines with the CFG scale, over every sigma or only
those in ``cfg_interval``. :func:`cfg_wrapper` encodes and builds in one
call; :func:`cond_text_wrapper` is a single conditional pass.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from uwudiff_tpu_torch.utils import append_dims

__all__ = [
    "apply_cfg_rescale",
    "build_cfg_fn",
    "cfg_wrapper",
    "cond_text_wrapper",
    "default_time_ids",
    "encode_cfg_inputs",
]


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


def cond_text_wrapper(prompt, width: int, height: int, unet: Callable, te, time_ids=None) -> Callable:
    """The single-conditioning model fn (no CFG): ``(denoised, None)``."""
    emb, normed_emb, pool, mask = te.encode(prompt, padding=True, truncation=True)
    if te.use_normed_ctx:
        emb = normed_emb
    if time_ids is None:
        time_ids = default_time_ids(height, width, emb.shape[0], emb.device)
    added_cond = {"time_ids": time_ids, "text_embeds": pool} if pool is not None else None

    def model_fn(x, sigma, sigma_cond=None):
        denoised = unet(x, sigma, sigma_cond=sigma_cond, encoder_hidden_states=emb,
                        encoder_attention_mask=mask, added_cond=added_cond)
        return denoised, None

    return model_fn


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


def build_cfg_fn(unet: Callable, enc: dict, cfg: float, cfg_rescale: float = 0.0,
                 cfg_interval: tuple[float, float] | None = None) -> Callable:
    """The doubled-batch model fn; ``cfg == 1`` runs the conditional half
    only. ``cfg_interval=(lo, hi)`` guides only the samples whose sigma lies
    in [lo, hi] (Kynkaanniemi et al. 2024), the plain conditional output
    elsewhere; the choice is made on the device, per sample."""
    if cfg == 1.0:
        n = enc["ctx"].shape[0] // 2

        def cond_fn(x, sigma, sigma_cond=None):
            out = unet(
                x, sigma, sigma_cond=sigma_cond,
                encoder_hidden_states=enc["ctx"][:n],
                encoder_attention_mask=enc["mask"][:n] if enc["mask"] is not None else None,
                added_cond=(
                    {k: v[:n] for k, v in enc["added_cond"].items()}
                    if enc["added_cond"] is not None else None
                ),
            )
            return out, out

        return cond_fn

    def cfg_fn(x, sigma, sigma_cond=None):
        if sigma_cond is not None:
            sigma_cond = torch.cat([sigma_cond, sigma_cond])
        out = unet(
            torch.cat([x, x]), torch.cat([sigma, sigma]), sigma_cond=sigma_cond,
            encoder_hidden_states=enc["ctx"], encoder_attention_mask=enc["mask"],
            added_cond=enc["added_cond"],
        )
        cond, uncond = out.chunk(2)
        scale = cfg
        if cfg_interval is not None:
            lo, hi = cfg_interval
            in_window = (sigma >= lo) & (sigma <= hi)
            scale = append_dims(torch.where(in_window, cfg, 1.0).to(x.dtype), x.dim())
        cfg_output = uncond + (cond - uncond) * scale
        return apply_cfg_rescale(cfg_output, cond, cfg_rescale), uncond

    return cfg_fn


def cfg_wrapper(prompt, neg_prompt, width: int, height: int, unet: Callable, te, cfg: float = 5.0,
                time_ids=None) -> Callable:
    """Encode, then :func:`build_cfg_fn`: ``uncond + (cond - uncond) * cfg``."""
    return build_cfg_fn(unet, encode_cfg_inputs(prompt, neg_prompt, width, height, te, time_ids), cfg)
