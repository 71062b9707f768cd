"""A1111-style prompt emphasis (``uwudiff_tpu/models/prompt_weights.py``).

``(text)`` multiplies a run's weight by 1.1 (nesting compounds), ``[text]``
divides it by 1.1, ``(text:1.5)`` sets it, and ``\\(`` ``\\)`` ``\\[``
``\\]`` ``\\\\`` escape literals. The prompt is parsed into (fragment,
weight) runs on the host, each fragment tokenized through the same
tokenizer, and after the encode each token's embedding is scaled by its
weight on the device, then each sample rescaled so its mean matches the
unweighted encoding's. The context keeps its shape.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["apply_token_weights", "encode_weighted", "parse_weighted_prompt", "tokenize_with_weights"]

_UP = 1.1
_DOWN = 1.0 / 1.1

_TOKEN_RE = re.compile(
    r"""
    \\[()\[\]\\:]          # escaped literal
    | \(                   # open emphasis
    | \[                   # open de-emphasis
    | :\s*([+-]?\d+\.?\d*)\s*\)   # explicit weight close
    | \)
    | \]
    | [^\\()\[\]:]+        # plain text run
    | :                    # bare colon is literal
    | \\                   # lone backslash is literal too
    """,
    re.X,
)


def parse_weighted_prompt(text: str) -> list[tuple[str, float]]:
    """Emphasis syntax -> ``[(fragment, weight)]``, adjacent runs of equal
    weight merged, empty fragments dropped."""
    res: list[list] = []  # [text, weight]
    round_stack: list[int] = []
    square_stack: list[int] = []

    def multiply(start: int, mult: float):
        for i in range(start, len(res)):
            res[i][1] *= mult

    for m in _TOKEN_RE.finditer(text):
        tok, explicit = m.group(0), m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:] or "\\", 1.0])  # "\(" -> "("; a lone "\" stays
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif explicit is not None:
            if round_stack:
                multiply(round_stack.pop(), float(explicit))
            else:  # a stray ":1.5)" is literal text
                res.append([tok, 1.0])
        elif tok == ")" and round_stack:
            multiply(round_stack.pop(), _UP)
        elif tok == "]" and square_stack:
            multiply(square_stack.pop(), _DOWN)
        else:
            res.append([tok, 1.0])
    # unclosed brackets still weigh their tail
    for pos in round_stack:
        multiply(pos, _UP)
    for pos in square_stack:
        multiply(pos, _DOWN)

    merged: list[list] = []
    for t, w in res:
        if merged and abs(merged[-1][1] - w) < 1e-9:
            merged[-1][0] += t
        else:
            merged.append([t, w])
    return [(t, w) for t, w in merged if t]


def tokenize_with_weights(tok, texts: list[str], max_length: int | None = None):
    """The weighted ``tok(texts, padding="max_length")``: each fragment
    tokenized alone (``tok.tokenize``), its tokens carrying its weight; BOS,
    EOS and padding weigh 1. Returns ``({input_ids, attention_mask}, float32
    weights [B, S])``."""
    max_length = max_length or tok.model_max_length
    bos = getattr(tok, "bos_token_id", None)  # T5-style tokenizers have none
    ids_batch, mask_batch, w_batch = [], [], []
    for text in texts:
        ids: list[int] = [] if bos is None else [bos]
        wts: list[float] = [] if bos is None else [1.0]
        for frag, w in parse_weighted_prompt(text):
            frag_ids = [int(i) for i in tok.tokenize(frag)]
            ids.extend(frag_ids)
            wts.extend([w] * len(frag_ids))
        ids.append(tok.eos_token_id)
        wts.append(1.0)
        if len(ids) > max_length:
            ids = ids[: max_length - 1] + [tok.eos_token_id]
            wts = wts[: max_length - 1] + [1.0]
        mask = [1] * len(ids)
        pad_n = max_length - len(ids)
        ids_batch.append(ids + [tok.pad_token_id] * pad_n)
        mask_batch.append(mask + [0] * pad_n)
        w_batch.append(wts + [1.0] * pad_n)
    return (
        {"input_ids": np.asarray(ids_batch, dtype=np.int32), "attention_mask": np.asarray(mask_batch, dtype=np.int32)},
        np.asarray(w_batch, dtype=np.float32),
    )


def apply_token_weights(emb: torch.Tensor, weights) -> torch.Tensor:
    """Scale the token embeddings ``[B, S, D]`` by per-token ``weights``
    ``[B, S]``, then restore each sample's mean (the emphasis moves the
    direction, not the magnitude); a new mean within 1e-7 of zero skips the
    rescale."""
    w = torch.as_tensor(weights, device=emb.device).to(emb.dtype)[..., None]
    scaled = emb * w
    prev_mean = emb.mean(dim=(1, 2), keepdim=True)
    new_mean = scaled.mean(dim=(1, 2), keepdim=True)
    ratio = torch.where(new_mean.abs() > 1e-7, prev_mean / new_mean, torch.ones_like(new_mean))
    return scaled * ratio


def bucket_weights(module, enc_weights, seq_len: int) -> np.ndarray:
    """The weights of the assembled context: the buckets in order, sequence
    concat across them, each bucket's first encoder's weights (the encoders
    of a bucket share the token alignment)."""
    buckets: dict[int, np.ndarray] = {}
    for cfg, w in zip(module.configs, enc_weights):
        buckets.setdefault(cfg.concat_bucket, w)
    w_full = np.concatenate([buckets[b] for b in sorted(buckets)], axis=1)
    if w_full.shape[1] != seq_len:
        raise ValueError(f"token-weight length {w_full.shape[1]} != encoded sequence {seq_len}")
    return w_full


def encode_weighted(pipe, texts):
    """The weighted ``TextEncodingPipeline.encode``: each tokenizer's
    weighted tokens, one forward, the token weights applied to the context
    and its normed twin."""
    if isinstance(texts, str):
        texts = [texts]
    tok_outs, enc_weights = zip(*(tokenize_with_weights(tok, texts) for tok in pipe.tokenizers))
    emb, normed, pooled, mask = pipe.forward(list(tok_outs))
    w_full = bucket_weights(pipe.module, enc_weights, emb.shape[1])
    return apply_token_weights(emb, w_full), apply_token_weights(normed, w_full), pooled, mask
