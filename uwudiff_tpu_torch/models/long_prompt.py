"""Prompts longer than CLIP's 77 positions (``uwudiff_tpu/models/long_prompt.py``).

The raw token stream is cut into windows of ``model_max_length - 2``
tokens, breaking after the last comma within the final ``backtrack``
positions of a full window where there is one, each window wrapped in its
own BOS/EOS. The host builds fixed-shape ``[B, n * L]`` ids, mask and
weights; ``ConcatTextEncoders`` reshapes them to ``[B * n, L]`` around each
CLIP, so every window of the batch is one encoder call, concatenates the
hidden states back along the sequence and takes the pooled vector of the
first window. Encoders without the 77-position wall (T5's relative bias)
keep one window. Prompt weights ride with their tokens.
"""

from __future__ import annotations

import numpy as np

from uwudiff_tpu_torch.models.prompt_weights import (
    apply_token_weights,
    bucket_weights,
    parse_weighted_prompt,
    tokenize_with_weights,
)

__all__ = ["chunk_token_stream", "encode_long", "required_chunks", "tokenize_long"]

# A1111's comma_padding_backtrack default
_BACKTRACK = 20


def _raw_ids(tok, text: str) -> list[int]:
    return [int(i) for i in tok.tokenize(text)]


def _comma_id(tok) -> int | None:
    ids = _raw_ids(tok, ",")
    return ids[0] if len(ids) == 1 else None


def _is_windowed(tok, model=None) -> bool:
    """Chunk this encoder? Only an absolute-position CLIP tower has the
    77-token wall; without a model, a tokenizer with a BOS token."""
    if model is not None:
        from uwudiff_tpu_torch.models.clip import CLIPTextModel

        return isinstance(model, CLIPTextModel)
    return getattr(tok, "bos_token_id", None) is not None


def chunk_token_stream(ids: list[int], weights: list[float], limit: int, comma_id: int | None = None,
                       backtrack: int = _BACKTRACK) -> list[tuple[list[int], list[float]]]:
    """Split a raw (no BOS/EOS) token stream into windows of at most
    ``limit`` tokens, a full window ending after its last comma among the
    trailing ``backtrack`` positions when it has one."""
    chunks: list[tuple[list[int], list[float]]] = []
    cur_i: list[int] = []
    cur_w: list[float] = []
    for i, w in zip(ids, weights):
        cur_i.append(i)
        cur_w.append(w)
        if len(cur_i) == limit:
            cut = limit
            if comma_id is not None and backtrack > 0:
                for j in range(limit - 1, max(0, limit - backtrack) - 1, -1):
                    if cur_i[j] == comma_id:
                        cut = j + 1
                        break
            chunks.append((cur_i[:cut], cur_w[:cut]))
            cur_i, cur_w = cur_i[cut:], cur_w[cut:]
    if cur_i or not chunks:
        chunks.append((cur_i, cur_w))
    return chunks


def _text_chunks(tok, text: str, weighted: bool):
    """One prompt -> its (ids, weights) windows, no specials yet."""
    if weighted:
        ids: list[int] = []
        wts: list[float] = []
        for frag, w in parse_weighted_prompt(text):
            frag_ids = _raw_ids(tok, frag)
            ids.extend(frag_ids)
            wts.extend([w] * len(frag_ids))
    else:
        ids = _raw_ids(tok, text)
        wts = [1.0] * len(ids)
    return chunk_token_stream(ids, wts, tok.model_max_length - 2, _comma_id(tok))


def tokenize_long(tok, texts: list[str], max_chunks: int | None = None, weighted: bool = False):
    """The windowed ``tok(texts, padding="max_length")``: ``({input_ids,
    attention_mask} [B, n * L], float32 weights [B, n * L], n)``. A prompt
    with fewer windows than n is padded with empty-prompt windows (BOS + EOS
    only)."""
    if isinstance(texts, str):
        texts = [texts]
    L = tok.model_max_length
    per_text = [_text_chunks(tok, t, weighted) for t in texts]
    n = max(len(c) for c in per_text)
    if max_chunks is not None:
        per_text = [c[:max_chunks] for c in per_text]
        n = max_chunks
    n = max(n, 1)
    bos, eos, pad = tok.bos_token_id, tok.eos_token_id, tok.pad_token_id
    ids_b, mask_b, w_b = [], [], []
    for chunks in per_text:
        ids_row: list[int] = []
        mask_row: list[int] = []
        w_row: list[float] = []
        for k in range(n):
            c_ids, c_wts = chunks[k] if k < len(chunks) else ([], [])
            window = [bos] + c_ids + [eos]
            pad_n = L - len(window)
            ids_row += window + [pad] * pad_n
            mask_row += [1] * len(window) + [0] * pad_n
            w_row += [1.0] + c_wts + [1.0] + [1.0] * pad_n
        ids_b.append(ids_row)
        mask_b.append(mask_row)
        w_b.append(w_row)
    return (
        {"input_ids": np.asarray(ids_b, dtype=np.int32), "attention_mask": np.asarray(mask_b, dtype=np.int32)},
        np.asarray(w_b, dtype=np.float32),
        n,
    )


def _windows(pipe, texts, weighted: bool) -> int:
    n = 1
    for tok, model in zip(pipe.tokenizers, pipe.module.text_models):
        if _is_windowed(tok, model):
            for t in texts:
                n = max(n, len(_text_chunks(tok, t, weighted)))
    return n


def required_chunks(pipe, texts) -> int:
    """The windows ``texts`` need across the pipeline's windowed
    tokenizers (to bring cond and uncond to one shape)."""
    return _windows(pipe, [texts] if isinstance(texts, str) else texts, weighted=False)


def encode_long(pipe, texts, max_chunks: int | None = None, weighted: bool = False, **tokenize_kwargs):
    """The windowed ``TextEncodingPipeline.encode``: every windowed
    tokenizer chunks to one window count (vocabularies differ, a bucket's
    feature concat needs one n), the others keep one window; with
    ``weighted`` the emphasis weights chunk with their tokens."""
    if isinstance(texts, str):
        texts = [texts]
    module = pipe.module
    if max_chunks is None:
        max_chunks = _windows(pipe, texts, weighted)
    tok_outs, enc_weights = [], []
    for tok, model in zip(pipe.tokenizers, module.text_models):
        if _is_windowed(tok, model):
            out, w, _ = tokenize_long(tok, texts, max_chunks=max_chunks, weighted=weighted)
        elif weighted:
            out, w = tokenize_with_weights(tok, texts)
        else:
            out = tok(texts, padding="max_length", truncation=True, **tokenize_kwargs)
            w = np.ones(out["input_ids"].shape, dtype=np.float32)
        tok_outs.append(out)
        enc_weights.append(w)
    emb, normed, pooled, mask = pipe.forward(tok_outs)
    if weighted:
        w_full = bucket_weights(module, enc_weights, emb.shape[1])
        emb, normed = apply_token_weights(emb, w_full), apply_token_weights(normed, w_full)
    return emb, normed, pooled, mask
