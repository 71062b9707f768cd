"""Host-side tokenizers (``uwudiff_tpu/models/tokenizers.py``).

``SimpleTokenizer`` is the deterministic hash tokenizer that the JAX
trainer falls back to when no tokenizer is configured; its ids equal the
JAX package's for the same text, textual-inversion placeholders
included. The CLIP BPE and T5 SentencePiece tokenizers wait until their
vocabulary files are in the repository.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

__all__ = ["SimpleTokenizer"]


def _split_on_added(text: str, added: dict[str, list[int]]):
    """Yield ("ids", expansion) for placeholder hits (case-insensitive, keys
    stored lowercase) and ("text", segment) for everything else.
    Placeholders with alphanumeric edges match at word boundaries only
    ("sks" not inside "tasks"); "<concept>" matches next to punctuation."""
    parts = []
    for k in added:
        p = re.escape(k)
        if k[0].isalnum():
            p = r"(?<![a-z0-9])" + p
        if k[-1].isalnum():
            p = p + r"(?![a-z0-9])"
        parts.append(p)
    for part in re.split("(" + "|".join(parts) + ")", text, flags=re.IGNORECASE):
        if part is None:
            continue
        key = part.lower()
        if key in added:
            yield ("ids", added[key])
        elif part.strip():
            yield ("text", part)


class SimpleTokenizer:
    """ids: 0=pad, 1=bos, 2=eos, words hash into [3, vocab_size)."""

    def __init__(
        self,
        vocab_size: int = 1024,
        model_max_length: int = 77,
        pad_token_id: int = 0,
        bos_token_id: int = 1,
        eos_token_id: int = 2,
    ):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.added_tokens: dict[str, list[int]] = {}

    def add_placeholder(self, token: str, ids: list[int]) -> None:
        """Register a textual-inversion placeholder that expands to ``ids``."""
        self.added_tokens[str(token).lower()] = [int(i) for i in ids]

    def tokenize(self, text: str) -> list[int]:
        """Raw word ids, no special tokens; placeholders expand to their ids."""
        if not self.added_tokens:
            return [self._word_id(w) for w in text.lower().split()]
        ids: list[int] = []
        for kind, val in _split_on_added(text, self.added_tokens):
            ids.extend(val if kind == "ids" else (self._word_id(w) for w in val.lower().split()))
        return ids

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode("utf-8")).digest()[:4], "little")
        return 3 + h % (self.vocab_size - 3)

    def __call__(
        self,
        text: str | list[str],
        padding: bool | str = "max_length",
        truncation: bool = True,
        max_length: int | None = None,
    ) -> dict[str, np.ndarray]:
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        ids_batch, mask_batch = [], []
        for t in text:
            ids = [self.bos_token_id] + self.tokenize(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding in (True, "max_length", "longest"):
                pad_n = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad_n
                mask = mask + [0] * pad_n
            ids_batch.append(ids)
            mask_batch.append(mask)
        longest = max(len(i) for i in ids_batch)
        ids_batch = [i + [self.pad_token_id] * (longest - len(i)) for i in ids_batch]
        mask_batch = [m + [0] * (longest - len(m)) for m in mask_batch]
        return {
            "input_ids": np.asarray(ids_batch, dtype=np.int32),
            "attention_mask": np.asarray(mask_batch, dtype=np.int32),
        }
