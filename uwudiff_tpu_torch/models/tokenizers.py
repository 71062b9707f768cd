r"""Host-side tokenizers (``uwudiff_tpu/models/tokenizers.py``).

- ``CLIPBPETokenizer``: CLIP's byte-level BPE over a ``vocab.json`` +
  ``merges.txt`` pair, with no ``regex`` or ``transformers``: CLIP's split
  pattern (``\p{L}+``, one ``\p{N}``, runs of anything else but spaces)
  is a scan that classes each character by ``unicodedata.category``.
- ``T5SPTokenizer`` (``spiece.py``): the T5 SentencePiece unigram.
- ``SimpleTokenizer``: the deterministic hash tokenizer the JAX trainer
  falls back to when no tokenizer is configured.

Each one's ids equal the JAX package's for the same text,
textual-inversion placeholders included. ``load_hf_tokenizer`` needs
``transformers`` and is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import hashlib
import json
import re
import unicodedata
from functools import lru_cache

import numpy as np

from uwudiff_tpu_torch.models.spiece import T5SPTokenizer

__all__ = ["CLIPBPETokenizer", "SimpleTokenizer", "T5SPTokenizer", "clamp_tokenizer_length", "load_hf_tokenizer"]


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP's reversible byte -> printable character table: printable
    latin bytes map to themselves, the others to U+0100 onwards."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


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


# CLIP's split pattern, as the JAX class compiles it with ``regex`` (case
# insensitive): the two specials, the contractions, then ``[\p{L}]+``,
# ``[\p{N}]`` and ``[^\s\p{L}\p{N}]+``; characters none of them takes
# (spaces) are skipped
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# after lower(), the one character that matches an ASCII letter of the
# pattern case-insensitively: the long s
_FOLD = str.maketrans({"\u017f": "s"})
# U+0345 (combining ypogegrammeni) folds to a letter: the case-insensitive
# [^\s\p{L}\p{N}] refuses it and \p{L} does not take it, so it splits
_SKIPPED = frozenset("\u0345")
_LETTER, _NUMBER, _OTHER, _SPACE = range(4)


def _is_space(ch: str) -> bool:
    r"""``regex``'s ``\s``: ``str.isspace`` but for the separators U+001C-U+001F."""
    return ch.isspace() and not "\x1c" <= ch <= "\x1f"


def _char_class(ch: str) -> int:
    if _is_space(ch) or ch in _SKIPPED:
        return _SPACE
    cat = unicodedata.category(ch)[0]
    return _LETTER if cat == "L" else _NUMBER if cat == "N" else _OTHER


def _collapse_spaces(text: str) -> str:
    r"""Runs of ``\s`` -> one space (the JAX class's ``regex.sub(r"\s+", " ")``)."""
    out, prev_space = [], False
    for ch in text:
        space = _is_space(ch)
        if not (space and prev_space):
            out.append(" " if space else ch)
        prev_space = space
    return "".join(out)


def _clip_split(text: str) -> list[str]:
    """``findall`` of CLIP's pattern over lower-cased ``text``."""
    chunks, i, n = [], 0, len(text)
    while i < n:
        hit = next((lit for lit in _SPECIALS + _CONTRACTIONS
                    if text[i:i + len(lit)].translate(_FOLD) == lit), None)
        if hit is not None:
            chunks.append(text[i:i + len(hit)])
            i += len(hit)
            continue
        kind = _char_class(text[i])
        if kind == _SPACE:
            i += 1
            continue
        j = i + 1
        if kind != _NUMBER:  # letters and others run on; a number is one character
            while j < n and _char_class(text[j]) == kind:
                j += 1
        chunks.append(text[i:j])
        i = j
    return chunks


class CLIPBPETokenizer:
    """CLIP's byte-level BPE over the ``vocab.json`` + ``merges.txt`` pair
    every CLIP checkpoint ships: spaces collapsed and lower case, CLIP's
    split, utf-8 bytes to printable characters, the lowest-rank merges first
    with a ``</w>`` end-of-word marker, then ``<|startoftext|> ids
    <|endoftext|>``, truncation keeping the final EOS, padding to
    ``max_length`` with ``pad_token`` (default EOS, as CLIP-L; SDXL's second
    tokenizer pads with ``!``)."""

    def __init__(self, vocab_file: str, merges_file: str, model_max_length: int = 77,
                 pad_token: str | None = None):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # the first line is the "#version:" header
        merges = [tuple(line.split()) for line in lines[1:] if line and len(line.split()) == 2]
        self.merge_rank = {pair: i for i, pair in enumerate(merges)}
        self.byte_enc = _byte_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token, self.eos_token = _SPECIALS
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        self.pad_token = pad_token or self.eos_token
        self.pad_token_id = self.encoder[self.pad_token]
        self.vocab_size = len(self.encoder)
        self._bpe_cache: dict[str, list[str]] = {}
        self.added_tokens: dict[str, list[int]] = {}

    def _bpe(self, token: str) -> list[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            merged: list[str] = []
            i = 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == best[0] and parts[i + 1] == best[1]:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._bpe_cache[token] = parts
        return parts

    def add_placeholder(self, token: str, ids: list[int]) -> None:
        """Register a textual-inversion placeholder: every occurrence of
        ``token`` (any case, next to punctuation too) expands to ``ids``."""
        self.added_tokens[str(token).lower()] = [int(i) for i in ids]

    def tokenize(self, text: str) -> list[int]:
        """Raw BPE ids of one string, no special tokens."""
        if not self.added_tokens:
            return self._tokenize_plain(text)
        ids: list[int] = []
        for kind, val in _split_on_added(text, self.added_tokens):
            ids.extend(val if kind == "ids" else self._tokenize_plain(val))
        return ids

    def _tokenize_plain(self, text: str) -> list[int]:
        text = _collapse_spaces(text).strip().lower()
        ids: list[int] = []
        unk = self.encoder.get(self.eos_token)
        for chunk in _clip_split(text):
            if chunk in _SPECIALS:
                ids.append(self.encoder[chunk])
                continue
            mapped = "".join(self.byte_enc[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder.get(piece, unk) for piece in self._bpe(mapped))
        return ids

    def __call__(self, text: str | list[str], padding: bool | str = "max_length", truncation: bool = True,
                 max_length: int | None = None, return_tensors: str | None = None) -> dict[str, np.ndarray]:
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
                ids += [self.pad_token_id] * pad_n
                mask += [0] * pad_n
            ids_batch.append(ids)
            mask_batch.append(mask)
        longest = max(len(i) for i in ids_batch)
        ids_batch = [i + [self.pad_token_id] * (longest - len(i)) for i in ids_batch]
        mask_batch = [m + [0] * (longest - len(m)) for m in mask_batch]
        return {
            "input_ids": np.asarray(ids_batch, dtype=np.int32),
            "attention_mask": np.asarray(mask_batch, dtype=np.int32),
        }


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


def load_hf_tokenizer(name_or_path: str, max_length: int = 256):
    """A local HuggingFace tokenizer: needs ``transformers``, which the port
    does not depend on."""
    raise NotImplementedError(
        "load_hf_tokenizer needs transformers and is not ported (ROADMAP.md, Queue 1: load_hf_tokenizer);"
        " build CLIPBPETokenizer(vocab.json, merges.txt) or T5SPTokenizer(spiece.model) instead"
    )


def clamp_tokenizer_length(tokenizer, max_length: int = 256):
    """Pad with EOS where the tokenizer has no pad token, and cap
    ``model_max_length`` at ``max_length``."""
    if not getattr(tokenizer, "pad_token", None):
        tokenizer.pad_token = tokenizer.eos_token
    if tokenizer.model_max_length > max_length:
        tokenizer.model_max_length = max_length
    return tokenizer
