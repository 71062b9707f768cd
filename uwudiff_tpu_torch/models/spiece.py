"""SentencePiece-unigram tokenizer for the T5 family (``uwudiff_tpu/models/spiece.py``).

Pure Python over the two on-disk formats a T5 checkpoint ships, with no
``sentencepiece``, ``tokenizers`` or protobuf runtime:

- ``spiece.model``: a SentencePiece ``ModelProto``, read with a minimal
  wire-format reader (field 1: ``SentencePiece {piece = 1, score = 2,
  type = 3}``; the trainer and normalizer specs are skipped);
- ``tokenizer.json``: the HF-converted unigram model.

Encoding is the unigram Viterbi (the segmentation with the largest sum of
piece log-probabilities), as the HF conversion of T5 does it:
user-defined symbols (``<extra_id_N>``) split out first and map to their
ids; metaspace pre-tokenization (`` `` -> ``▁``, a dummy prefix); runs of
unknown characters fuse into one ``<unk>``; ``</s>`` appended, ``<pad>``
padding, truncation keeping the final ``</s>``. Normalization is NFKC,
control characters dropped, spaces unified and collapsed (T5's nmt_nfkc
charsmap differs only on rare legacy codepoints). Its ids equal the JAX
package's (``tests/test_torch_tokenizers.py``).
"""

from __future__ import annotations

import json
import os
import struct
import unicodedata

import numpy as np

__all__ = ["T5SPTokenizer", "parse_sentencepiece_model", "serialize_sentencepiece_model"]

# SentencePiece piece types (sentencepiece_model.proto enum)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


# -- minimal protobuf wire reader -------------------------------------


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(data, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def _parse_piece(data: bytes) -> tuple[str, float, int]:
    """One ``SentencePiece`` message: piece=1 (string), score=2
    (float), type=3 (enum, default NORMAL)."""
    piece, score, ptype = "", 0.0, _NORMAL
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(data, pos)
            piece = data[pos : pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack("<f", data[pos : pos + 4])
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(data, pos)
        else:
            pos = _skip_field(data, pos, wire)
    return piece, score, ptype


def parse_sentencepiece_model(
    data: bytes,
) -> list[tuple[str, float, int]]:
    """Parse a ``spiece.model`` blob -> ``[(piece, score, type), ...]``
    in id order. Only ``ModelProto.pieces`` (field 1) is read."""
    pieces: list[tuple[str, float, int]] = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(data, pos)
            pieces.append(_parse_piece(data[pos : pos + n]))
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    return pieces


def serialize_sentencepiece_model(
    pieces: list[tuple[str, float, int]],
) -> bytes:
    """Inverse of :func:`parse_sentencepiece_model` (test fixtures)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b = v & 0x7F
            v >>= 7
            out += bytes([b | (0x80 if v else 0)])
            if not v:
                return out

    blob = b""
    for piece, score, ptype in pieces:
        p = piece.encode("utf-8")
        msg = (
            bytes([0x0A]) + varint(len(p)) + p  # field 1, wire 2
            + bytes([0x15]) + struct.pack("<f", score)  # field 2, wire 5
            + bytes([0x18]) + varint(ptype)  # field 3, wire 0
        )
        blob += bytes([0x0A]) + varint(len(msg)) + msg
    return blob


# -- unigram tokenizer ------------------------------------------------

_SPACE = "▁"  # ▁ metaspace marker


class T5SPTokenizer:
    """Pure-Python T5 tokenizer over a unigram SentencePiece vocab.

    ``path`` may be a ``spiece.model`` file, a ``tokenizer.json`` file,
    or a directory containing either. Call convention matches the HF
    tokenizers used by ``ConcatTextEncoders`` (input_ids +
    attention_mask, numpy int32).
    """

    def __init__(
        self,
        path: str,
        model_max_length: int = 512,
    ):
        if os.path.isdir(path):
            for name in ("spiece.model", "tokenizer.json"):
                cand = os.path.join(path, name)
                if os.path.exists(cand):
                    path = cand
                    break
        if path.endswith(".json"):
            pieces = self._pieces_from_tokenizer_json(path)
        else:
            with open(path, "rb") as f:
                pieces = parse_sentencepiece_model(f.read())

        self.pieces = [p for p, _, _ in pieces]
        self.scores = [s for _, s, _ in pieces]
        self.types = [t for _, _, t in pieces]
        self.vocab: dict[str, int] = {
            p: i for i, (p, _, _) in enumerate(pieces)
        }
        self.vocab_size = len(pieces)
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)

        # specials — T5 convention: <pad>=0, </s>=1, <unk>=2, with the
        # ids resolved from the vocab so non-default layouts also work
        self.unk_token_id = next(
            (i for i, t in enumerate(self.types) if t == _UNKNOWN), 2
        )
        self.pad_token = "<pad>"
        self.eos_token = "</s>"
        self.pad_token_id = self.vocab.get("<pad>", 0)
        self.eos_token_id = self.vocab.get("</s>", 1)
        self.model_max_length = model_max_length

        # user-defined symbols (T5's <extra_id_N>) split before
        # segmentation, longest-first so overlapping names resolve
        self._user_defined = sorted(
            (
                p
                for i, p in enumerate(self.pieces)
                if self.types[i] == _USER_DEFINED
            ),
            key=len,
            reverse=True,
        )
        # unknown-piece penalty: sentencepiece scores <unk> as
        # min(score) - 10 during Viterbi
        self._unk_score = min(self.scores, default=0.0) - 10.0

    @staticmethod
    def _pieces_from_tokenizer_json(
        path: str,
    ) -> list[tuple[str, float, int]]:
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError("tokenizer.json is not a unigram model")
        unk_id = model.get("unk_id", 2)
        added = {
            a["content"]
            for a in spec.get("added_tokens", [])
            if not a.get("special", False)
        }
        special = {
            a["content"]
            for a in spec.get("added_tokens", [])
            if a.get("special", False)
        }
        pieces = []
        for i, (piece, score) in enumerate(model["vocab"]):
            if i == unk_id:
                t = _UNKNOWN
            elif piece in special:
                t = _CONTROL
            elif piece in added or (
                piece.startswith("<extra_id_") and piece.endswith(">")
            ):
                t = _USER_DEFINED
            else:
                t = _NORMAL
            pieces.append((piece, float(score), t))
        return pieces

    # -- normalization + pre-tokenization -----------------------------

    @staticmethod
    def _normalize(text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        # nmt-style cleanup: drop control chars, unify exotic spaces
        out = []
        for ch in text:
            cp = ord(ch)
            if ch in ("\t", "\n", "\r"):
                out.append(" ")
            elif cp < 0x20 or cp == 0x7F or ch == "﻿":
                continue
            elif unicodedata.category(ch) == "Zs":
                out.append(" ")
            else:
                out.append(ch)
        text = "".join(out)
        # remove_extra_whitespaces (T5 normalizer: " {2,}" -> " ")
        while "  " in text:
            text = text.replace("  ", " ")
        return text

    def _split_user_defined(self, text: str) -> list[tuple[str, bool]]:
        """-> [(chunk, is_user_defined_symbol), ...]"""
        if not self._user_defined:
            return [(text, False)]
        chunks: list[tuple[str, bool]] = []
        i = 0
        plain_start = 0
        while i < len(text):
            for sym in self._user_defined:
                if text.startswith(sym, i):
                    if plain_start < i:
                        chunks.append((text[plain_start:i], False))
                    chunks.append((sym, True))
                    i += len(sym)
                    plain_start = i
                    break
            else:
                i += 1
        if plain_start < len(text):
            chunks.append((text[plain_start:], False))
        return chunks

    # -- unigram Viterbi ----------------------------------------------

    def _viterbi(self, text: str) -> list[int]:
        """Best-score segmentation of one metaspace-escaped chunk."""
        n = len(text)
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        for end in range(1, n + 1):
            lo = max(0, end - self._max_piece_len)
            for start in range(lo, end):
                if best[start] == float("-inf"):
                    continue
                pid = self.vocab.get(text[start:end])
                if pid is None or self.types[pid] in (_CONTROL, _UNUSED):
                    continue
                cand = best[start] + self.scores[pid]
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (start, pid)
            if best[end] == float("-inf"):
                # unknown character: one-char <unk> hop with penalty
                start = end - 1
                if best[start] > float("-inf"):
                    best[end] = best[start] + self._unk_score
                    back[end] = (start, self.unk_token_id)
        ids: list[int] = []
        pos = n
        while pos > 0:
            step = back[pos]
            if step is None:  # unreachable (defensive)
                pos -= 1
                ids.append(self.unk_token_id)
                continue
            pos, pid = step
            ids.append(pid)
        ids.reverse()
        # fuse_unk=true: collapse runs of <unk>
        fused: list[int] = []
        for pid in ids:
            if (
                pid == self.unk_token_id
                and fused
                and fused[-1] == self.unk_token_id
            ):
                continue
            fused.append(pid)
        return fused

    def tokenize(self, text: str) -> list[int]:
        """Raw unigram ids for one string, no special tokens."""
        text = self._normalize(text)
        if not text:
            return []
        # metaspace: escape spaces, dummy prefix only when the escaped
        # text does not already start with one (HF Metaspace semantics,
        # prepend_scheme="first")
        text = text.replace(" ", _SPACE)
        if not text.startswith(_SPACE):
            text = _SPACE + text
        ids: list[int] = []
        for chunk, is_sym in self._split_user_defined(text):
            if is_sym:
                ids.append(self.vocab[chunk])
            elif chunk:
                ids.extend(self._viterbi(chunk))
        return ids

    def __call__(
        self,
        text: str | list[str],
        padding: bool | str = "max_length",
        truncation: bool = True,
        max_length: int | None = None,
        return_tensors: str | None = None,  # accepted for API parity
    ) -> dict[str, np.ndarray]:
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        ids_batch, mask_batch = [], []
        for t in text:
            ids = self.tokenize(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            # HF semantics: padding=True/"longest" pads only to the
            # batch longest (done below); "max_length" pads to max_length
            if padding == "max_length":
                pad_n = max_length - len(ids)
                ids += [self.pad_token_id] * pad_n
                mask += [0] * pad_n
            ids_batch.append(ids)
            mask_batch.append(mask)
        longest = max(len(i) for i in ids_batch)
        ids_batch = [
            i + [self.pad_token_id] * (longest - len(i)) for i in ids_batch
        ]
        mask_batch = [m + [0] * (longest - len(m)) for m in mask_batch]
        return {
            "input_ids": np.asarray(ids_batch, dtype=np.int32),
            "attention_mask": np.asarray(mask_batch, dtype=np.int32),
        }
