"""The port's tokenizers against the JAX package's, on the host.

``CLIPBPETokenizer`` on the vocabulary ``tests/test_tokenizers.py`` builds
(every byte symbol, its ``</w>`` form, a few merges, the two specials),
over strings that reach each branch of CLIP's split: non-ASCII letters
and numbers (``½ ² Ⅻ`` are numbers no ``\\d`` takes), combining marks,
the long s a case-insensitive ``'s`` takes, emoji, the separators
``\\x1c``-``\\x1f`` that ``str.isspace`` calls spaces and ``regex`` does
not, placeholders, truncation and both pad tokens. ``T5SPTokenizer`` on
the unigram model ``tests/test_spiece.py`` serialises.
"""

import numpy as np
import pytest

from test_spiece import _PIECES
from test_spiece import _TEXTS as T5_TEXTS
from test_tokenizers import vocab_files  # noqa: F401  (the module-scoped fixture vocabulary)
from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from uwudiff_tpu.models.spiece import T5SPTokenizer as JaxT5
from uwudiff_tpu.models.spiece import serialize_sentencepiece_model as jax_serialize
from uwudiff_tpu.models.tokenizers import CLIPBPETokenizer as JaxCLIP
from uwudiff_tpu.models.tokenizers import clamp_tokenizer_length as jax_clamp
from uwudiff_tpu_torch.models import import_torch
from uwudiff_tpu_torch.models.spiece import parse_sentencepiece_model, serialize_sentencepiece_model
from uwudiff_tpu_torch.models.tokenizers import (
    CLIPBPETokenizer,
    T5SPTokenizer,
    _byte_to_unicode,
    clamp_tokenizer_length,
    load_hf_tokenizer,
)

CLIP_TEXTS = [
    "a photo of a cat",
    "A PHOTO OF A CAT, running; cat's photo!",
    "the cat   and the\tcat\n",
    "cat 123 photos ½ ² Ⅻ ٣ 五",  # numbers: one a chunk, \p{N} not \d
    "naïve café Ünïcödé İstanbul ǅ",  # letters, a title-case one, a lower() that adds a mark
    "é aͅb ́x",  # combining marks (Mn): U+0345 folds to a letter, and splits
    "it'ſ it'S IT'RE we'LL you'd i'M they've",  # contractions, the long s as 's
    "😀 🦊🦊 cat🦊 👍🏽",  # emoji and a modifier: other symbols, multi-byte
    "a\x1cb\x1d c\x1f\x1e d \x1c",  # separators \s does not take, stripped at the ends
    "<|startoftext|>cat<|endoftext|> !!<|endoftext|> <|ENDOFTEXT|>",
    "$$$ ... ((cat)) [dog] {x} @#%^&*",
    "  spaces　 end\u0085",
    "",
    "cat " * 80,  # truncation keeps the final EOS
]


@pytest.fixture(scope="module")
def clip_pair(vocab_files):  # noqa: F811
    vf, mf = vocab_files
    return JaxCLIP(vf, mf), CLIPBPETokenizer(vf, mf)


def _assert_same(got, want):
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("kw", [{}, {"padding": False}, {"max_length": 16}, {"truncation": False, "padding": False}])
def test_clip_bpe_ids_equal_jax(clip_pair, kw):
    jax_tok, tok = clip_pair
    for text in CLIP_TEXTS:  # one at a time: unpadded rows differ in length
        _assert_same(tok(text, **kw), jax_tok(text, **kw))
        assert tok.tokenize(text) == jax_tok.tokenize(text), text
    _assert_same(tok(CLIP_TEXTS), jax_tok(CLIP_TEXTS))


def test_clip_bpe_pad_tokens_and_placeholders_equal_jax(vocab_files):  # noqa: F811
    vf, mf = vocab_files
    for pad in (None, "!"):  # CLIP-L pads with EOS, SDXL's tokenizer_2 with "!"
        jax_tok, tok = JaxCLIP(vf, mf, pad_token=pad), CLIPBPETokenizer(vf, mf, pad_token=pad)
        assert tok.pad_token_id == jax_tok.pad_token_id
        for t in (tok, jax_tok):
            t.add_placeholder("<cat-style>", [7, 8])
            t.add_placeholder("sks", [900])
        texts = ["a <CAT-style>, sks dog; tasks (sks)", "sks", "x<cat-style>y " * 30]
        _assert_same(tok(texts), jax_tok(texts))
        _assert_same(tok(texts, max_length=20), jax_tok(texts, max_length=20))
    assert _byte_to_unicode() == __import__("uwudiff_tpu.models.tokenizers", fromlist=["x"])._byte_to_unicode()


def test_clamp_and_hf_loader(clip_pair):
    jax_tok, tok = clip_pair
    for t in (jax_tok, tok):
        t.model_max_length = 300
    assert clamp_tokenizer_length(tok, 256).model_max_length == jax_clamp(jax_tok, 256).model_max_length == 256
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_hf_tokenizer("openai/clip-vit-large-patch14")


def test_tokenizers_import_neither_regex_nor_transformers():
    import uwudiff_tpu_torch.models.spiece as spiece
    import uwudiff_tpu_torch.models.tokenizers as tokenizers

    for mod in (tokenizers, spiece, import_torch):
        src = open(mod.__file__).read()
        for name in ("regex", "transformers", "safetensors"):
            assert f"import {name}" not in src and f"from {name}" not in src, (mod.__name__, name)


def test_t5_sentencepiece_ids_equal_jax(tmp_path):
    blob = serialize_sentencepiece_model(_PIECES)
    assert blob == jax_serialize(_PIECES) and parse_sentencepiece_model(blob) == [
        (p, pytest.approx(s), t) for p, s, t in _PIECES]
    path = tmp_path / "spiece.model"
    path.write_bytes(blob)
    texts = T5_TEXTS + ["ＡＢＣ ﬁ ①", "the　quick​fox\x07", "abc" * 200]
    for max_length in (None, 16):
        jax_tok, tok = JaxT5(str(path)), T5SPTokenizer(str(tmp_path))
        for kw in ({}, {"padding": "longest"}, {"max_length": max_length}):
            _assert_same(tok(texts, **kw), jax_tok(texts, **kw))
        assert [tok.tokenize(t) for t in texts] == [jax_tok.tokenize(t) for t in texts]
