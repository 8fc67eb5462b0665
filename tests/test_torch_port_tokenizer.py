"""The port's CLIP tokenizer (``iterated_learning_for_vlm_tpu_torch/data``)
against the JAX package's, which splits words with the ``regex`` package.

Both must give the same token ids and pad masks, at the 77 and 32 contexts,
on a fixed corpus that covers the pattern's corners (contractions, digits
and other numbers such as ``²``/``½``/``Ⅻ``, accented Latin, CJK, emoji, HTML
entities, whitespace runs, truncation) and on generated strings; the word
splitter must find the same matches on every character Python's Unicode
database assigns. The port ships its own byte-identical vocabulary and runs
where ``regex`` is not installed.
"""
import hashlib
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from iterated_learning_for_vlm_tpu.data import tokenizer as jtok
from iterated_learning_for_vlm_tpu_torch.data import tokenizer as ttok

REPO = Path(__file__).resolve().parents[1]

CORPUS = [
    "A photo of a cat.",
    "a dog running on the beach at sunset",
    "it's the dog's toy, isn't it? we'll see; I'd say they're fine & you've won",
    "'S 'T 'RE 'VE 'M 'LL 'D ''s 's'",
    "x² + y² = z², ½ cup, Ⅻ o'clock, ①②③, 3.14159 and 1,000,000",
    "Crème brûlée à la café, naïve façade, Ångström, Straße, ſtop",
    "東京の夜景 猫が好き 한국어 문장 مرحبا بالعالم Привет мир",
    "🐶🐱 emoji 👍🏽!! 🇺🇸 family 👨‍👩‍👧",
    "Tom &amp; Jerry &lt;3 &amp;amp; &quot;quoted&quot; &#39;single&#39; &eacute;",
    "  many   \t\n spaces   and em \x1c sep \x1f  ",
    "<|startoftext|> inside <|endoftext|> and <|STARTOFTEXT|> !<|endoftext|>",
    "hyphen-ated, under_scored, slash/ed, dots... ellipsis… dashes — – -",
    "ᾳ with ypogegrammeni ͅ combining, é decomposed",
    "",
    " ".join(["word"] * 60) + " a caption much longer than seventy seven tokens "
    + " ".join(f"n{i}" for i in range(40)),
]


@pytest.fixture(scope="module")
def tokenizers():
    return jtok.get_tokenizer(), ttok.get_tokenizer()


@pytest.mark.parametrize("ctx", [77, 32])
def test_tokens_and_pad_mask_match_jax(tokenizers, ctx):
    jax_tok, port_tok = tokenizers
    want_t, want_p, want_n = jax_tok(CORPUS, context_length=ctx, return_lengths=True)
    got_t, got_p, got_n = port_tok(CORPUS, context_length=ctx, return_lengths=True)
    assert got_t.dtype == np.int32 and got_p.dtype == np.float32
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_n, want_n)
    assert got_n[-1] == ctx and got_t[-1, ctx - 1] == port_tok.eot_token  # truncated, EOT kept
    assert got_t[0, 0] == port_tok.sot_token


def test_vocab_and_encode_decode_match_jax(tokenizers):
    jax_tok, port_tok = tokenizers
    assert port_tok.vocab_size == jax_tok.vocab_size == 49409
    assert port_tok.encoder == jax_tok.encoder
    for text in CORPUS[:8]:
        ids = port_tok.encode(text)
        assert ids == jax_tok.encode(text)
        assert port_tok.decode(ids) == jax_tok.decode(ids)


@pytest.mark.parametrize("sep", ["", "'", "s1 "])
def test_word_split_matches_regex_on_every_assigned_character(sep):
    """Every character Python's Unicode database assigns (surrogates aside),
    joined by ``sep``, splits into the same matches as the JAX pattern."""
    chars = [chr(c) for c in range(sys.maxunicode + 1)
             if not 0xD800 <= c <= 0xDFFF and unicodedata.category(chr(c)) != "Cn"]
    text = sep.join(chars)
    assert ttok.split_words(text) == jtok._WORD_PATTERN.findall(text)
    assert ttok._WS_PATTERN.sub(" ", text) == jtok._WS_PATTERN.sub(" ", text)


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.one_of(
    st.text(alphabet=st.characters(blacklist_categories=("Cs", "Cn")), max_size=12),
    st.sampled_from(["'s", "'ll", "'re", "'x", "<|endoftext|>", "&amp;", " ", "\t", "²",
                     "Ⅻ", "ſ", "1", "é"])), max_size=8).map("".join))
def test_generated_strings_match_jax(text):
    jax_tok, port_tok = jtok.get_tokenizer(), ttok.get_tokenizer()
    assert ttok.split_words(text) == jtok._WORD_PATTERN.findall(text)
    for ctx in (77, 32):
        got, want = port_tok([text], context_length=ctx), jax_tok([text], context_length=ctx)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_vocab_copy_is_byte_identical():
    def digest(path):
        return hashlib.sha256(Path(path).read_bytes()).hexdigest()

    port_data = REPO / "iterated_learning_for_vlm_tpu_torch" / "data"
    assert Path(ttok.DEFAULT_BPE_PATH).parent == port_data
    assert digest(ttok.DEFAULT_BPE_PATH) == digest(jtok.DEFAULT_BPE_PATH)


def test_runs_without_regex():
    """A fresh interpreter in which ``import regex`` fails imports the port's
    tokenizer and tokenizes, and loads nothing of the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "from iterated_learning_for_vlm_tpu_torch.data.tokenizer import get_tokenizer\n"
        "tok, pad = get_tokenizer()(['a photo of a cat', \"it's x\\u00b2\"], context_length=32)\n"
        "assert tok.shape == (2, 32) and (pad[:, 0] == 0).all()\n"
        "assert list(tok[0, :7]) == [49407, 320, 1125, 539, 320, 2368, 49408], tok[0]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'iterated_learning_for_vlm_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
