"""CLIP byte-pair-encoding tokenizer of the PyTorch port.

A copy of ``iterated_learning_for_vlm_tpu/data/tokenizer.py`` (the reference
vocabulary: 256 byte units, 256 ``</w>`` word-final units, 48894 merges, then
``<|mask|>``, ``<|startoftext|>``, ``<|endoftext|>`` => vocab 49409) that
runs on the standard library alone. The JAX module splits words with the
third-party ``regex`` package:

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

(``re.IGNORECASE``); here :func:`split_words` scans for the same matches
with ``unicodedata``: a letter is a character of category ``L*``, a number
one of ``N*`` (so ``²``, ``½`` and ``Ⅻ`` are numbers, not letters, as
``\\p{N}`` has them; Python's ``[^\\W\\d_]`` would take them as letters). Two
details of that pattern are kept: its ``\\s`` is Python's whitespace without
the separators ``\\x1c``-``\\x1f``, and under ``IGNORECASE`` the combining
ypogegrammeni (U+0345) matches neither class, and ``ſ`` (U+017F) matches
``s``. A character that Python's Unicode database (15.0 for Python 3.12) does
not know yet but ``regex``'s newer one does may still split differently.

``ftfy`` stays optional, as in the JAX module. The vocabulary file ships
inside this package. Output: ``(tokens int32 [B, ctx], pad_mask float32
[B, ctx])``, 0.0 on real tokens and -inf on padding, truncated to SOT, the
first ``ctx - 2`` body tokens and EOT.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Iterable, List, Sequence, Tuple

import numpy as np

try:  # ftfy is optional; captions that are already clean unicode are unaffected
    import ftfy

    def _fix_text(s: str) -> str:
        return ftfy.fix_text(s)

except ImportError:  # pragma: no cover

    def _fix_text(s: str) -> str:
        return s


DEFAULT_BPE_PATH = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
MASK = "<|mask|>"

# Additive pad-mask convention shared with the reference: 0.0 for real
# tokens, -inf for padding.
PAD_MASK_VALUE = float("-inf")

# ``regex``'s ``\s``: Python's whitespace less the separators \x1c-\x1f
_WS_PATTERN = re.compile(r"[^\S\x1c-\x1f]+")
_SPECIALS = (SOT, EOT)
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_UNMATCHED = frozenset("\u0345")  # matches no class of the pattern under IGNORECASE
_FOLDS = {"\u017f": "s"}  # the one lower-case letter that IGNORECASE folds onto ASCII


def _kind(c: str) -> str:
    """'L' letter, 'N' number, ' ' unmatched (whitespace), '.' other."""
    if c in _UNMATCHED or (c.isspace() and not "\x1c" <= c <= "\x1f"):
        return " "
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "."


def _literal_at(text: str, i: int, lit: str) -> bool:
    """``lit`` (lower-case ASCII) at ``text[i:]``, matched as IGNORECASE does."""
    if i + len(lit) > len(text):
        return False
    return all(_FOLDS.get(c, c.lower()) == want for c, want in zip(text[i:i + len(lit)], lit))


def split_words(text: str) -> List[str]:
    """The matches of the reference word pattern, in order (``findall``)."""
    out: List[str] = []
    n, i = len(text), 0
    while i < n:
        c = text[i]
        if c == "<":
            lit = next((s for s in _SPECIALS if _literal_at(text, i, s)), None)
            if lit is not None:
                out.append(text[i:i + len(lit)])
                i += len(lit)
                continue
        elif c == "'":
            lit = next((s for s in _CONTRACTIONS if _literal_at(text, i + 1, s)), None)
            if lit is not None:
                out.append(text[i:i + 1 + len(lit)])
                i += 1 + len(lit)
                continue
        kind = _kind(c)
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and other characters run; a number stands alone
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def byte_unicode_table() -> dict:
    """GPT-2 style reversible byte -> printable-unicode mapping."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    chars = printable[:]
    offset = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + offset)
            offset += 1
    return {b: chr(c) for b, c in zip(printable, chars)}


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WS_PATTERN.sub(" ", text.strip())
    return text.strip()


class ClipTokenizer:
    """BPE tokenizer with the reference vocabulary and merge table."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}

        with gzip.open(bpe_path) as f:
            lines = f.read().decode("utf-8").split("\n")
        # The reference's slice: skip the header line, keep 48894 merges.
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(l.split()) for l in merge_lines]

        units = list(self.byte_encoder.values())
        vocab = units + [u + "</w>" for u in units]
        vocab += ["".join(m) for m in merges]
        vocab += [MASK, SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {m: i for i, m in enumerate(merges)}
        self._cache = {SOT: SOT, EOT: EOT, MASK: MASK}

        self.vocab_size = len(self.encoder)
        self.sot_token = self.encoder[SOT]
        self.eot_token = self.encoder[EOT]
        self.mask_token = self.encoder[MASK]

    # -- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        if len(parts) == 1:
            return token + "</w>"
        while len(parts) > 1:
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                rank = self.merge_rank.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_idx = rank, i
            if best_rank is None:
                break
            merged = parts[best_idx] + parts[best_idx + 1]
            # Merge *every* adjacent occurrence of this pair in one pass,
            # matching the reference's inner loop semantics.
            first, second = parts[best_idx], parts[best_idx + 1]
            out: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        result = " ".join(parts)
        self._cache[token] = result
        return result

    # -- public API --------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for word in split_words(text):
            word_bytes = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[unit] for unit in self._bpe(word_bytes).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self,
        texts: str | Sequence[str],
        context_length: int = 77,
        return_lengths: bool = False,
    ):
        """Batch-tokenize to fixed-shape arrays.

        Returns ``(tokens, pad_mask)`` where ``tokens`` is int32 ``[B, ctx]``
        and ``pad_mask`` is float32 ``[B, ctx]`` with 0.0 on real tokens and
        -inf on padding. Truncation keeps SOT, the first ``ctx-2`` body
        tokens, and EOT.
        """
        if isinstance(texts, str):
            texts = [texts]
        batch = len(texts)
        tokens = np.zeros((batch, context_length), dtype=np.int32)
        pad_mask = np.full((batch, context_length), PAD_MASK_VALUE, dtype=np.float32)
        lengths = np.ones(batch, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(ids) > context_length:
                ids = [ids[0]] + ids[1 : context_length - 1] + [ids[-1]]
            n = len(ids)
            tokens[i, :n] = ids
            pad_mask[i, :n] = 0.0
            lengths[i] = n
        if return_lengths:
            return tokens, pad_mask, lengths
        return tokens, pad_mask


@functools.lru_cache()
def get_tokenizer(bpe_path: str = DEFAULT_BPE_PATH) -> ClipTokenizer:
    return ClipTokenizer(bpe_path)
