"""Caption scoring metrics: corpus BLEU-1..4, ROUGE-L, CIDEr-D.

A copy of ``iterated_learning_for_vlm_tpu/eval/caption_metrics.py`` (stdlib
only, so the same captions give the same metrics bit for bit).

Parity target: reference ``CLIP_benchmark/clip_benchmark/metrics/captioning.py``
(COCOEvalCap over pycocoevalcap scorers).  pycocoevalcap is not available in
this environment (and METEOR/SPICE need a JVM), so the three pure n-gram
scorers are reimplemented here from their published definitions, matching the
pycocoevalcap computations:

- BLEU: corpus-level, clipped n-gram counts, closest-reference-length brevity
  penalty, pycoco's tiny/small smoothing constants.
- ROUGE-L: per-image max precision/recall over references of the LCS,
  F-beta with beta=1.2, averaged.
- CIDEr-D: tf-idf n-gram vectors (df over the reference corpus), clipped
  cosine per n in 1..4, gaussian length penalty sigma=6, x10.

Tokenization: PTBTokenizer is replaced by lowercase + punctuation-strip +
whitespace split (documented divergence; PTB's clitic handling differs on a
small fraction of tokens).
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

_PUNCT = re.compile(r"[^a-z0-9 ]+")


def tokenize(text: str) -> List[str]:
    return _PUNCT.sub(" ", text.lower()).split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# -- BLEU ---------------------------------------------------------------------
def bleu(candidates: List[List[str]], references: List[List[List[str]]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU_1..max_n (pycocoevalcap Bleu, option='closest')."""
    tiny, small = 1e-15, 1e-9
    clipped = [0.0] * max_n
    totals = [0.0] * max_n
    cand_len = ref_len = 0.0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        # closest reference length (ties -> shorter, as in pycoco)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            c_counts = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                for g, cnt in _ngrams(r, n).items():
                    if cnt > max_ref[g]:
                        max_ref[g] = cnt
            clipped[n - 1] += sum(min(cnt, max_ref[g]) for g, cnt in c_counts.items())
            totals[n - 1] += max(0, len(cand) - n + 1)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, tiny))
    scores = []
    log_sum = 0.0
    for n in range(max_n):
        p = (clipped[n] + tiny) / (totals[n] + small)
        log_sum += math.log(p)
        scores.append(bp * math.exp(log_sum / (n + 1)))
    return scores


# -- ROUGE-L ------------------------------------------------------------------
def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(candidates: List[List[str]], references: List[List[List[str]]],
            beta: float = 1.2) -> float:
    scores = []
    for cand, refs in zip(candidates, references):
        precs, recs = [], []
        for r in refs:
            lcs = _lcs_len(cand, r)
            precs.append(lcs / max(len(cand), 1))
            recs.append(lcs / max(len(r), 1))
        p, r_ = max(precs), max(recs)
        scores.append(((1 + beta ** 2) * p * r_) / (r_ + beta ** 2 * p)
                      if p and r_ else 0.0)
    return sum(scores) / max(len(scores), 1)


# -- CIDEr-D ------------------------------------------------------------------
def cider_d(candidates: List[List[str]], references: List[List[List[str]]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    num_images = len(references)
    # document frequency over the reference corpus
    df = [defaultdict(float) for _ in range(max_n)]
    ref_counts = []
    for refs in references:
        per_ref = [[_ngrams(r, n + 1) for n in range(max_n)] for r in refs]
        ref_counts.append(per_ref)
        for n in range(max_n):
            seen = set()
            for counts in per_ref:
                seen |= set(counts[n])
            for g in seen:
                df[n][g] += 1.0

    log_n = math.log(max(num_images, 1))

    def vec(counts_by_n, length):
        v, norm = [], []
        for n in range(max_n):
            d = {}
            s = 0.0
            for g, cnt in counts_by_n[n].items():
                idf = log_n - math.log(max(df[n][g], 1.0))
                val = cnt * idf
                d[g] = val
                s += val * val
            v.append(d)
            norm.append(math.sqrt(s))
        return v, norm, length

    scores = []
    for cand, refs, per_ref in zip(candidates, references, ref_counts):
        c_counts = [_ngrams(cand, n + 1) for n in range(max_n)]
        vc, nc, lc = vec(c_counts, len(cand))
        img_scores = []
        for r, r_counts in zip(refs, per_ref):
            vr, nr, lr = vec(r_counts, len(r))
            delta = float(lc - lr)
            sim = 0.0
            for n in range(max_n):
                val = 0.0
                for g, cv in vc[n].items():
                    val += min(cv, vr[n].get(g, 0.0)) * vr[n].get(g, 0.0)
                if nc[n] and nr[n]:
                    val /= nc[n] * nr[n]
                val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                sim += val
            img_scores.append(sim / max_n)
        scores.append(10.0 * sum(img_scores) / max(len(img_scores), 1))
    return sum(scores) / max(len(scores), 1)


def score_captions(generated: List[str],
                   references: List[List[str]]) -> Dict[str, float]:
    """All metrics over raw strings (one generated caption + >=1 refs per
    image).  Returns the reference JSON metric keys (Bleu_1..4, ROUGE_L,
    CIDEr)."""
    cands = [tokenize(g) for g in generated]
    refs = [[tokenize(r) for r in rs] for rs in references]
    b = bleu(cands, refs)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "ROUGE_L": rouge_l(cands, refs),
        "CIDEr": cider_d(cands, refs),
    }
