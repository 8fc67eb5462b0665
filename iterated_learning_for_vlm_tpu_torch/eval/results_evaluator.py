"""Offline results-file evaluators (legacy solver val-loop scorers).

A copy of ``iterated_learning_for_vlm_tpu/eval/results_evaluator.py``.

Parity target: reference ``prototype/data/metrics/``:
- ``imagenet_evaluator.py:24-62`` — top-k accuracy over a JSONL results file
  of ``{"score": [...], "label": int}`` records,
- ``multiclass_evaluator.py:19-57`` — per-attribute top-1 accuracy over
  ``{"score": [[...]], "label_list": [...], "label_name_list": [...]}``,
- ``custom_evaluator.py`` — the same protocol with a user metric key.

The legacy DeCLIP/FILIP solvers dump per-sample prediction records from the
validation loop and score the files offline; these are plain-numpy scorers
(no device work), so they run identically on any host.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np


def load_results(res_file: str) -> Dict[str, List]:
    """JSONL records -> column dict (reference ``load_res``)."""
    out: Dict[str, List] = {}
    with open(res_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            for key, value in rec.items():
                out.setdefault(key, []).append(value)
    return out


def topk_accuracy(scores: np.ndarray, labels: np.ndarray,
                  topk: Sequence[int] = (1, 5)) -> Dict[str, float]:
    """Percent top-k accuracy (reference ``ImageNetEvaluator.eval`` math) —
    one source of truth: delegates to the zeroshot harness's scorer and only
    adapts key names (``topN``) and percent scaling."""
    from .zeroshot_classification import accuracy_topk

    frac = accuracy_topk(np.asarray(scores), np.asarray(labels).reshape(-1),
                         ks=tuple(topk))
    return {f"top{k}": 100.0 * frac[f"acc{k}"] for k in topk}


def imagenet_eval(res_file: str, topk: Sequence[int] = (1, 5)) -> Dict[str, float]:
    res = load_results(res_file)
    return topk_accuracy(np.asarray(res["score"]), np.asarray(res["label"]), topk)


def multiclass_eval(res_file: str) -> Dict[str, float]:
    """Per-attribute top-1 accuracy keyed by attribute name."""
    res = load_results(res_file)
    scores = np.asarray(res["score"])          # [N, A, C]
    labels = np.asarray(res["label_list"])     # [N, A]
    names = res["label_name_list"][0]          # [A]
    out = {}
    for i, name in enumerate(names):
        pred = np.argmax(scores[:, i, :], axis=1)
        out[name] = 100.0 * float((pred == labels[:, i]).mean())
    return out
