"""Zero-shot classification.

A copy of ``iterated_learning_for_vlm_tpu/eval/zeroshot_classification.py``:
the scores are numpy float32 products of the embeddings, as there, so the
same embeddings give the same metrics bit for bit.

Parity target: reference ``CLIP_benchmark/clip_benchmark/metrics/
zeroshot_classification.py``: build a prompt-ensemble classifier (mean of
L2-normalised per-template text embeddings, re-normalised), logits =
``100 * image_emb @ classifier``, report acc1/acc5 and mean-per-class recall;
mAP for multilabel datasets.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def build_zeroshot_classifier(
    encoder, classnames: Sequence[str], templates
) -> np.ndarray:
    """[D, C] prompt-ensembled classifier weights.

    ``templates`` is either a list of generic prompts specialised per class
    ("a photo of a {c}"), or a dict keyed by classname with class-specific
    prompt lists (CuPL, reference ``zeroshot_classification.py:43-46``,
    fed via ``--custom_template_file``)."""
    weights = []
    for classname in classnames:
        if isinstance(templates, dict):
            prompts = list(templates[classname])
        else:
            prompts = [
                t.format(c=classname) if "{c}" in t else t.format(classname)
                for t in templates
            ]
        emb = encoder.encode_texts(prompts)  # [T, D] already normalised
        mean = emb.mean(axis=0)
        mean /= np.linalg.norm(mean) + 1e-10
        weights.append(mean)
    return np.stack(weights, axis=1)


def accuracy_topk(logits: np.ndarray, labels: np.ndarray, ks=(1, 5)) -> Dict[str, float]:
    order = np.argsort(-logits, axis=-1)
    out = {}
    for k in ks:
        kk = min(k, logits.shape[-1])
        out[f"acc{k}"] = float(np.mean((order[:, :kk] == labels[:, None]).any(axis=1)))
    return out


def mean_per_class_recall(logits: np.ndarray, labels: np.ndarray) -> float:
    pred = logits.argmax(-1)
    recalls = []
    for c in np.unique(labels):
        m = labels == c
        recalls.append(float(np.mean(pred[m] == c)))
    return float(np.mean(recalls))


def average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """Per-class AP (multilabel mAP building block)."""
    order = np.argsort(-scores)
    t = targets[order]
    cum_pos = np.cumsum(t)
    precision = cum_pos / (np.arange(len(t)) + 1)
    denom = t.sum()
    if denom == 0:
        return float("nan")
    return float((precision * t).sum() / denom)


def evaluate_zeroshot_classification(
    encoder,
    images,
    labels: np.ndarray,
    classnames: Sequence[str],
    templates: Sequence[str],
    multilabel: bool = False,
    save_clf: str | None = None,
    load_clfs: Sequence[str] = (),
) -> Dict[str, float]:
    """images: ndarray [N,H,W,3] or PIL list; labels: [N] ints (or [N,C] 0/1).

    ``save_clf`` / ``load_clfs``: persist or reuse the prompt-ensembled
    classifier (reference ``cli.py --save_clf/--load_clfs``; multiple loaded
    classifiers are averaged then re-normalized, matching the reference's
    classifier-soup path — stored as ``.npy`` rather than torch tensors).
    """
    if load_clfs:
        classifier = np.mean([np.load(p) for p in load_clfs], axis=0)
        classifier = classifier / np.maximum(
            np.linalg.norm(classifier, axis=0, keepdims=True), 1e-12
        )
    else:
        classifier = build_zeroshot_classifier(encoder, classnames, templates)
    if save_clf:
        np.save(save_clf, classifier)
    img_emb = encoder.encode_images(images)
    logits = 100.0 * img_emb @ classifier

    if multilabel:
        aps = [
            average_precision(logits[:, c], labels[:, c]) for c in range(logits.shape[1])
        ]
        return {"mean_average_precision": float(np.nanmean(aps))}

    labels = np.asarray(labels)
    metrics = accuracy_topk(logits, labels)
    metrics["mean_per_class_recall"] = mean_per_class_recall(logits, labels)
    return metrics
