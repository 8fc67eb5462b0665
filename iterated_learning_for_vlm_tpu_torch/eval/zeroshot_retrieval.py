"""Zero-shot image-text retrieval (COCO/Flickr style).

A copy of ``iterated_learning_for_vlm_tpu/eval/zeroshot_retrieval.py``
(numpy float32 scores, as there).

Parity target: reference ``CLIP_benchmark/clip_benchmark/metrics/
zeroshot_retrieval.py``: encode all images and captions (multiple captions
per image), score ``texts_emb @ images_emb.T``, and report CLIP-style
recall@k in both directions using the positive-pair matrix: a query counts as
recalled when ANY of its positives ranks above k.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _recall_at_k(scores: np.ndarray, positive: np.ndarray, k: int) -> float:
    """scores [Q, N], positive [Q, N] bool; reference's batchify_topk logic."""
    kk = min(k, scores.shape[1])
    topk_idx = np.argpartition(-scores, kth=kk - 1, axis=1)[:, :kk]
    hit = positive[np.arange(len(scores))[:, None], topk_idx].any(axis=1)
    return float(hit.mean())


def evaluate_retrieval(
    encoder,
    images,
    captions_per_image: Sequence[Sequence[str]],
    recall_ks=(1, 5, 10),
) -> Dict[str, float]:
    """images: [N] array/PIL; captions_per_image: N lists of captions."""
    img_emb = encoder.encode_images(images)

    flat_caps: List[str] = []
    owner: List[int] = []
    for i, caps in enumerate(captions_per_image):
        for c in caps:
            flat_caps.append(c)
            owner.append(i)
    txt_emb = encoder.encode_texts(flat_caps)
    owner_arr = np.asarray(owner)

    scores_t2i = txt_emb @ img_emb.T  # [T, N]
    scores_i2t = scores_t2i.T  # [N, T]

    pos_t2i = np.zeros_like(scores_t2i, dtype=bool)
    pos_t2i[np.arange(len(owner_arr)), owner_arr] = True
    pos_i2t = pos_t2i.T

    metrics = {}
    for k in recall_ks:
        metrics[f"text_retrieval_recall@{k}"] = _recall_at_k(scores_i2t, pos_i2t, k)
        metrics[f"image_retrieval_recall@{k}"] = _recall_at_k(scores_t2i, pos_t2i, k)
    return metrics
