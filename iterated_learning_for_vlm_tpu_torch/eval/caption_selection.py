"""Image-caption selection metric.

A copy of ``iterated_learning_for_vlm_tpu/eval/caption_selection.py`` (numpy
float32 scores of the encoder's embeddings, as there).

Parity target: reference ``CLIP_benchmark/clip_benchmark/metrics/
image_caption_selection.py`` (+ the ``log_likelihood_selection`` variant used
for wds-packaged SugarCREPE/Winoground via the CLI task dispatch,
cli.py:308-418): each image comes with N candidate captions, exactly one
correct (index 0 by convention); accuracy = fraction where the true caption
scores highest under image-text cosine similarity.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def evaluate_caption_selection(
    encoder,
    images,
    candidates_per_image: Sequence[Sequence[str]],
    true_index: int = 0,
) -> Dict[str, float]:
    items = list(candidates_per_image)
    n_cand = len(items[0])
    img_emb = encoder.encode_images(images)
    flat = [c for cands in items for c in cands]
    txt_emb = encoder.encode_texts(flat).reshape(len(items), n_cand, -1)
    scores = np.einsum("nd,ncd->nc", img_emb, txt_emb)
    pred = scores.argmax(axis=-1)
    return {"acc": float(np.mean(pred == true_index))}
