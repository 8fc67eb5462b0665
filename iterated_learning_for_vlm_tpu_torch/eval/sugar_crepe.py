"""SugarCREPE compositionality evaluation.

A copy of ``iterated_learning_for_vlm_tpu/eval/sugar_crepe.py``.

Parity target: reference ``CLIP_benchmark/clip_benchmark/eval/sugar_crepe.py``
and the in-training variant (``example/clip_fdt/train_solver.py:623-678``):
7 splits (add/replace/swap x obj/att/rel) of ``{idx: {filename, caption,
negative_caption}}`` JSONs over COCO val2017 images; a sample scores 1 when
the positive caption's cosine beats the negative's.

The reference runs one forward per caption/image (batch=1, ~14k forwards per
eval); here all texts and images encode in fixed-size batches.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
from PIL import Image

SPLITS = (
    "add_obj", "add_att", "replace_obj", "replace_att", "replace_rel",
    "swap_obj", "swap_att",
)


def evaluate_sugar_crepe(
    encoder,
    data_root: str,
    image_root: str,
    splits=SPLITS,
    max_samples: Optional[int] = None,
) -> Dict[str, float]:
    """Returns ``{"sugar-crepe-<split>": acc, ..., "sugar-crepe-mean": m}``."""
    metrics: Dict[str, float] = {}
    for split in splits:
        path = os.path.join(data_root, f"{split}.json")
        if not os.path.isfile(path):
            continue
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        items = list(data.values())
        if max_samples:
            items = items[:max_samples]
        if not items:
            continue

        images = []
        for it in items:
            with Image.open(os.path.join(image_root, it["filename"])) as im:
                images.append(im.convert("RGB"))
        img_emb = encoder.encode_images(images)
        pos_emb = encoder.encode_texts([it["caption"] for it in items])
        neg_emb = encoder.encode_texts([it["negative_caption"] for it in items])

        pos_score = np.sum(img_emb * pos_emb, axis=-1)
        neg_score = np.sum(img_emb * neg_emb, axis=-1)
        metrics[f"sugar-crepe-{split}"] = float(np.mean(pos_score > neg_score))

    if metrics:
        metrics["sugar-crepe-mean"] = float(np.mean(list(metrics.values())))
    return metrics
