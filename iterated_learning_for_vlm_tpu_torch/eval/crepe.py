"""CREPE compositionality retrieval (productivity + systematicity).

A copy of ``iterated_learning_for_vlm_tpu/eval/crepe.py``.

Parity target: reference ``CLIP_benchmark/clip_benchmark/eval/crepe.py`` +
``crepe_eval_utils.py``: CSV rows with an image (optionally cropped to a
region x/y/width/height), one positive caption and 5 hard negatives
(``hard_negs`` column), scored 1-image-vs-6-captions; metrics are
image_to_text mean/median rank and R@{1,3,5,10} (``get_one2many_metrics``).

Presets mirror ``crepe_params.py``: productivity complexities {4..12} x
hard-negative types {atom, swap, negate}; systematicity splits
{seen, unseen}_compounds x {atom, comp, combined}.
"""
from __future__ import annotations

import ast
import csv
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

PRODUCTIVITY_HARD_NEG_TYPES = ("atom", "swap", "negate")
SYSTEMATICITY_HARD_NEG_TYPES = ("atom", "comp", "combined")


def one2many_metrics(ranks: np.ndarray, name: str = "image_to_text") -> Dict[str, float]:
    """Reference ``get_one2many_metrics`` (crepe_eval_utils.py:66-76)."""
    m = {
        f"{name}_mean_rank": float(ranks.mean() + 1),
        f"{name}_rank_std": float(ranks.std()),
        f"{name}_median_rank": float(np.floor(np.median(ranks)) + 1),
    }
    for k in (1, 3, 5, 10):
        m[f"{name}_R@{k}"] = float(np.mean(ranks < k))
        m[f"{name}_R@{k}_std"] = float(np.std(ranks < k))
    return m


def load_crepe_csv(
    csv_path: str,
    image_dirs: Sequence[str],
    hard_neg_key: str = "hard_negs",
    img_key: str = "image_id",
    caption_key: str = "caption",
    crop: bool = True,
    max_items: Optional[int] = None,
) -> Iterator[dict]:
    """Yield {image: PIL, captions: [pos + negs]} from a CREPE CSV."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        for i, row in enumerate(reader):
            if max_items and i >= max_items:
                return
            image_id = row[img_key]
            img = None
            for d in image_dirs:
                p = os.path.join(d, f"{image_id}.jpg")
                if os.path.exists(p):
                    img = Image.open(p).convert("RGB")
                    break
            if img is None:
                continue
            if crop and all(k in row for k in ("x", "y", "width", "height")):
                x, y = float(row["x"]), float(row["y"])
                w, h = float(row["width"]), float(row["height"])
                img = img.crop((x, y, x + w, y + h))
            negs = ast.literal_eval(row[hard_neg_key])
            yield {"image": img, "captions": [row[caption_key]] + list(negs)}


def evaluate_crepe_items(encoder, items: Sequence[dict]) -> Dict[str, float]:
    """items: {image, captions (positive first)}; 1-vs-N ranking."""
    items = list(items)
    if not items:
        return {}
    n_caps = len(items[0]["captions"])
    img_emb = encoder.encode_images([it["image"] for it in items])
    flat = [c for it in items for c in it["captions"]]
    txt_emb = encoder.encode_texts(flat).reshape(len(items), n_caps, -1)
    scores = np.einsum("nd,ncd->nc", img_emb, txt_emb)
    # rank of the positive (index 0) among the candidates
    ranks = np.sum(scores > scores[:, :1], axis=1)
    return one2many_metrics(ranks.astype(np.int64))


def evaluate_crepe_csv(
    encoder, csv_path: str, image_dirs: Sequence[str], hard_neg_key: str = "hard_negs",
    crop: bool = True, max_items: Optional[int] = None,
) -> Dict[str, float]:
    items = list(load_crepe_csv(csv_path, image_dirs, hard_neg_key, crop=crop,
                                max_items=max_items))
    return evaluate_crepe_items(encoder, items)


def productivity_csv_path(root: str, complexity: int, hard_neg_type: str) -> str:
    """Reference path scheme (crepe.py presets)."""
    return os.path.join(
        root, "prod_hard_negatives", hard_neg_type,
        f"prod_vg_hard_negs_{hard_neg_type}_complexity_{complexity}.csv",
    )


def systematicity_csv_path(root: str, split: str, model_seen: str) -> str:
    return os.path.join(
        root, "syst_hard_negatives", f"syst_vg_hard_negs_{split}_in_{model_seen}.csv"
    )
