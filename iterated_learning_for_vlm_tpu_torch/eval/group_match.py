"""2-image x 2-caption group matching (COLA / Winoground).

A copy of ``iterated_learning_for_vlm_tpu/eval/group_match.py``.

Parity targets:
- COLA: reference ``CLIP_benchmark/clip_benchmark/eval/cola_multi.py`` —
  items are (image_0, caption_0, image_1, caption_1); ``compute_correct`` on
  the 2x2 logits: ``r[0,0] > r[1,0] and r[1,1] > r[0,1]``; reports
  text/image/group scores.
- Winoground: reference ``eval/winoground.py`` — same scoring over the HF
  ``facebook/winoground`` examples.

Both become one vectorised evaluator over the full [N,2,D] embedding tensors
(the reference loops example-by-example).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image


def group_scores(img_emb: np.ndarray, txt_emb: np.ndarray) -> Dict[str, float]:
    """img_emb/txt_emb: [N, 2, D] L2-normalised.

    Returns text/image/group scores with the reference's decision rule.
    ``logits[n, i, c] = <img[n,i], txt[n,c]>``.
    """
    logits = np.einsum("nid,ncd->nic", img_emb, txt_emb)
    # image_correct: derived from logits_per_image (image rows x caption cols)
    # reference compute_correct(r): r[0,0] > r[1,0] and r[1,1] > r[0,1]
    img_ok = (logits[:, 0, 0] > logits[:, 1, 0]) & (logits[:, 1, 1] > logits[:, 0, 1])
    # text_correct: from logits_per_text = logits.T per item
    txt_ok = (logits[:, 0, 0] > logits[:, 0, 1]) & (logits[:, 1, 1] > logits[:, 1, 0])
    group_ok = img_ok & txt_ok
    return {
        "text_score": float(txt_ok.mean()),
        "image_score": float(img_ok.mean()),
        "group_score": float(group_ok.mean()),
    }


def evaluate_group_items(encoder, items: Sequence[dict]) -> Dict[str, float]:
    """items: dicts with image_0, image_1 (PIL) and caption_0, caption_1."""
    images: List = []
    captions: List[str] = []
    for it in items:
        images += [it["image_0"].convert("RGB"), it["image_1"].convert("RGB")]
        captions += [it["caption_0"], it["caption_1"]]
    img_emb = encoder.encode_images(images).reshape(len(items), 2, -1)
    txt_emb = encoder.encode_texts(captions).reshape(len(items), 2, -1)
    return group_scores(img_emb, txt_emb)


def load_cola_items(json_path: str, images_folder: str) -> List[dict]:
    """COLA multiobjects benchmark JSON: [img0_path, cap0, img1_path, cap1]."""
    with open(json_path) as f:
        data = json.load(f)
    folder = Path(images_folder)
    items = []
    for pair in data:
        items.append({
            "image_0": Image.open(folder / Path(pair[0]).name),
            "caption_0": pair[1],
            "image_1": Image.open(folder / Path(pair[2]).name),
            "caption_1": pair[3],
        })
    return items


def evaluate_cola(encoder, json_path: str, images_folder: str) -> Dict[str, float]:
    return evaluate_group_items(encoder, load_cola_items(json_path, images_folder))


def evaluate_winoground(encoder, dataset=None) -> Dict[str, float]:
    """Winoground via HF datasets when available; ``dataset`` may be any
    sequence of dicts with image_0/image_1/caption_0/caption_1."""
    if dataset is None:
        from datasets import load_dataset  # optional dependency

        dataset = load_dataset("facebook/winoground", split="test")
    items = [
        {"image_0": ex["image_0"], "image_1": ex["image_1"],
         "caption_0": ex["caption_0"], "caption_1": ex["caption_1"]}
        for ex in dataset
    ]
    return evaluate_group_items(encoder, items)
