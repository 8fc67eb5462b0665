"""COCO caption dataset loaders.

A copy of ``iterated_learning_for_vlm_tpu/data/coco.py``.

Parity target: reference ``prototype/data/datasets/coco.py`` /
``coco_dataset.py`` + ``COCOCaptionDataset`` (clip_dataset_wsd.py:247-273):
image + caption pairs from COCO-style annotation JSONs, usable for retrieval
eval and caption-supervised training.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

from PIL import Image


def load_coco_captions(annotation_path: str) -> Dict[str, List[str]]:
    """COCO ``captions_*.json`` -> {file_name: [captions...]}."""
    with open(annotation_path, encoding="utf-8") as f:
        ann = json.load(f)
    id2file = {img["id"]: img["file_name"] for img in ann["images"]}
    out: Dict[str, List[str]] = {}
    for a in ann["annotations"]:
        fn = id2file.get(a["image_id"])
        if fn is not None:
            out.setdefault(fn, []).append(a["caption"])
    return out


def load_karpathy_split(json_path: str, split: str = "test") -> List[Tuple[str, List[str]]]:
    """Karpathy ``dataset_coco.json`` -> [(relative_image_path, captions)]."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    out = []
    for img in data["images"]:
        if img.get("split") != split:
            continue
        path = os.path.join(img.get("filepath", ""), img["filename"])
        caps = [s["raw"] for s in img["sentences"]]
        out.append((path, caps))
    return out


class COCOCaptionDataset:
    """(PIL image, captions) pairs for retrieval eval / caption training."""

    def __init__(self, image_root: str, annotation_path: str,
                 karpathy_split: Optional[str] = None,
                 max_items: Optional[int] = None):
        self.image_root = image_root
        if karpathy_split is not None:
            items = load_karpathy_split(annotation_path, karpathy_split)
        else:
            items = sorted(load_coco_captions(annotation_path).items())
        if max_items:
            items = items[:max_items]
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i) -> Tuple[Image.Image, List[str]]:
        path, caps = self.items[i]
        img = Image.open(os.path.join(self.image_root, path)).convert("RGB")
        return img, caps

    def __iter__(self) -> Iterator[Tuple[Image.Image, List[str]]]:
        for i in range(len(self)):
            yield self[i]
