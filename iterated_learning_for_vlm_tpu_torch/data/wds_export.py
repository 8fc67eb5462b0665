"""Webdataset shard exporter.

A copy of ``iterated_learning_for_vlm_tpu/data/wds_export.py`` over the
port's ``data/shards.py:write_tar_shard``.

Parity target: reference ``CLIP_benchmark/clip_benchmark/webdataset_builder.py``
— convert an eval/classification/retrieval dataset into the wds-protocol
shard layout consumed by the eval builder: ``<root>/<split>/{i}.tar`` +
``nshards.txt``; ``classnames.txt`` and
``zeroshot_classification_templates.txt`` at the dataset root.
"""
from __future__ import annotations

import io
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from PIL import Image

from .shards import write_tar_shard


def export_classification_dataset(
    root: str,
    split: str,
    samples: Iterable[Tuple[Image.Image, int]],
    classnames: Sequence[str],
    templates: Optional[Sequence[str]] = None,
    samples_per_shard: int = 1000,
    image_format: str = "JPEG",
) -> int:
    """Write (image, label) samples to wds shards; returns #shards."""
    split_dir = os.path.join(root, split)
    os.makedirs(split_dir, exist_ok=True)

    def encoded():
        for i, (img, label) in enumerate(samples):
            buf = io.BytesIO()
            img.convert("RGB").save(buf, format=image_format)
            yield {
                "__key__": f"{i:08d}",
                "jpg" if image_format == "JPEG" else "png": buf.getvalue(),
                "cls": str(int(label)).encode(),
            }

    n_shards = _write_sharded(split_dir, encoded(), samples_per_shard)
    with open(os.path.join(split_dir, "nshards.txt"), "w") as f:
        f.write(str(n_shards))
    with open(os.path.join(root, "classnames.txt"), "w") as f:
        f.write("\n".join(classnames))
    if templates:
        with open(os.path.join(root, "zeroshot_classification_templates.txt"), "w") as f:
            f.write("\n".join(templates))
    return n_shards


def export_retrieval_dataset(
    root: str,
    split: str,
    samples: Iterable[Tuple[Image.Image, List[str]]],
    samples_per_shard: int = 1000,
) -> int:
    """Write (image, captions) samples; captions newline-joined in .txt."""
    split_dir = os.path.join(root, split)
    os.makedirs(split_dir, exist_ok=True)

    def encoded():
        for i, (img, captions) in enumerate(samples):
            buf = io.BytesIO()
            img.convert("RGB").save(buf, format="JPEG")
            yield {
                "__key__": f"{i:08d}",
                "jpg": buf.getvalue(),
                "txt": "\n".join(captions).encode("utf-8"),
            }

    n_shards = _write_sharded(split_dir, encoded(), samples_per_shard)
    with open(os.path.join(split_dir, "nshards.txt"), "w") as f:
        f.write(str(n_shards))
    return n_shards


def _write_sharded(split_dir: str, samples, samples_per_shard: int) -> int:
    shard_idx = 0
    buffer = []
    for sample in samples:
        buffer.append(sample)
        if len(buffer) >= samples_per_shard:
            write_tar_shard(os.path.join(split_dir, f"{shard_idx}.tar"), iter(buffer))
            shard_idx += 1
            buffer = []
    if buffer:
        write_tar_shard(os.path.join(split_dir, f"{shard_idx}.tar"), iter(buffer))
        shard_idx += 1
    return shard_idx
