"""Write correlated synthetic image-caption pairs as webdataset tar shards.

The port's copy of ``tools/make_train_shards.py``, with the same command
line and the same output: the CC3M on-disk layout (``{00000..n}.tar`` with
``.jpg`` and ``.txt`` members), so training runs the whole shard pipeline
(tar expansion, JPEG decode, MOCOV2 augment, tokenization, the (seed, epoch)
shard shuffle) with no download. Captions name the image's class, so
contrastive training has a real signal. It writes through the port's
``data/shards.write_tar_shard`` and ``data/synthetic.SyntheticClipData``.

    python -m iterated_learning_for_vlm_tpu_torch.tools.make_train_shards /tmp/shards \\
        --shards 8 --per-shard 500

:func:`write_shards` is the same as a function, with ``caption_fn`` to
rewrite captions (for example, to make some of them long).
"""
from __future__ import annotations

import argparse
import io
import os
from typing import Callable, List, Optional

import numpy as np

from ..data.shards import write_tar_shard
from ..data.synthetic import SyntheticClipData


def write_shards(out_dir: str, shards: int = 8, per_shard: int = 500, image_size: int = 224,
                 num_classes: int = 64, seed: int = 0,
                 caption_fn: Optional[Callable[[int, str], str]] = None) -> List[str]:
    """Write ``shards`` tars of ``per_shard`` samples into ``out_dir``; returns
    their paths. Sample ``k`` (counted across shards) draws a class, and its
    caption is the class caption, or ``caption_fn(k, caption)``."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    gen = SyntheticClipData(batch_size=1, image_size=image_size, seed=seed, correlated=True,
                            num_classes=num_classes)
    rng = np.random.default_rng(seed)
    paths, k = [], 0
    for s in range(shards):
        samples = []
        for _ in range(per_shard):
            cls = int(rng.integers(0, num_classes))
            img = gen._class_image(cls, rng)
            # standard-normal-ish floats -> displayable uint8
            arr = np.clip((img * 0.25 + 0.5) * 255.0, 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90)
            caption = gen._class_caption(cls)
            if caption_fn is not None:
                caption = caption_fn(k, caption)
            samples.append({"__key__": f"{k:08d}", "jpg": buf.getvalue(),
                            "txt": caption.encode()})
            k += 1
        path = os.path.join(out_dir, f"{s:05d}.tar")
        write_tar_shard(path, iter(samples))
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--per-shard", type=int, default=500)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    paths = write_shards(args.out_dir, args.shards, args.per_shard, args.image_size,
                         args.num_classes, args.seed)
    for path in paths:
        print(f"wrote {path} ({args.per_shard} samples)")
    print(f"total {args.shards * args.per_shard} samples in {args.shards} shards")


if __name__ == "__main__":
    main()
