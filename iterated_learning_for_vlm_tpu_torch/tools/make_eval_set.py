"""Export a held-out zeroshot eval set matching the synthetic train shards.

The port's copy of ``tools/make_eval_set.py``, with the same command line and
the same bytes for a seed, through the port's ``data/wds_export.py`` and
``data/synthetic.py``.

Writes the local-wds classification layout (``<root>/<split>/{i}.tar`` with
jpg+cls, ``nshards.txt``, ``classnames.txt``, templates) via
``data/wds_export.py`` so ``eval/builder.py:build_wds_dataset`` loads it as
``wds/<name>``.  The class PROTOTYPES come from the constructor seed
(``SyntheticClipData`` derives them from ``default_rng((seed, 1))``), so the
seed MUST match the training shards' seed or accuracy is exactly chance
(verify notes: seed-123 eval vs seed-0 training -> acc1 0.8%).  The sample
noise uses a DIFFERENT stream (``--noise-seed``), so images are held out.

Usage:
    python -m iterated_learning_for_vlm_tpu_torch.tools.make_eval_set \
        /tmp/ilvlm_eval_wds --seed 0 --per-class 4
    python -m iterated_learning_for_vlm_tpu_torch.eval.cli eval \
        --model_config configs/clip_shards_learn_tpu.yaml \
        --pretrained <ckpt.pth.tar> --dataset wds/ilvlm_eval_set \
        --dataset_root /tmp/ilvlm_eval_wds
"""
from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from ..data.synthetic import SyntheticClipData
from ..data.wds_export import export_classification_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--split", default="test")
    p.add_argument("--seed", type=int, default=0,
                   help="MUST match the training shards' seed (class "
                        "prototypes are seed-derived)")
    p.add_argument("--noise-seed", type=int, default=777,
                   help="sample-noise stream; different from training so the "
                        "images are held out")
    p.add_argument("--num-classes", type=int, default=64)
    p.add_argument("--per-class", type=int, default=4)
    p.add_argument("--image-size", type=int, default=224)
    args = p.parse_args(argv)

    gen = SyntheticClipData(batch_size=1, image_size=args.image_size,
                            seed=args.seed, correlated=True,
                            num_classes=args.num_classes)
    rng = np.random.default_rng(args.noise_seed)

    def samples():
        for cls in range(args.num_classes):
            for _ in range(args.per_class):
                img = gen._class_image(cls, rng)
                arr = np.clip((img * 0.25 + 0.5) * 255.0, 0, 255).astype(np.uint8)
                yield Image.fromarray(arr), cls

    # classnames = the caption tail INCLUDING the per-class "number k"
    # suffix, so the "a photo of {}" template reproduces the training
    # caption exactly — do not trim the suffix or zeroshot scores shift
    classnames = [
        " ".join(gen._class_caption(k).split()[3:]) for k in range(args.num_classes)
    ]
    n = export_classification_dataset(
        args.out_dir, args.split, samples(), classnames,
        templates=["a photo of {}"],
    )
    print(f"wrote {args.num_classes * args.per_class} samples / {n} shard(s) "
          f"under {args.out_dir}/{args.split}")


if __name__ == "__main__":
    main()
