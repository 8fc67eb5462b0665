"""Feature extraction / dump tool.

Counterpart of ``iterated_learning_for_vlm_tpu/tools/inference.py`` over the
port's ``TorchEncoder`` (``eval/model_loader.py:load_eval_encoder``), on the
CUDA card unless ``--device`` names another device::

    python -m iterated_learning_for_vlm_tpu_torch.tools.inference \\
        --model_config cfg.yaml --pretrained ckpt_N.pth.tar \\
        --image_dir imgs/ --captions_file caps.txt --out features.npz

Parity target: reference ``prototype/tools/inference.py`` (feature dump +
visualization on the legacy solver): run a checkpointed model over a dataset
and write embeddings (and optionally FDT attention weights) to an ``.npz``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def dump_features(encoder, images=None, texts=None, out_path="features.npz"):
    arrays = {}
    if images is not None:
        arrays["image_embeds"] = encoder.encode_images(images)
    if texts is not None:
        arrays["text_embeds"] = encoder.encode_texts(list(texts))
    np.savez(out_path, **arrays)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_config", required=True)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--captions_file", default=None, help="one caption per line")
    p.add_argument("--out", default="features.npz")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    from ..eval.model_loader import load_eval_encoder

    encoder = load_eval_encoder(args.model_config, args.pretrained,
                                batch_size=args.batch_size, device=args.device)
    images = None
    if args.image_dir:
        from PIL import Image

        images = [
            Image.open(os.path.join(args.image_dir, f)).convert("RGB")
            for f in sorted(os.listdir(args.image_dir))
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
        ]
    texts = None
    if args.captions_file:
        with open(args.captions_file, encoding="utf-8") as f:
            texts = [l.strip() for l in f if l.strip()]
    path = dump_features(encoder, images, texts, args.out)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
