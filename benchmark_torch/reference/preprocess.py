"""Plain reference of the eval transform: JPEG bytes to the tower's input pixels.

The recipe's one-crop eval transform, as the reference repository states it
with torchvision (``Resize(256)``, ``CenterCrop(224)``, ``ToTensor``,
``Normalize`` with ImageNet's mean and deviation), written out with Pillow
and numpy: decode, scale the shorter side to ``resolution * 256 / 224`` with
bicubic resampling, cut the centre square of ``resolution``, scale to [0, 1]
and normalise. It imports nothing of the program.
"""
from __future__ import annotations

import io
from typing import Sequence

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def eval_pixels(jpeg: bytes, resolution: int) -> np.ndarray:
    """One JPEG -> [resolution, resolution, 3] float32, normalised."""
    from PIL import Image

    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    w, h = img.size
    short = round(resolution * 256 / 224)
    if w <= h:
        size = (short, int(short * h / w))
    else:
        size = (int(short * w / h), short)
    img = img.resize(size, Image.BICUBIC)
    left = int(round((size[0] - resolution) / 2.0))
    top = int(round((size[1] - resolution) / 2.0))
    img = img.crop((left, top, left + resolution, top + resolution))
    pixels = np.asarray(img, np.float32) / 255.0
    return (pixels - IMAGENET_MEAN) / IMAGENET_STD


def eval_batch(jpegs: Sequence[bytes], resolution: int, device) -> torch.Tensor:
    """JPEGs -> [N, resolution, resolution, 3] float32 on ``device``."""
    return torch.from_numpy(np.stack([eval_pixels(j, resolution) for j in jpegs])).to(device)
