"""AutoAugment (ImageNet policy), RandAugment and the CLSA strong augment, on PIL.

A copy of ``iterated_learning_for_vlm_tpu/data/auto_augment.py`` (reference
``prototype/data/auto_augmentation.py`` and the RandAugment / CLSA recipes of
``prototype/data/transform/*``): each op takes (img, magnitude, rng); the
policies follow the AutoAugment paper's (op, prob, magnitude) sub-policy
pairs. For the same generator state each gives the JAX package's image.
"""
from __future__ import annotations

import random
from typing import Callable, List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps


def _shear_x(img, v, _):
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, v, _):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x(img, v, _):
    return img.transform(img.size, Image.AFFINE, (1, 0, v * img.size[0], 0, 1, 0))


def _translate_y(img, v, _):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v * img.size[1]))


def _rotate(img, v, _):
    return img.rotate(v)


def _auto_contrast(img, _v, _):
    return ImageOps.autocontrast(img)


def _invert(img, _v, _):
    return ImageOps.invert(img)


def _equalize(img, _v, _):
    return ImageOps.equalize(img)


def _solarize(img, v, _):
    return ImageOps.solarize(img, int(v))


def _posterize(img, v, _):
    return ImageOps.posterize(img, max(1, int(v)))


def _contrast(img, v, _):
    return ImageEnhance.Contrast(img).enhance(v)


def _color(img, v, _):
    return ImageEnhance.Color(img).enhance(v)


def _brightness(img, v, _):
    return ImageEnhance.Brightness(img).enhance(v)


def _sharpness(img, v, _):
    return ImageEnhance.Sharpness(img).enhance(v)


# op name -> (fn, magnitude_range)
_OPS = {
    "ShearX": (_shear_x, (-0.3, 0.3)),
    "ShearY": (_shear_y, (-0.3, 0.3)),
    "TranslateX": (_translate_x, (-0.45, 0.45)),
    "TranslateY": (_translate_y, (-0.45, 0.45)),
    "Rotate": (_rotate, (-30, 30)),
    "AutoContrast": (_auto_contrast, (0, 1)),
    "Invert": (_invert, (0, 1)),
    "Equalize": (_equalize, (0, 1)),
    "Solarize": (_solarize, (256, 0)),
    "Posterize": (_posterize, (8, 4)),
    "Contrast": (_contrast, (0.1, 1.9)),
    "Color": (_color, (0.1, 1.9)),
    "Brightness": (_brightness, (0.1, 1.9)),
    "Sharpness": (_sharpness, (0.1, 1.9)),
}


def _mag(op: str, level: int, levels: int = 10) -> float:
    lo, hi = _OPS[op][1]
    return lo + (hi - lo) * level / levels


# AutoAugment ImageNet policy sub-policies: ((op, p, level), (op, p, level))
_IMAGENET_POLICY: List[Tuple[Tuple[str, float, int], Tuple[str, float, int]]] = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
]


def imagenet_auto_augment(img: Image.Image, rng: np.random.Generator) -> Image.Image:
    """Reference ``ImageNetPolicy``: pick a random sub-policy; apply each op
    with its probability at its magnitude."""
    sub = _IMAGENET_POLICY[int(rng.integers(len(_IMAGENET_POLICY)))]
    for op, p, level in sub:
        if rng.random() < p:
            img = _OPS[op][0](img, _mag(op, level), rng)
    return img


def rand_augment(img: Image.Image, rng: np.random.Generator, n: int = 2,
                 magnitude: int = 9) -> Image.Image:
    """RandAugment(N, M): apply N random ops at magnitude M."""
    names = list(_OPS)
    for _ in range(n):
        op = names[int(rng.integers(len(names)))]
        img = _OPS[op][0](img, _mag(op, magnitude), rng)
    return img


def clsa_strong_augment(img: Image.Image, rng: np.random.Generator,
                        num_of_times: int = 5) -> Image.Image:
    """CLSA stronger augmentation (reference ``CLSAAug``: randaugment applied
    ``num_of_times`` repeatedly with random magnitudes)."""
    for _ in range(num_of_times):
        img = rand_augment(img, rng, n=1, magnitude=int(rng.integers(1, 10)))
    return img
