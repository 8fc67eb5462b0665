"""Image augmentation recipes (host side; a PIL path and a native fused C path).

A copy of ``iterated_learning_for_vlm_tpu/data/augment.py`` (reference
``prototype/data/imagenet_dataloader.py:9-120`` ``build_common_augmentation``):

- ``MOCOV2_single`` (the training recipe, ``config_cc3m.yaml:71``):
  RandomResizedCrop(224, scale=(0.2, 1)) -> ColorJitter(.4,.4,.4,.1)@p=.8 ->
  RandomGrayscale(p=.2) -> GaussianBlur(sigma U[.1,2])@p=.5 -> HFlip(p=.5) ->
  ToTensor -> ImageNet normalize (mean .485/.456/.406, std .229/.224/.225).
- ``ONECROP`` (eval): Resize(256) -> CenterCrop(224) -> normalize.

Outputs are NHWC float32 (the towers' layout; the reference is NCHW), or
uint8 pixels for the uint8 wire (``out_u8``). Randomness comes from an
explicit ``np.random.Generator``, so the pipeline is reproducible per (seed,
epoch, shard, sample), and for the same generator state every function here
gives the JAX package's array bit for bit.

Two executions of the same recipe:

- **native** (the default when it builds): ONE C call per image
  (``data/native/fused_augment.c``) fusing crop-resize -> jitter -> gray ->
  blur -> flip -> normalize; it releases the GIL, so the loader's threads
  scale across the host's cores;
- **PIL** (``ILVLM_NATIVE_AUGMENT=0``, or no compiler).

Both draw ALL random parameters from the same helpers in the same order
(:func:`mocov2_plan`), so a given (seed, sample) makes the same crop, jitter,
blur and flip decisions either way. Jitter, gray and HSV arithmetic are
bit-exact to PIL; resampling differs slightly (float vs PIL fixed-point
bicubic taps; one final quantization vs PIL's per-pass rounding in the box
blur cascade). PIL is imported only by the PIL-path functions, so the native
path on a uint8 array runs where Pillow is not installed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


# fused uint8 -> normalized float32: x/255 then (x-mean)/std collapses to
# one multiply-add pass (x * scale + offset)
_NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_NORM_OFFSET = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)

# uint8 WIRE format (``out_u8=True`` recipes + data.train.wire_dtype: uint8):
# the augment chain holds uint8 pixels until its final normalize either way
# (PIL ops are uint8; the native kernel normalizes from a uint8 buffer,
# data/native/fused_augment.c:437-445), so emitting the uint8 pixels and
# applying the SAME fp32 multiply-add on the device
# (``data/pipeline.py:normalize_device_batch``) reproduces the host float path
# to within 1 fp32 ulp (exactly, where the device rounds the product and the
# sum apart as numpy does) while the host-to-device image bytes drop 4x (a
# bs256 fp32 batch at 224 px is 154 MB, its uint8 form 38.5 MB).
_U8_SCALE = np.ones(3, dtype=np.float32)
_U8_OFFSET = np.zeros(3, dtype=np.float32)


def _to_array(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr * _NORM_SCALE + _NORM_OFFSET


# --------------------------------------------------------------------------
# Random parameter draws, shared by the PIL and native executions.
# Draw ORDER is part of the contract: it pins the rng stream.
# --------------------------------------------------------------------------

def rrc_box(
    w: int,
    h: int,
    rng: np.random.Generator,
    scale: Tuple[float, float] = (0.2, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box (10 tries then center fallback):
    returns (x, y, crop_w, crop_h) in source coordinates."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return x, y, cw, ch
    # fallback: center crop to in-range aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


# op ids shared with the C kernel
OP_BRIGHTNESS, OP_CONTRAST, OP_SATURATION, OP_HUE = 0, 1, 2, 3


def jitter_plan(rng: np.random.Generator, brightness=0.4, contrast=0.4,
                saturation=0.4, hue=0.1) -> List[Tuple[int, float]]:
    """ColorJitter factors + application order: [(op_id, factor), ...]."""
    ops: List[Tuple[int, float]] = []
    if brightness > 0:
        ops.append((OP_BRIGHTNESS, rng.uniform(max(0, 1 - brightness), 1 + brightness)))
    if contrast > 0:
        ops.append((OP_CONTRAST, rng.uniform(max(0, 1 - contrast), 1 + contrast)))
    if saturation > 0:
        ops.append((OP_SATURATION, rng.uniform(max(0, 1 - saturation), 1 + saturation)))
    if hue > 0:
        ops.append((OP_HUE, rng.uniform(-hue, hue)))
    order = rng.permutation(len(ops))
    return [ops[i] for i in order]


@dataclass
class AugmentPlan:
    """All stochastic decisions of one MOCOV2_single application."""
    box: Tuple[int, int, int, int]            # (x, y, cw, ch)
    jitter: List[Tuple[int, float]]           # [] when the 0.8 gate fails
    grayscale: bool
    blur_sigma: float                         # <= 0 disables
    flip: bool


def mocov2_plan(w: int, h: int, rng: np.random.Generator) -> AugmentPlan:
    box = rrc_box(w, h, rng)
    jitter = jitter_plan(rng) if rng.random() < 0.8 else []
    grayscale = rng.random() < 0.2
    blur_sigma = -1.0
    if rng.random() < 0.5:
        blur_sigma = float(rng.uniform(0.1, 2.0))
    flip = rng.random() < 0.5
    return AugmentPlan(box, jitter, grayscale, blur_sigma, flip)


# --------------------------------------------------------------------------
# PIL execution
# --------------------------------------------------------------------------

def random_resized_crop(
    img: Image.Image,
    rng: np.random.Generator,
    size: int = 224,
    scale: Tuple[float, float] = (0.2, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Image.Image:
    """torchvision RandomResizedCrop semantics (10 tries then center fallback)."""
    from PIL import Image

    w, h = img.size
    x, y, cw, ch = rrc_box(w, h, rng, scale, ratio)
    return img.resize((size, size), Image.BICUBIC, box=(x, y, x + cw, y + ch))


def _hue_shift(im: Image.Image, f: float) -> Image.Image:
    """Shift hue by ``f`` turns via a 256-entry LUT on the H channel.

    ``point()`` runs in C; this replaces a numpy HSV round-trip that cost
    ~2.4 ms/image (65% of the jitter budget on the JAX package's ingest
    profile) with ~0.8 ms, same uint8 HSV transform."""
    from PIL import Image

    hsv = im.convert("HSV")
    h, s, v = hsv.split()
    off = int(f * 255)
    lut = [(i + off) % 256 for i in range(256)]
    return Image.merge("HSV", (h.point(lut), s, v)).convert("RGB")


def _pil_jitter(op: int, im, f: float):
    """One ColorJitter op on a PIL image."""
    from PIL import ImageEnhance

    if op == OP_HUE:
        return _hue_shift(im, f)
    enhance = {OP_BRIGHTNESS: ImageEnhance.Brightness, OP_CONTRAST: ImageEnhance.Contrast,
               OP_SATURATION: ImageEnhance.Color}[op]
    return enhance(im).enhance(f)


def color_jitter(img: Image.Image, rng: np.random.Generator,
                 brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1) -> Image.Image:
    for op, f in jitter_plan(rng, brightness, contrast, saturation, hue):
        img = _pil_jitter(op, img, f)
    return img


def _mocov2_pil(img: Image.Image, plan: AugmentPlan, size: int,
                out_u8: bool = False) -> np.ndarray:
    from PIL import Image, ImageFilter

    x, y, cw, ch = plan.box
    img = img.resize((size, size), Image.BICUBIC, box=(x, y, x + cw, y + ch))
    for op, f in plan.jitter:
        img = _pil_jitter(op, img, f)
    if plan.grayscale:
        img = img.convert("L").convert("RGB")
    if plan.blur_sigma > 0:
        img = img.filter(ImageFilter.GaussianBlur(radius=plan.blur_sigma))
    if plan.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if out_u8:  # the PIL image IS uint8 — no precision is lost here
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    return _to_array(img)


# --------------------------------------------------------------------------
# Native execution
# --------------------------------------------------------------------------

def _native_lib():
    from . import native

    return native if native.available() else None


def _mocov2_native(arr: np.ndarray, plan: AugmentPlan, size: int,
                   out_u8: bool = False) -> np.ndarray:
    from . import native

    x, y, cw, ch = plan.box
    out = native.fused_augment(
        arr, (x, y, cw, ch), size,
        [op for op, _ in plan.jitter], [f for _, f in plan.jitter],
        plan.grayscale, plan.blur_sigma, plan.flip,
        _U8_SCALE if out_u8 else _NORM_SCALE,
        _U8_OFFSET if out_u8 else _NORM_OFFSET,
    )
    if out_u8:  # exact: the kernel normalizes FROM a uint8 buffer, so with
        # scale 1 / offset 0 every value is an exact small integer in fp32
        return out.astype(np.uint8)
    return out


def _as_pil(img):
    """An RGB PIL image from a PIL image or an HxWx3 uint8 array."""
    if isinstance(img, np.ndarray):
        from PIL import Image

        return Image.fromarray(img)
    return img.convert("RGB")


def _as_rgb_array(img) -> np.ndarray:
    if isinstance(img, np.ndarray):
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        return np.ascontiguousarray(img[..., :3], dtype=np.uint8)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


# --------------------------------------------------------------------------
# Recipes
# --------------------------------------------------------------------------

def mocov2_single(img, rng: np.random.Generator, size: int = 224,
                  native: Optional[bool] = None,
                  out_u8: bool = False) -> np.ndarray:
    """MOCOV2_single on a PIL image (or HxWx3 uint8 array).

    ``native=None`` auto-selects the fused C path when it is built
    (``ILVLM_NATIVE_AUGMENT=0`` forces PIL); both paths consume the identical
    rng stream via :func:`mocov2_plan`."""
    use_native = _native_lib() is not None if native is None else native
    if use_native:
        arr = _as_rgb_array(img)
        plan = mocov2_plan(arr.shape[1], arr.shape[0], rng)
        return _mocov2_native(arr, plan, size, out_u8)
    img = _as_pil(img)
    plan = mocov2_plan(img.size[0], img.size[1], rng)
    return _mocov2_pil(img, plan, size, out_u8)


def onecrop(img, rng: np.random.Generator | None = None,
            resize: int = 256, size: int = 224,
            native: Optional[bool] = None,
            out_u8: bool = False) -> np.ndarray:
    use_native = _native_lib() is not None if native is None else native
    if use_native:
        from . import native as native_mod

        arr = _as_rgb_array(img)
        h, w = arr.shape[:2]
        if w < h:
            nw, nh = resize, int(round(h * resize / w))
        else:
            nw, nh = int(round(w * resize / h)), resize
        left, top = (nw - size) // 2, (nh - size) // 2
        # fused box resize == staged resize-then-crop: out pixel i center maps
        # to (left + i + 0.5) * w / nw either way (same filterscale)
        sx, sy = w / nw, h / nh
        out = native_mod.fused_augment(
            arr, (left * sx, top * sy, size * sx, size * sy), size,
            [], [], False, -1.0, False,
            _U8_SCALE if out_u8 else _NORM_SCALE,
            _U8_OFFSET if out_u8 else _NORM_OFFSET,
        )
        return out.astype(np.uint8) if out_u8 else out
    from PIL import Image

    img = _as_pil(img)
    w, h = img.size
    if w < h:
        nw, nh = resize, int(round(h * resize / w))
    else:
        nw, nh = int(round(w * resize / h)), resize
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    if out_u8:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    return _to_array(img)


_RECIPES = {
    "MOCOV2_single": mocov2_single,
    "MOCOV2": mocov2_single,
    "SIMCLR": mocov2_single,
    "SIMSIAM": mocov2_single,
    "ONECROP": onecrop,
}


def build_common_augmentation(name: str, image_size: int = None,
                              out_u8: bool = False):
    """Name-compatible entry point (reference ``build_common_augmentation``).

    ``image_size`` overrides the recipes' 224 output (the reference is
    hard-coded to 224; models at other resolutions need matching crops —
    the solver threads ``vision_cfg.input_resolution`` through).

    ``out_u8`` emits uint8 pixels (pre-normalize) for the uint8 wire format
    (see ``_U8_SCALE`` note); consumers must apply
    ``x * _NORM_SCALE + _NORM_OFFSET`` in fp32 — bit-identical to the host
    float path."""
    if name not in _RECIPES:
        raise KeyError(f"unknown augmentation recipe {name!r}; known: {sorted(_RECIPES)}")
    fn = _RECIPES[name]
    import functools

    if not image_size or image_size == 224:
        return functools.partial(fn, out_u8=out_u8) if out_u8 else fn
    if fn is onecrop:
        # keep the reference's 256/224 resize-to-crop ratio
        return functools.partial(onecrop, resize=round(image_size * 256 / 224),
                                 size=image_size, out_u8=out_u8)
    return functools.partial(fn, size=image_size, out_u8=out_u8)
