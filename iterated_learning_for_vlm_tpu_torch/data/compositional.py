"""Two-factor compositional synthetic data: colored shapes.

A copy of ``iterated_learning_for_vlm_tpu/data/compositional.py``: the same
pixels and captions for a seed.

The paper's claim (README.md:1-8, arXiv:2404.02145) is that iterated
learning improves COMPOSITIONALITY — the model's ability to bind attributes
to objects and generalize to UNSEEN attribute-object combinations.  CC3M
can't be shipped in this environment, so this module builds a synthetic task
where that claim is directly measurable:

- factors: ``len(COLORS) x len(SHAPES)`` compositions; an image is a
  procedurally drawn shape filled with a color over a noisy background, and
  its caption is ``"a photo of a <color> <shape>"``.
- a fixed subset of compositions is HELD OUT (``is_held_out``): training
  shards contain only seen pairs; evaluation probes the unseen ones.
- the probe is SugarCREPE-shaped (``eval/sugar_crepe.py`` JSON contract:
  ``{idx: {filename, caption, negative_caption}}``): for an unseen-pair
  image, the positive caption names the true (unseen) composition and the
  negative swaps one factor to a composition the model HAS seen — so a
  model that merely memorizes seen pairings prefers the negative, and only
  compositional binding scores above chance.

Drawing is pure numpy (no PIL dependency here); shapes are built from
coordinate grids so any resolution works.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# word -> RGB fill (distinct hues, CLIP-BPE-friendly single tokens)
COLORS: Dict[str, Tuple[float, float, float]] = {
    "red": (0.9, 0.1, 0.1),
    "green": (0.1, 0.8, 0.15),
    "blue": (0.15, 0.25, 0.95),
    "yellow": (0.95, 0.9, 0.1),
    "magenta": (0.9, 0.15, 0.85),
    "cyan": (0.1, 0.85, 0.9),
    "orange": (0.95, 0.55, 0.1),
    "purple": (0.55, 0.15, 0.85),
}
SHAPES: Tuple[str, ...] = (
    "circle", "square", "triangle", "ring", "cross", "diamond",
    "stripes", "frame",
)
COLOR_NAMES: Tuple[str, ...] = tuple(COLORS)


def caption_for(color: str, shape: str) -> str:
    return f"a photo of a {color} {shape}"


def is_held_out(color_idx: int, shape_idx: int, fold: int = 4) -> bool:
    """Fixed compositional split: 1/``fold`` of the grid is unseen.

    ``(ci + si) % fold == 0`` spreads the held-out cells so every color and
    every shape appears in training (only specific COMBINATIONS are new) —
    the precondition for a meaningful systematicity probe (compare CREPE's
    seen-compound / unseen-compound split, ``eval/crepe.py``)."""
    return (color_idx + shape_idx) % fold == 0


def seen_pairs(fold: int = 4) -> List[Tuple[int, int]]:
    return [(c, s) for c in range(len(COLOR_NAMES)) for s in range(len(SHAPES))
            if not is_held_out(c, s, fold)]


def unseen_pairs(fold: int = 4) -> List[Tuple[int, int]]:
    return [(c, s) for c in range(len(COLOR_NAMES)) for s in range(len(SHAPES))
            if is_held_out(c, s, fold)]


def _shape_mask(shape: str, size: int, cx: float, cy: float, r: float) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    dx, dy = x - cx, y - cy
    dist = np.sqrt(dx * dx + dy * dy)
    if shape == "circle":
        return dist < r
    if shape == "square":
        return (np.abs(dx) < r * 0.85) & (np.abs(dy) < r * 0.85)
    if shape == "triangle":  # upward triangle
        return (dy > -r) & (dy < r) & (np.abs(dx) < (dy + r) * 0.55)
    if shape == "ring":
        return (dist < r) & (dist > r * 0.55)
    if shape == "cross":
        w = r * 0.32
        return ((np.abs(dx) < w) & (np.abs(dy) < r)) | (
            (np.abs(dy) < w) & (np.abs(dx) < r))
    if shape == "diamond":
        return (np.abs(dx) + np.abs(dy)) < r * 1.15
    if shape == "stripes":
        sq = (np.abs(dx) < r * 0.9) & (np.abs(dy) < r * 0.9)
        period = max(2, int(r * 0.45))
        return sq & (((y - cy + 4 * r).astype(np.int32) // period) % 2 == 0)
    if shape == "frame":
        outer = (np.abs(dx) < r * 0.9) & (np.abs(dy) < r * 0.9)
        inner = (np.abs(dx) < r * 0.55) & (np.abs(dy) < r * 0.55)
        return outer & ~inner
    raise ValueError(f"unknown shape {shape!r}")


def draw(color_idx: int, shape_idx: int, size: int,
         rng: np.random.Generator, noise: float = 0.06) -> np.ndarray:
    """[size, size, 3] float32 in [0, 1]: colored shape, jittered placement,
    gray background, additive noise.  Position/scale jitter makes the task
    crop-robust (ONECROP) without destroying the factor structure."""
    cx = size * (0.5 + float(rng.uniform(-0.08, 0.08)))
    cy = size * (0.5 + float(rng.uniform(-0.08, 0.08)))
    r = size * float(rng.uniform(0.22, 0.3))
    mask = _shape_mask(SHAPES[shape_idx], size, cx, cy, r)
    bg = 0.35 + 0.1 * float(rng.uniform(-1, 1))
    img = np.full((size, size, 3), bg, np.float32)
    img[mask] = np.asarray(COLORS[COLOR_NAMES[color_idx]], np.float32)
    img += noise * rng.standard_normal(img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (img * 255.0 + 0.5).astype(np.uint8)


# ---- two-object scenes (round 4) -------------------------------------------
# SugarCREPE's add/swap/relation contract types (reference
# ``eval/sugar_crepe.py:13-63``: add_obj/add_att/swap_obj/swap_att/replace_rel)
# need scenes with TWO bound (color, shape) objects: the negative caption
# re-binds factors ACROSS objects (swap), asserts an absent object/attribute
# (add), or flips the stated spatial relation (replace_rel).

RELATIONS: Tuple[str, ...] = ("left of", "right of", "above", "below")
_REL_OPPOSITE = {"left of": "right of", "right of": "left of",
                 "above": "below", "below": "above"}


def opposite_relation(rel: str) -> str:
    return _REL_OPPOSITE[rel]


def caption_two(c1: str, s1: str, c2: str, s2: str, rel: str = "and") -> str:
    """``rel="and"`` -> conjunction scene; else a spatial relation caption.

    The first-named object is the relation's subject: "a red circle left of
    a blue square" means the red circle sits to the LEFT."""
    if rel == "and":
        return f"a photo of a {c1} {s1} and a {c2} {s2}"
    return f"a photo of a {c1} {s1} {rel} a {c2} {s2}"


def draw_two(pair1: Tuple[int, int], pair2: Tuple[int, int], rel: str,
             size: int, rng: np.random.Generator,
             noise: float = 0.06) -> np.ndarray:
    """[size, size, 3] scene with object 1 positioned ``rel`` object 2
    (``rel="and"`` draws them side by side, order jittered)."""
    placements = {
        "and": ((0.28, 0.5), (0.72, 0.5)),
        "left of": ((0.28, 0.5), (0.72, 0.5)),
        "right of": ((0.72, 0.5), (0.28, 0.5)),
        "above": ((0.5, 0.28), (0.5, 0.72)),
        "below": ((0.5, 0.72), (0.5, 0.28)),
    }
    (fx1, fy1), (fx2, fy2) = placements[rel]
    if rel == "and" and rng.uniform() < 0.5:  # "and" is order-free
        (fx1, fy1), (fx2, fy2) = (fx2, fy2), (fx1, fy1)
    bg = 0.35 + 0.1 * float(rng.uniform(-1, 1))
    img = np.full((size, size, 3), bg, np.float32)
    for (ci, si), fx, fy in ((pair1, fx1, fy1), (pair2, fx2, fy2)):
        cx = size * (fx + float(rng.uniform(-0.04, 0.04)))
        cy = size * (fy + float(rng.uniform(-0.04, 0.04)))
        r = size * float(rng.uniform(0.13, 0.17))
        mask = _shape_mask(SHAPES[si], size, cx, cy, r)
        img[mask] = np.asarray(COLORS[COLOR_NAMES[ci]], np.float32)
    img += noise * rng.standard_normal(img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def distinct_pair2(pair1: Tuple[int, int], pool: Sequence[Tuple[int, int]],
                   rng: np.random.Generator) -> Tuple[int, int]:
    """A second scene object with a different color AND shape than the first
    (so swap negatives re-bind unambiguously)."""
    c1, s1 = pair1
    cands = [p for p in pool if p[0] != c1 and p[1] != s1]
    return cands[int(rng.integers(0, len(cands)))]


def negative_pair(color_idx: int, shape_idx: int, swap: str,
                  rng: np.random.Generator, fold: int = 4,
                  require_seen: bool = True) -> Tuple[int, int]:
    """A negative composition differing in ONE factor.

    ``swap="color"`` (SugarCREPE replace-att analogue) or ``"shape"``
    (replace-obj).  With ``require_seen`` the negative is a composition the
    model TRAINED on — the adversarial direction for a pair-memorizing
    model scoring an unseen-pair image."""
    n_c, n_s = len(COLOR_NAMES), len(SHAPES)
    cands = []
    if swap == "color":
        cands = [(c, shape_idx) for c in range(n_c) if c != color_idx]
    elif swap == "shape":
        cands = [(color_idx, s) for s in range(n_s) if s != shape_idx]
    else:
        raise ValueError(swap)
    if require_seen:
        seen = [p for p in cands if not is_held_out(p[0], p[1], fold)]
        cands = seen or cands
    return cands[int(rng.integers(0, len(cands)))]
