"""Synthetic and dummy datasets.

A copy of ``iterated_learning_for_vlm_tpu/data/synthetic.py`` through the
port's own tokenizer (``data/tokenizer.py``): for the same seed, rank and
index, :class:`SyntheticClipData` gives the same image, tokens and pad-mask
arrays as the JAX package's.

- :class:`SyntheticClipData`: deterministic random image/caption batches for
  benchmarks and smoke training (no download, no decode).
- :class:`DummyDataset`: one blank image with classes
  ["blank image", "noisy image"], the CLIP_benchmark test fixture (reference
  ``CLIP_benchmark/clip_benchmark/datasets/builder.py:514-523``).

The DeCLIP recipes' batch extras (``two_views``, ``mask_type``) are not
ported yet (ROADMAP.md Queue 1 item 6) and raise.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from .tokenizer import get_tokenizer

_WORDS = (
    "a photo of the small big red blue green dog cat bird car tree house "
    "person child water sky mountain street food table chair window flower"
).split()


class SyntheticClipData:
    """Deterministic random batches shaped like the CC3M pipeline output.

    ``correlated=True`` makes the task learnable: each sample draws a class
    k, the caption names it and the image is a class-specific block pattern
    plus noise, so contrastive training has real signal. ``rank`` /
    ``world_size`` give disjoint per-process streams (and, correlated, a
    disjoint class partition); the class prototypes come from ``seed`` alone.
    """

    def __init__(self, batch_size: int, image_size: int = 224, context_length: int = 77,
                 seed: int = 0, num_batches: int = 100, tokenizer=None,
                 correlated: bool = False, num_classes: int = 64,
                 noise_scale: float = 0.3, two_views: bool = False,
                 mask_type: str = None, rank: int = 0, world_size: int = 1):
        if two_views or mask_type:
            raise NotImplementedError(
                "two_views / mask_type (the DeCLIP recipes' second view and masked "
                "tokens) are not ported to the PyTorch package yet (ROADMAP.md Queue 1 "
                "item 6, recipes)")
        self.rank = rank
        self.world_size = max(1, world_size)
        self.batch_size = batch_size
        self.image_size = image_size
        self.context_length = context_length
        self.seed = seed
        self.num_batches = num_batches
        self.tokenizer = tokenizer or get_tokenizer()
        self.correlated = correlated
        self.num_classes = num_classes
        self.noise_scale = noise_scale
        if correlated:
            proto_rng = np.random.default_rng((seed, 1))
            grid = max(4, image_size // 16)
            self._protos = proto_rng.standard_normal(
                (num_classes, grid, grid, 3)
            ).astype(np.float32)
            self._grid = grid

    def caption(self, rng: np.random.Generator) -> str:
        n = int(rng.integers(3, 12))
        return " ".join(rng.choice(_WORDS) for _ in range(n))

    def _class_caption(self, k: int) -> str:
        n = len(_WORDS)
        return f"a photo of {_WORDS[k % n]} {_WORDS[(k * 7 + 3) % n]} number {k}"

    def _class_image(self, k: int, rng: np.random.Generator) -> np.ndarray:
        up = self.image_size // self._grid
        base = np.kron(self._protos[k], np.ones((up, up, 1), np.float32))
        base = base[: self.image_size, : self.image_size]
        return base + self.noise_scale * rng.standard_normal(base.shape).astype(np.float32)

    def batch(self, index: int = 0) -> Dict[str, np.ndarray]:
        key = (self.seed, index) if self.rank == 0 else (self.seed, self.rank, index)
        rng = np.random.default_rng(key)
        if self.correlated:
            if self.world_size > 1:  # disjoint per-process class partition
                mine = np.arange(self.rank, self.num_classes, self.world_size)
                ks = rng.permutation(mine)[: self.batch_size]
                if len(ks) < self.batch_size:
                    ks = mine[rng.integers(0, len(mine), self.batch_size)]
            else:
                ks = rng.permutation(self.num_classes)[: self.batch_size]
                if len(ks) < self.batch_size:  # classes < batch: repeats
                    ks = rng.integers(0, self.num_classes, self.batch_size)
            images = np.stack([self._class_image(int(k), rng) for k in ks])
            captions = [self._class_caption(int(k)) for k in ks]
        else:
            images = rng.standard_normal(
                (self.batch_size, self.image_size, self.image_size, 3), dtype=np.float32
            )
            captions = [self.caption(rng) for _ in range(self.batch_size)]
        tokens, pad_mask = self.tokenizer(captions, context_length=self.context_length)
        return {"image": images.astype(np.float32, copy=False), "tokens": tokens,
                "pad_mask": pad_mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.batches()

    def batches(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Batches ``start`` .. ``num_batches - 1``: each is keyed by its index,
        so a resume that starts mid-epoch makes none of the batches it skips."""
        for i in range(start, self.num_batches):
            yield self.batch(i)


class DummyDataset:
    """CLIP_benchmark 'Dummy': N copies of a blank image, 2 classnames."""

    classes: List[str] = ["blank image", "noisy image"]
    templates: List[str] = ["a photo of {}"]

    def __init__(self, n: int = 4, image_size: int = 224, seed: int = 0):
        rng = np.random.default_rng(seed)
        blank = np.zeros((image_size, image_size, 3), np.float32)
        noisy = rng.standard_normal((image_size, image_size, 3)).astype(np.float32)
        self.images = [blank if i % 2 == 0 else noisy for i in range(n)]
        self.labels = [i % 2 for i in range(n)]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]
