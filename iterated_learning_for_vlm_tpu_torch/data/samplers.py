"""Index samplers for map-style datasets.

A copy of ``iterated_learning_for_vlm_tpu/data/samplers.py`` (reference
``prototype/data/sampler.py``): ``DistributedSampler`` (an epoch-keyed,
shuffled per-rank split) and ``DistributedGivenIterationSampler`` (an
iteration-budget, resume-aware index stream: the whole schedule's indices are
drawn once and sliced at ``last_iter``), plus :func:`batched`.

They back the dataset-style eval and probing paths; the tar pipeline splits
by shard (``data/shards.py``).
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np


class DistributedSampler:
    """Epoch-shuffled, padded, per-rank strided indices."""

    def __init__(self, dataset_size: int, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 0):
        self.n = dataset_size
        self.rank = rank
        self.world = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-self.n // world_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        total = self.num_samples * self.world
        idx = np.resize(idx, total)  # pad by wrapping
        yield from idx[self.rank::self.world].tolist()

    def __len__(self):
        return self.num_samples


class DistributedGivenIterationSampler:
    """The reference's iteration-budget sampler: generate indices for the
    WHOLE run (total_iter * batch_size per rank), deterministically, and
    resume by slicing at ``last_iter * batch_size``."""

    def __init__(self, dataset_size: int, total_iter: int, batch_size: int,
                 rank: int = 0, world_size: int = 1, last_iter: int = 0,
                 seed: int = 0):
        self.n = dataset_size
        self.total_iter = total_iter
        self.batch_size = batch_size
        self.rank = rank
        self.world = world_size
        self.last_iter = last_iter
        self.seed = seed
        self.total_size = total_iter * batch_size
        self.indices = self._gen()

    def _gen(self) -> np.ndarray:
        need = self.total_size * self.world
        rng = np.random.default_rng(self.seed)
        reps = -(-need // self.n)
        idx = np.concatenate([rng.permutation(self.n) for _ in range(reps)])[:need]
        # per-rank contiguous block (reference semantics)
        beg = self.total_size * self.rank
        return idx[beg : beg + self.total_size]

    def __iter__(self) -> Iterator[int]:
        yield from self.indices[self.last_iter * self.batch_size :].tolist()

    def __len__(self):
        return self.total_size - self.last_iter * self.batch_size


def batched(indices: Iterator[int], batch_size: int, drop_last: bool = True) -> Iterator[List[int]]:
    buf: List[int] = []
    for i in indices:
        buf.append(i)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf and not drop_last:
        yield buf
