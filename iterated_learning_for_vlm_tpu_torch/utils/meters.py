"""Windowed scalar meters.

A copy of ``iterated_learning_for_vlm_tpu/utils/meters.py`` (reference
``prototype/utils/misc.py:22-56`` ``AverageMeter``): host-side bookkeeping
of host floats; the solver reads device scalars into it at log boundaries.
"""
from __future__ import annotations

from collections import deque


class AverageMeter:
    """Tracks the latest value and a windowed (or running) average."""

    def __init__(self, window: int = 0):
        self.window = window
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self._hist = deque(maxlen=self.window if self.window > 0 else None)

    def update(self, val: float, n: int = 1):
        val = float(val)
        self.val = val
        self._hist.append((val, n))
        if self.window > 0:
            tot = sum(v * k for v, k in self._hist)
            cnt = sum(k for _, k in self._hist)
            self.avg = tot / max(cnt, 1)
        else:
            self.sum += val * n
            self.count += n
            self.avg = self.sum / max(self.count, 1)
