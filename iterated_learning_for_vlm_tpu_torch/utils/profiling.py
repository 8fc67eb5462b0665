"""Profiling and step timing.

Counterpart of ``iterated_learning_for_vlm_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` (CPU, and CUDA
  where there is a card) that writes a Chrome trace, ``trace.json``, into
  ``logdir``;
- :class:`StepTimer`: step timing on the host clock, fenced: ``tick(fence)``
  first waits for the fence (a CUDA tensor's stream, a ``torch.cuda.Event``
  or a ``torch.cuda.Stream``), so a step is timed to the end of its device
  work and not to the end of its enqueue; p50 / p90 summaries;
- :func:`device_memory_stats`: each CUDA device's allocator snapshot under
  the JAX package's keys.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace goes to ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def fence(value) -> None:
    """Wait until ``value`` is ready on its device: a CUDA tensor (its
    device's current stream), a ``torch.cuda.Event`` or a ``torch.cuda.Stream``.
    A CPU tensor is ready when it exists."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.current_stream(value.device).synchronize()
    elif isinstance(value, (torch.cuda.Event, torch.cuda.Stream)):
        value.synchronize()
    else:
        raise TypeError(f"cannot fence on {type(value).__name__}: pass a tensor, a "
                        "torch.cuda.Event or a torch.cuda.Stream")


class StepTimer:
    """Fenced wall-clock timer: call ``tick(fence_value)`` once per step."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []
        self._count = 0
        self._last: Optional[float] = None

    def tick(self, fence_value=None):
        if fence_value is not None:
            fence(fence_value)
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device (``"cuda:0"``, ...): the caching allocator's bytes in
    use and their peak, and the device's total memory, in GiB. Empty without
    a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 2 ** 30,
            "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 2 ** 30,
            "bytes_limit_gb": total / 2 ** 30,
        }
    return out
