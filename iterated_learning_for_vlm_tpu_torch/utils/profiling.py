"""Profiling: spans, traces and step timing.

Counterpart of ``iterated_learning_for_vlm_tpu/utils/profiling.py``:

- :func:`span`: a named stretch of the program, as a context manager
  (``with span("train.step", step=3, ctx=32):``) or a decorator
  (``@span("encode.images")``). It records only while a ``torch.profiler``
  session runs in the process (``torch.autograd.profiler._is_profiler_enabled``,
  set at every profiler start whatever its activities). Otherwise it reads
  that flag and returns the name's shared no-op: no ``record_function``, no
  clock read, no allocation. While on, it opens a user-scope record
  function, as ``torch.profiler.record_function(name)`` does but through the
  profiler's own entry (``_rf_enter``), a ``user_annotation`` in the Chrome
  trace of a profile with host activity (with CUDA activity too, also
  a ``gpu_user_annotation`` over its kernels; a CUDA-only trace holds
  neither), and appends one entry to an in-memory ring of the last
  :data:`RING` spans: ``name``, ``id``, ``parent`` (the id of the span open
  around it on the same thread, or None), ``start_ns`` and ``end_ns``
  (``time.time_ns()``: the Chrome trace's ``ts`` in microseconds is
  ``(start_ns - baseTimeNanoseconds) / 1000``, with ``baseTimeNanoseconds``
  from ``trace.json``), ``thread`` (the native thread id, the trace's
  ``tid``) and ``attrs`` (the counts the call site gave, at the start or,
  through the span's ``set(**attrs)``, before its end). :func:`spans`
  returns the record and :func:`clear` empties it. The record is this
  process's: under data parallelism each rank keeps its own;
- :func:`trace`: the operator's entry. Wrap a stretch of a run in
  ``with trace(logdir):`` to profile it (the host, and the card where there is
  one): at the end it writes ``trace.json``, the Chrome trace with the spans
  on the device's timeline, and ``spans.json``, the spans recorded during it;
- :class:`StepTimer`: step timing on the host clock, fenced: ``tick(fence)``
  first waits for the fence (a CUDA tensor's stream, a ``torch.cuda.Event``
  or a ``torch.cuda.Stream``), so a step is timed to the end of its device
  work and not to the end of its enqueue; p50 / p90 summaries;
- :func:`device_memory_stats`: each CUDA device's allocator snapshot under
  the JAX package's keys.

The spans the port opens, by layer (the names are what the benchmark's
readers and ``PERF.md`` use): the Solver loop, ``solver.next_batch``,
``il.on_step`` and ``solver.log``; the train step, ``train.step`` over
``train.forward``, ``train.backward`` and ``train.update``; zero-shot eval,
``zeroshot.classifier``; the eval encoder, ``encode.tokenize``,
``encode.text_batch``, ``encode.images`` over ``encode.preprocess`` and
``encode.image_batch``, and ``encode.fetch`` (a batch's result copied to the
host, where the host waits for the device).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import operator
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import _record_function_with_args_enter as _rf_enter
from torch.autograd import _record_function_with_args_exit as _rf_exit

RING = 1 << 16  # spans kept; the oldest go first
_call = operator.call

_record: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the ids of this thread's open spans


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class _Off:
    """What :func:`span` returns while no profiler runs: one per name, shared,
    so a span off allocates nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def __call__(self, fn):
        return _spanned(self.name, fn)


class _Span:
    """A span opened while a profiler runs."""

    __slots__ = ("name", "attrs", "_rf", "_id", "_parent", "_start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self._parent = stack[-1] if stack else None
        self._id = next(_ids)
        stack.append(self._id)
        # the profiler stamps the annotation's start a few us into _rf_enter,
        # before it builds the handle. The clock is read in the same C-level
        # call sequence (map), so no bytecode runs in between and no other
        # thread can take the GIL there; record_function's op dispatch could
        # spend hundreds of us on either side of its stamp.
        self._start, self._rf = map(_call, (time.time_ns, functools.partial(_rf_enter,
                                                                            self.name)))
        return self

    def __exit__(self, *exc):
        # the exit's stamp is about a us before _rf_exit returns
        _, end = map(_call, (functools.partial(_rf_exit, self._rf), time.time_ns))
        _stack().remove(self._id)
        _record.append((self.name, self._id, self._parent, self._start, end,
                        threading.get_native_id(), self.attrs))
        return False

    def set(self, **attrs):
        """Add counts known only inside the stretch (before it ends)."""
        self.attrs.update(attrs)

    def __call__(self, fn):
        return _spanned(self.name, fn)


_OFF: Dict[str, _Off] = {}

# A process's first record function spends ~0.5 ms binding its handle. Taken
# here, with no profiler running, it records nothing.
if not _autograd_profiler._is_profiler_enabled:
    _rf_exit(_rf_enter("profiling.warm"))


def span(name: str, **attrs):
    """A named stretch of the program with the counts taken at its start
    (``attrs``), as a context manager; spans opened on one thread nest (see
    the module docstring). As a decorator, ``@span(name)``, it spans each call
    under ``name`` alone: a decorator sees no call site's counts."""
    if not _autograd_profiler._is_profiler_enabled:
        off = _OFF.get(name)
        if off is None:
            off = _OFF[name] = _Off(name)
        return off
    return _Span(name, attrs)


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _autograd_profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        with _Span(name, {}):
            return fn(*args, **kwargs)

    return call


_FIELDS = ("name", "id", "parent", "start_ns", "end_ns", "thread", "attrs")


def spans() -> List[dict]:
    """The recorded spans, oldest first by their end, as dicts of
    ``name, id, parent, start_ns, end_ns, thread, attrs``."""
    return [dict(zip(_FIELDS, entry)) for entry in list(_record)]


def clear() -> None:
    """Empty the record."""
    _record.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the Chrome trace goes to ``<logdir>/trace.json`` and
    the spans that began in the block to ``<logdir>/spans.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    start = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump([s for s in spans() if s["start_ns"] >= start], f)


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
