"""CUDA-graph replay and the registry of counted kernels.

The train step (``train/step.py``) and the eval encoder (``eval/encode.py``)
each replay their device work through a :class:`GraphCache`, by one rule: a
key's first call runs eagerly on the process's side stream and is also the
warm-up; its second is captured on that stream and replayed at once; later
calls copy their inputs into the graph's static buffers, replay it and
return a copy of its output. A cache keeps its :data:`GRAPHS_KEPT` latest
keys.

Every graph of the process shares one side stream per device and, while any
of them lives, one memory pool (:func:`_side`): graphs never run at once.
That is safe under one contract, which every caller keeps: all that a replay
reads before it writes lives outside the pool (parameters, optimizer state,
the static inputs, host-made scalars, what a key's eager call made). What a
replay writes into the pool (its output, a step's ``.grad``) holds only
until another graph of the process replays.

The registry: each kernel wrapper counts its launches in ``fn.launches`` and
each route that refused a kernel in ``route.plain_routes``, registered where
it is defined (:func:`counted`). A replay runs kernels no wrapper sees, so a
cache takes back what a capture counted and adds it again at each replay.
"""
from __future__ import annotations

import collections
import gc
import weakref
from typing import Callable, Dict, Hashable, Optional

import torch

# keys a cache remembers (graphs, and keys seen once), the latest used: a
# step's graph holds a copy of its inputs (154 MB for a bs-256 224-px batch)
GRAPHS_KEPT = 8

COUNTERS: list = []  # (object, attribute) of every registered counter


def counted(attr: str):
    """Decorator: ``fn.<attr> = 0``, a counter that replays advance."""
    def register(fn):
        setattr(fn, attr, 0)
        COUNTERS.append((fn, attr))
        return fn
    return register


def counts() -> list:
    return [getattr(obj, attr) for obj, attr in COUNTERS]


def advance(deltas) -> None:
    for (obj, attr), d in zip(COUNTERS, deltas):
        if d:
            setattr(obj, attr, getattr(obj, attr) + d)


_SIDE: Dict[int, tuple] = {}  # device index -> (side stream, the live graphs)


def _side(device: torch.device) -> tuple:
    """The side stream of every graph on ``device``, and the live graphs,
    whose pool the next capture shares: the caching allocator reuses a
    pool's free blocks only on the stream that allocated them."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SIDE:
        _SIDE[index] = (torch.cuda.Stream(index), weakref.WeakSet())
    return _SIDE[index]


def _live_pool(graphs) -> Optional[tuple]:
    """The memory pool of a live graph in ``graphs``, or None for a new one.
    Once a pool's graphs are all gone the allocator frees it, and a capture
    into it fails; a graph that only a reference cycle holds goes in this
    collection, not in the one ``torch.cuda.graph`` makes on entry."""
    gc.collect()
    for entry in graphs:
        return entry.graph.pool()
    return None


Tensors = Dict[str, torch.Tensor]


class Graph:
    """One call captured as a CUDA graph: static input buffers, the graph,
    its static output, and the objects its key names by identity or address,
    held so that no other object takes their place."""

    @staticmethod
    def takes(inputs: Tensors) -> bool:
        return all(v.is_cuda for v in inputs.values())

    @staticmethod
    def warm(fn: Callable[[Tensors], Tensors], inputs: Tensors) -> Tensors:
        """``fn(inputs)`` eagerly on the side stream, the capture's warm-up."""
        device = next(iter(inputs.values())).device
        current, side = torch.cuda.current_stream(device), _side(device)[0]
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(inputs)
        current.wait_stream(side)
        for v in out.values():
            v.record_stream(current)
        return out

    def __init__(self, inputs: Tensors, held: tuple):
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.held = held

    def capture(self, fn: Callable[[Tensors], Tensors]) -> None:
        """Capture ``fn`` on the side stream into the live graphs' pool
        (``torch.cuda.graph`` first empties the allocator's cache), and join
        them."""
        stream, live = _side(next(iter(self.inputs.values())).device)
        pool = _live_pool(live)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a loader thread's CUDA calls elsewhere do not void it
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn(self.inputs)
        live.add(self)

    def __call__(self, inputs: Tensors) -> Tensors:
        for k, v in self.inputs.items():
            v.copy_(inputs[k])
        self.graph.replay()
        return {k: v.clone() for k, v in self.out.items()}


class GraphCache:
    """A caller's graphs by key. ``eager``, ``captures`` and ``replays``
    count its calls of each kind; ``mode`` names the last one's."""

    def __init__(self):
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self.eager = self.captures = self.replays = 0
        self.mode: Optional[str] = None

    def captured(self, key: Optional[Hashable]) -> bool:
        """Whether a call with ``key`` replays."""
        return self._graphs.get(key) is not None

    def clear(self) -> None:
        self._graphs.clear()

    def __call__(self, fn: Callable[[Tensors], Tensors], inputs: Tensors,
                 key: Optional[Hashable], held: tuple = ()) -> Tensors:
        """``fn(inputs)``: eagerly on the current stream with no ``key`` or
        inputs no graph takes, else by the key's rule, its graph holding
        ``held``."""
        graphs = self._graphs
        graphed = key is not None and Graph.takes(inputs)
        if not graphed or key not in graphs:
            self.eager += 1
            self.mode = "eager"
            if not graphed:
                return fn(inputs)
            graphs[key] = None
            while len(graphs) > GRAPHS_KEPT:
                graphs.popitem(last=False)
            return Graph.warm(fn, inputs)
        graphs.move_to_end(key)
        graph = graphs[key]
        if graph is None:
            graph = Graph(inputs, held)
            before = counts()
            graph.capture(fn)
            graph.deltas = [a - b for a, b in zip(counts(), before)]
            advance([-d for d in graph.deltas])  # a capture launches nothing
            graphs[key] = graph
            self.captures += 1
            self.mode = "capture"
        else:
            self.replays += 1
            self.mode = "replay"
        out = graph(inputs)
        advance(graph.deltas)
        return out
