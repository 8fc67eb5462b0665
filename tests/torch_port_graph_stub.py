"""A CPU stand-in for the port's CUDA graph (``ops.graphs.Graph``), and the
``stub_graphs`` fixture that puts it in place. A test module that uses the
fixture imports it from here. This module imports no JAX.
"""
import pytest

from iterated_learning_for_vlm_tpu_torch.ops import graphs


class StubGraph:
    """Stands in for ``ops.graphs.Graph`` on the CPU: takes every tensor,
    records the first input's shape at each capture, and runs the call
    eagerly where the card would replay, leaving the counters to the cache
    as a replay does. A capture runs the call once (its counters count) and
    its first replay returns that result, so a call's work is done once."""

    captured: list = []

    @staticmethod
    def takes(inputs):
        return True

    @staticmethod
    def warm(fn, inputs):
        return fn(inputs)

    def __init__(self, inputs, held):
        self.inputs, self.held = inputs, held

    def capture(self, fn):
        self.fn = fn
        StubGraph.captured.append(tuple(next(iter(self.inputs.values())).shape))
        self.pending = fn(self.inputs)

    def __call__(self, inputs):
        out, self.pending = self.pending, None
        if out is None:
            before = graphs.counts()
            out = self.fn(inputs)
            graphs.advance([b - a for a, b in zip(graphs.counts(), before)])
        return out


@pytest.fixture
def stub_graphs(monkeypatch):
    """``ops.graphs.Graph`` replaced by :class:`StubGraph`; the captured shapes."""
    StubGraph.captured = []
    monkeypatch.setattr(graphs, "Graph", StubGraph)
    return StubGraph.captured
