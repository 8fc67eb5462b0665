"""The graph cache and the registry of counted kernels (``ops/graphs.py``),
on the CPU, through the stand-in of a graph (``stub_graphs``,
``tests/torch_port_graph_stub.py``): the keys kept, eager calls, and the
counters a replay advances. The card's replays are held against eager calls in ``tests/test_torch_port_gpu.py``.
This file imports no JAX.
"""
import importlib
import pkgutil

import pytest
import torch

import iterated_learning_for_vlm_tpu_torch.models as models_pkg
import iterated_learning_for_vlm_tpu_torch.ops as ops_pkg
from iterated_learning_for_vlm_tpu_torch.models.layers import attention_route
from iterated_learning_for_vlm_tpu_torch.ops import fused_attention, graphs
from torch_port_graph_stub import stub_graphs  # noqa: F401 (fixture)


def double(inputs):
    return {"y": inputs["x"] * 2.0}


def x_of(k):
    return {"x": torch.full((3,), float(k))}


def test_the_ninth_key_evicts_the_least_recently_used(stub_graphs):
    """The cache keeps ``GRAPHS_KEPT`` keys: after keys 0-7, key 0 again
    (captured, now the latest), then key 8, key 1 is gone and runs eagerly,
    while key 0 replays."""
    assert graphs.GRAPHS_KEPT == 8
    cache = graphs.GraphCache()
    for k in range(8):
        cache(double, x_of(k), k)
    cache(double, x_of(0), 0)
    assert cache.mode == "capture"
    cache(double, x_of(8), 8)
    out = cache(double, x_of(1), 1)
    assert cache.mode == "eager" and torch.equal(out["y"], x_of(2)["x"])
    out = cache(double, x_of(5), 0)
    assert cache.mode == "replay" and torch.equal(out["y"], x_of(10)["x"])
    assert (cache.eager, cache.captures, cache.replays) == (10, 1, 1)


def test_a_replay_adds_the_captures_counts_once(stub_graphs):
    """A call that counts two launches and one plain route advances the
    counters by exactly that whether it runs eagerly, captures or replays."""
    def counting(inputs):
        fused_attention.tiny_attention_fwd.launches += 2
        attention_route.plain_routes += 1
        return double(inputs)

    cache = graphs.GraphCache()
    moved = []
    for k in range(5):
        before = (fused_attention.tiny_attention_fwd.launches, attention_route.plain_routes)
        out = cache(counting, x_of(k), "key")
        after = (fused_attention.tiny_attention_fwd.launches, attention_route.plain_routes)
        moved.append((cache.mode, after[0] - before[0], after[1] - before[1]))
        assert torch.equal(out["y"], x_of(2 * k)["x"])
    assert moved == [("eager", 2, 1), ("capture", 2, 1)] + [("replay", 2, 1)] * 3


@pytest.mark.parametrize("how", ["no_key", "cleared"])
def test_eager_without_a_key_or_after_clear(stub_graphs, how):
    """No key runs every call eagerly and keeps nothing; ``clear`` drops the
    graphs, so a captured key's next call runs eagerly again."""
    cache = graphs.GraphCache()
    for k in range(3):
        if how == "cleared" and k == 2:
            cache.clear()
        cache(double, x_of(k), None if how == "no_key" else "key")
    assert (cache.eager, cache.captures, cache.replays) == ((3, 0, 0) if how == "no_key"
                                                            else (2, 1, 0))
    assert cache.mode == "eager" and len(stub_graphs) == (0 if how == "no_key" else 1)


def test_cpu_inputs_run_eagerly_on_the_current_stream():
    """A real graph takes no CPU tensor: every call runs eagerly, no key kept."""
    cache = graphs.GraphCache()
    for k in range(3):
        assert torch.equal(cache(double, x_of(k), "key")["y"], x_of(2 * k)["x"])
    assert (cache.eager, cache.captures, cache.replays) == (3, 0, 0)
    assert not cache.captured("key")


@pytest.mark.parametrize("package,attr", [(ops_pkg, "launches"), (models_pkg, "plain_routes"),
                                          (ops_pkg, "stagings")])
def test_every_counter_is_registered(package, attr):
    """Every function of ``ops/*.py`` with ``.launches`` (or K4's
    ``.stagings``) and every route of ``models/*.py`` with ``.plain_routes``
    is in the registry, so a replay advances it; a counter set by hand would
    misread its kernel's roofline."""
    registered = {(id(obj), a) for obj, a in graphs.COUNTERS}
    found = []
    for info in pkgutil.iter_modules(package.__path__):
        module = importlib.import_module(f"{package.__name__}.{info.name}")
        for name, obj in vars(module).items():
            if callable(obj) and hasattr(obj, attr) and getattr(obj, "__module__", None) == \
                    module.__name__:
                found.append(name)
                assert (id(obj), attr) in registered, f"{module.__name__}.{name}"
    # launches: K1's three, K3's two, K2's two, K4's two and its cosine form's
    # two; stagings: K4's four
    assert len(found) == {"launches": 11, "plain_routes": 2, "stagings": 4}[attr], found
