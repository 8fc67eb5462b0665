"""The port's spans (``iterated_learning_for_vlm_tpu_torch/utils/profiling.py``).

A span records exactly while a ``torch.profiler`` session runs: with none,
the tiny CLIP-FDT Solver's two steps and a three-class zero-shot through
``TorchEncoder`` leave the record empty; under a CPU profiler the same runs
record the Solver's, the train step's and the encoder's spans with their
parents and counts, on the Chrome trace's clock, and every loss, parameter
and embedding is bit for bit what the run without a profiler gives.
"""
import contextlib
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
from iterated_learning_for_vlm_tpu_torch.eval.zeroshot_classification import (
    build_zeroshot_classifier,
)
from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
from iterated_learning_for_vlm_tpu_torch.utils import config as pconfig
from iterated_learning_for_vlm_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "clip_fdt_tiny_cpu_cluster.yaml"
STEPS = 2
CLASSES = ["cat", "dog", "car"]
TEMPLATES = ["a photo of a {c}.", "a drawing of a {c}.", "a {c}."]
BATCH = 4
IMAGES = 5  # two image batches: 4 rows and 1
# the Chrome trace's user_annotation against the record, per edge (us)
CLOCK_ATOL_US = 50.0


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear()
    yield
    profiling.clear()


def tiny_config():
    cfg = pconfig.load_config(str(CONFIG))
    cfg.lr_scheduler.kwargs["max_iter"] = STEPS
    cfg.data.train["num_batches"] = STEPS
    cfg.reset["enable"] = False
    return cfg


def pil_images():
    rng = np.random.default_rng(0)
    return [Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
            for _ in range(IMAGES)]


def run(out: Path, profiled: bool) -> dict:
    """Two Solver steps, then a zero-shot classifier over ``CLASSES`` and the
    embeddings of ``IMAGES`` PIL images, under a CPU profiler when
    ``profiled``; the record after each part is kept."""
    session = (profile(activities=[ProfilerActivity.CPU]) if profiled
               else contextlib.nullcontext())
    losses = []
    with session as prof:
        solver = Solver(tiny_config(), output_path=str(out), exp_name="run", device="cpu")
        step = solver.train_step

        def recorded(state, batch, temperature):
            metrics = step(state, batch, temperature)
            losses.append(metrics["loss"].clone())
            return metrics

        solver.train_step = recorded
        solver.train()
        after_solver = profiling.spans()
        encoder = TorchEncoder(solver.model, tokenizer=solver.tokenizer, batch_size=BATCH,
                               num_workers=2)
        classifier = build_zeroshot_classifier(encoder, CLASSES, TEMPLATES)
        images = encoder.encode_images(pil_images())
    trace = None
    if profiled:
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return {"losses": torch.stack(losses),
            "params": {n: p.detach().clone() for n, p in solver.model.named_parameters()},
            "classifier": classifier, "images": images, "trace": trace,
            "solver": after_solver, "all": profiling.spans(),
            "meters": sorted(solver.meters)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The run without a profiler, then under one; the record is emptied
    before each."""
    out = {}
    for profiled in (False, True):
        profiling.clear()
        out[profiled] = run(tmp_path_factory.mktemp(f"profiled_{profiled}"), profiled)
    profiling.clear()
    return out


@pytest.mark.parametrize("part", ["solver", "all"])
def test_no_profiler_no_spans(runs, part):
    """Without a profiler neither the Solver nor the encoder records a span."""
    assert runs[False][part] == []


def _by_id(spans):
    return {s["id"]: s for s in spans}


# name: (count, {parent name: count}, attrs of each in order)
EXPECTED = {
    "solver.next_batch": (2, {None: 2}, [{"step": 1}, {"step": 2}]),
    "train.step": (2, {None: 2}, [{"step": 1, "ctx": 16}, {"step": 2, "ctx": 16}]),
    "train.forward": (2, {"train.step": 2}, [{}, {}]),
    "train.backward": (2, {"train.step": 2}, [{}, {}]),
    "train.update": (2, {"train.step": 2}, [{}, {}]),
    "il.on_step": (2, {None: 2}, [{"step": 1}, {"step": 2}]),
    "solver.log": (2, {None: 2}, [{"step": 1}, {"step": 2}]),
    "zeroshot.classifier": (1, {None: 1}, [{"classes": 3}]),
    "encode.tokenize": (3, {"zeroshot.classifier": 3}, [{"rows": 3, "ctx": 16}] * 3),
    "encode.text_batch": (3, {"zeroshot.classifier": 3},
                          [{"rows": 3, "padded": BATCH, "ctx": 16, "graph": "eager"}] * 3),
    "encode.images": (1, {None: 1}, [{"rows": IMAGES}]),
    "encode.preprocess": (1, {"encode.images": 1}, [{"rows": IMAGES}]),
    "encode.image_batch": (2, {"encode.images": 2},
                           [{"rows": 4, "padded": BATCH}, {"rows": 1, "padded": BATCH}]),
    "encode.fetch": (5, {"zeroshot.classifier": 3, "encode.images": 2},
                     [{"rows": 3}] * 3 + [{"rows": 4}, {"rows": 1}]),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_spans_under_a_cpu_profiler(runs, name):
    """Each span of the Solver loop, the step and the encoder, with its
    count, its parents and the counts it was given, in the order opened."""
    count, parents, attrs = EXPECTED[name]
    spans = runs[True]["all"]
    by_id = _by_id(spans)
    got = sorted((s for s in spans if s["name"] == name), key=lambda s: s["start_ns"])
    assert len(got) == count
    seen = {}
    for s in got:
        parent = by_id[s["parent"]]["name"] if s["parent"] is not None else None
        seen[parent] = seen.get(parent, 0) + 1
        assert s["start_ns"] <= s["end_ns"]
        assert s["thread"] == threading.get_native_id()
    assert seen == parents
    assert [s["attrs"] for s in got] == attrs


def test_each_step_has_one_forward_backward_update(runs):
    spans = runs[True]["all"]
    for step in (s for s in spans if s["name"] == "train.step"):
        children = sorted((s for s in spans if s["parent"] == step["id"]),
                          key=lambda s: s["start_ns"])
        assert [c["name"] for c in children] == ["train.forward", "train.backward",
                                                 "train.update"]
        assert all(step["start_ns"] <= c["start_ns"] <= c["end_ns"] <= step["end_ns"]
                   for c in children)


@pytest.mark.parametrize("what", ["losses", "params", "classifier", "images"])
def test_tracing_leaves_numbers_bit_identical(runs, what):
    off, on = runs[False][what], runs[True][what]
    if what == "params":
        assert sorted(off) == sorted(on)
        assert all(torch.equal(off[n], on[n]) for n in off)
    elif isinstance(off, torch.Tensor):
        assert torch.equal(off, on)
    else:
        assert off.dtype == on.dtype and np.array_equal(off, on)


def test_solver_keeps_no_data_time_meter(runs):
    """``solver.next_batch`` is the loop's wait for a batch; ``batch_time``
    stays for the log and the metrics writer."""
    assert runs[False]["meters"] == ["acc1", "acc5", "batch_time", "loss"]


def test_spans_share_the_trace_clock(runs):
    """Every recorded span and its ``user_annotation`` in the exported Chrome
    trace (``ts`` in us from ``baseTimeNanoseconds``) agree within 50 us at
    both ends."""
    trace = runs[True]["trace"]
    base = trace["baseTimeNanoseconds"]
    names = set(EXPECTED)
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation" and e["name"] in names),
                    key=lambda e: e["ts"])
    spans = sorted(runs[True]["all"], key=lambda s: s["start_ns"])
    assert [e["name"] for e in events] == [s["name"] for s in spans]
    for e, s in zip(events, spans):
        start_us = (s["start_ns"] - base) / 1e3
        end_us = (s["end_ns"] - base) / 1e3
        assert abs(e["ts"] - start_us) <= CLOCK_ATOL_US, (s["name"], e["ts"] - start_us)
        assert abs(e["ts"] + e["dur"] - end_us) <= CLOCK_ATOL_US, s["name"]


def test_record_function_entry_points_emit_a_user_annotation(tmp_path):
    """A span enters and exits through ``torch.autograd``'s private
    ``_record_function_with_args_enter`` / ``_exit``; this fails, naming
    them, if a torch upgrade drops them or they stop giving the trace a
    ``user_annotation`` over the stretch they bound."""
    enter = getattr(torch.autograd, "_record_function_with_args_enter", None)
    exit_ = getattr(torch.autograd, "_record_function_with_args_exit", None)
    assert callable(enter) and callable(exit_), "torch.autograd lost the entry points"
    assert (profiling._rf_enter, profiling._rf_exit) == (enter, exit_)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        handle = enter("rf.entry_point")
        torch.ones(4).sum()
        exit_(handle)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    marked = [e for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == "rf.entry_point"]
    assert len(marked) == 1 and marked[0]["dur"] > 0
    inside = [e for e in events if e.get("cat") == "cpu_op" and e.get("name") == "aten::sum"]
    assert inside and all(marked[0]["ts"] <= e["ts"] <= marked[0]["ts"] + marked[0]["dur"]
                          for e in inside)


def test_ring_drops_the_oldest():
    assert profiling.RING == 2 ** 16
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.RING + 3):
            with profiling.span("s", i=i):
                pass
    got = profiling.spans()
    assert len(got) == profiling.RING
    assert [s["attrs"]["i"] for s in (got[0], got[-1])] == [3, profiling.RING + 2]
    profiling.clear()
    assert profiling.spans() == []


def test_span_off_is_a_shared_no_op(monkeypatch):
    """With no profiler a span opens no ``record_function`` and reads no
    clock: each name's one no-op object is returned, whatever the attrs."""
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(profiling, "_rf_enter", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    first = profiling.span("x", step=1)
    assert profiling.span("x", step=2) is first
    with profiling.span("x", step=3) as opened:
        assert opened is first
    assert profiling.spans() == []


@pytest.mark.parametrize("profiled", [False, True])
def test_span_as_a_decorator(profiled):
    @profiling.span("decorated")
    def add(a, b=1):
        return a + b

    session = (profile(activities=[ProfilerActivity.CPU]) if profiled
               else contextlib.nullcontext())
    with session:
        assert add(2, b=3) == 5
    got = profiling.spans()
    assert [(s["name"], s["attrs"]) for s in got] == ([("decorated", {})] if profiled else [])
    assert add.__name__ == "add"


def test_spans_nest_per_thread():
    """A span's parent is the span open around it on its own thread."""
    ready = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span("outer", tag=tag):
            ready.wait()
            with profiling.span("inner", tag=tag):
                ready.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = profiling.spans()
    by_id = _by_id(spans)
    inner = [s for s in spans if s["name"] == "inner"]
    assert len(inner) == 2 and len(spans) == 4
    for s in inner:
        outer = by_id[s["parent"]]
        assert outer["name"] == "outer" and outer["attrs"] == s["attrs"]
        assert outer["thread"] == s["thread"] and outer["parent"] is None
    assert inner[0]["thread"] != inner[1]["thread"]


def test_trace_writes_trace_and_spans(tmp_path):
    """``trace(logdir)`` writes the Chrome trace and the spans begun in it."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("a", rows=2):
            with profiling.span("b"):
                torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert sorted(s["name"] for s in spans) == ["a", "b"]
    a = next(s for s in spans if s["name"] == "a")
    assert a["attrs"] == {"rows": 2}
    assert next(s for s in spans if s["name"] == "b")["parent"] == a["id"]
    names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"a", "b"} <= names
