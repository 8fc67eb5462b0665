"""The readers of the program's span record (``utils/profiling.py``), on the CPU.

On hand-built records each reader reads its first profiled slice alone and
gives None for a record without its spans and for a program without a
record; a traced tiny run of each cell gives every reader the cell lists a
number.
"""
import time
from types import SimpleNamespace

import pytest

import harness
from conftest import tiny_cell
from iterated_learning_for_vlm_tpu_torch.utils import profiling

BENCHMARK = harness.load_json(harness.ROOT / "BENCHMARK.json")
TRAIN = ["host_step_ms.train", "host_backward_ms.train", "host_update_ms.train"]
EVAL = ["tokenize_ms.eval", "preprocess_ms.eval", "fetch_wait_ms.eval"]
MS = 1_000_000  # ns


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               f"bench_metric_{name}")


class Record:
    """A hand-built span record: ``add`` appends a span of ``ms`` ms starting
    at ``at`` ms and returns its id."""

    def __init__(self):
        self.spans = []

    def add(self, name, at, ms, parent=None):
        ident = len(self.spans) + 1
        self.spans.append({"name": name, "id": ident, "parent": parent,
                           "start_ns": int(at * MS), "end_ns": int((at + ms) * MS),
                           "thread": 1, "attrs": {}})
        return ident


def train_record():
    """Three steps, of which the slice (``trace_steps`` 2) takes the first two;
    the third, and a step's children outside the slice, must not count."""
    r = Record()
    for k, (step_ms, backward_ms, update_ms) in enumerate([(10, 4, 2), (14, 6, 4),
                                                           (100, 90, 9)]):
        at = 200 * k
        r.add("solver.next_batch", at, 1)
        step = r.add("train.step", at + 1, step_ms)
        r.add("train.forward", at + 1, 1, step)
        r.add("train.backward", at + 2, backward_ms, step)
        r.add("train.update", at + 2 + backward_ms, update_ms, step)
    r.add("train.backward", 900, 50)  # outside any step
    return r.spans


def eval_record():
    """One chunk (a classifier over two classes, then the images), an image
    call before it and a second chunk after it, which must not count."""
    r = Record()
    r.add("encode.images", 0, 30)
    for base, scale in ((100, 1), (1000, 10)):
        clf = r.add("zeroshot.classifier", base, 50 * scale)
        for k in range(2):
            at = base + 20 * k * scale
            r.add("encode.tokenize", at, 2 * scale, clf)
            r.add("encode.text_batch", at + 2 * scale, 1 * scale, clf)
            r.add("encode.fetch", at + 3 * scale, 3 * scale, clf)
        images = r.add("encode.images", base + 60 * scale, 40 * scale)
        r.add("encode.preprocess", base + 60 * scale, 25 * scale, images)
        r.add("encode.image_batch", base + 85 * scale, 1 * scale, images)
        r.add("encode.fetch", base + 86 * scale, 5 * scale, images)
    return r.spans


RUN = SimpleNamespace(traffic={"trace_steps": 2})
# the first slice's numbers: means of two steps, sums over one chunk
WANT = {"host_step_ms.train": 12.0, "host_backward_ms.train": 5.0,
        "host_update_ms.train": 3.0, "tokenize_ms.eval": 4.0, "preprocess_ms.eval": 25.0,
        "fetch_wait_ms.eval": 11.0}


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_reader_reads_the_first_slice(name, monkeypatch):
    record = train_record() if name in TRAIN else eval_record()
    monkeypatch.setattr(profiling, "spans", lambda: record)
    assert reader(name).read(RUN) == pytest.approx(WANT[name], abs=1e-9)


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_reader_finds_nothing(name, monkeypatch):
    """The other kind's record, an empty one, and a program without spans
    (the parent of the change that added them) all read None."""
    other = eval_record() if name in TRAIN else train_record()
    for record in (other, []):
        monkeypatch.setattr(profiling, "spans", lambda record=record: record)
        assert reader(name).read(RUN) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(RUN) is None


@pytest.mark.parametrize("cell_name", ["fdt_b32.train.ctx32", "fdt_b32.eval.zeroshot"])
def test_traced_run_reads_every_listed_reader(cell_name, cpu, corpus_dir):
    """A traced tiny run on the CPU: each span reader the cell lists reads a
    positive number, and the eval chunk fetches once a class and once for its
    image batch."""
    cell = tiny_cell(cell_name)
    profiling.clear()
    outcome = cell.loop.run(cell, seed=2 ** 31 + 9, seconds=0.3, trace=True, device=cpu,
                            process_start=time.perf_counter())
    run = SimpleNamespace(cell=cell, **outcome)
    listed = [m["name"] for m in BENCHMARK["per_layer"]
              if m["name"] in TRAIN + EVAL and cell_name in m["workloads"]]
    assert listed == (TRAIN if ".train." in cell_name else EVAL)
    for name in listed:
        value = reader(name).read(run)
        assert value is not None and value > 0, name
    if cell_name.endswith("zeroshot"):
        fetch = reader("fetch_wait_ms.eval")
        chunk = fetch.first_chunk(profiling.spans())
        assert sum(s["name"] == "encode.fetch" for s in chunk) == (
            cell.traffic["chunk_classes"] + 1)
    profiling.clear()
