"""The ``step_replay_share.train`` reader on hand-built span records, on the CPU:
every step replayed, none, some, and no step at all; only the first profiled
slice counts."""
from types import SimpleNamespace

import pytest

import harness
from iterated_learning_for_vlm_tpu_torch.utils import profiling

RUN = SimpleNamespace(traffic={"trace_steps": 4})
MS = 1_000_000  # ns


def reader():
    return harness.load_module(harness.BENCH_DIR / "metrics" / "step_replay_share.train.py",
                               "bench_metric_step_replay_share")


def record(replayed):
    """One ``train.step`` span per entry, 10 ms apart, with a ``train.replay``
    child where the entry is true and the eager children where it is false;
    then a replayed step past the slice, which must not count."""
    spans = []

    def add(name, at, parent=None):
        spans.append({"name": name, "id": len(spans) + 1, "parent": parent,
                      "start_ns": at * MS, "end_ns": (at + 5) * MS, "thread": 1, "attrs": {}})
        return len(spans)

    for k, replay in enumerate(list(replayed) + [True] * bool(replayed)):
        step = add("train.step", 10 * k)
        children = ["train.replay"] if replay else ["train.forward", "train.backward",
                                                    "train.update"]
        for name in children:
            add(name, 10 * k + 1, step)
    add("train.replay", 1000)  # outside any step
    return spans


@pytest.mark.parametrize("replayed,want", [
    ([True] * 4, 100.0), ([False] * 4, 0.0), ([False, True, True, False], 50.0),
    ([True, False, True, True], 75.0)])
def test_reads_the_replayed_share_of_the_first_slice(replayed, want, monkeypatch):
    spans = record(replayed)
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert reader().read(RUN) == want


def test_reads_none_without_steps(monkeypatch):
    """An empty record, and a program without a span record, read None."""
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader().read(RUN) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader().read(RUN) is None
