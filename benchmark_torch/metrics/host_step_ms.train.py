"""``host_step_ms.train``: the mean host time of one ``train.step`` span, the
host's enqueue of one step (forward, backward and update), from the program's
span record (``utils/profiling.py``).

Reads the first profiled slice: the first ``trace_steps`` ``train.step`` spans
of the record, which the loop runs under a profile of the card's activity
alone, so the host keeps its pace. None where the record holds none (a program
without spans)."""
from iterated_learning_for_vlm_tpu_torch.utils import profiling


def read(run):
    record = getattr(profiling, "spans", None)
    steps = sorted((s for s in (record() if record else []) if s["name"] == "train.step"),
                   key=lambda s: s["start_ns"])[:run.traffic["trace_steps"]]
    if not steps:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in steps) / len(steps)
