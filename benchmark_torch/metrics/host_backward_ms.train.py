"""``host_backward_ms.train``: the mean host time of one ``train.backward`` span,
the host's enqueue of one step's backward (``loss.backward()``), from the
program's span record (``utils/profiling.py``).

Reads the first profiled slice: the ``train.backward`` spans inside the first
``trace_steps`` ``train.step`` spans of the record, which the loop runs under a
profile of the card's activity alone, so the host keeps its pace. None where
the record holds none (a program without spans)."""
from iterated_learning_for_vlm_tpu_torch.utils import profiling


def read(run):
    record = getattr(profiling, "spans", None)
    spans = record() if record else []
    steps = sorted((s for s in spans if s["name"] == "train.step"),
                   key=lambda s: s["start_ns"])[:run.traffic["trace_steps"]]
    ids = {s["id"] for s in steps}
    parts = [s for s in spans if s["name"] == "train.backward" and s["parent"] in ids]
    if not parts:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in parts) / len(parts)
