"""``moe_host_ms.train``: the host time of the ``moe.*`` spans (route,
dispatch, experts, combine: the enqueue of the MoE layers' forward) per step,
from the program's span record (``utils/profiling.py``).

Reads the first profiled slice: the spans below the first ``trace_steps``
``train.step`` spans of the record, which the loop runs under a profile of
the card's activity alone, so the host keeps its pace. None where the record
holds no such span (a program without them)."""
from iterated_learning_for_vlm_tpu_torch.utils import profiling


def read(run):
    record = getattr(profiling, "spans", None)
    spans = record() if record else []
    steps = sorted((s for s in spans if s["name"] == "train.step"),
                   key=lambda s: s["start_ns"])[:run.traffic["trace_steps"]]
    ids = {s["id"] for s in steps}
    parent = {s["id"]: s["parent"] for s in spans}

    def under_step(s):
        p = s["parent"]
        while p is not None and p not in ids:
            p = parent.get(p)
        return p is not None

    parts = [s for s in spans if s["name"].startswith("moe.") and under_step(s)]
    if not steps or not parts:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in parts) / len(steps)
