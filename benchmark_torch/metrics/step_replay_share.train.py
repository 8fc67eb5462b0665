"""``step_replay_share.train``: the share of steps that replayed a CUDA graph,
100 x the ``train.step`` spans holding a ``train.replay`` span over all
``train.step`` spans, from the program's span record (``utils/profiling.py``).

Reads the first profiled slice: the first ``trace_steps`` ``train.step``
spans of the record. 0 where the steps ran eagerly (the CPU, DDP, or a
program without graphs); None where the record holds no step (a program
without spans)."""
from iterated_learning_for_vlm_tpu_torch.utils import profiling


def read(run):
    record = getattr(profiling, "spans", None)
    spans = record() if record else []
    steps = sorted((s for s in spans if s["name"] == "train.step"),
                   key=lambda s: s["start_ns"])[:run.traffic["trace_steps"]]
    if not steps:
        return None
    ids = {s["id"] for s in steps}
    replayed = {s["parent"] for s in spans if s["name"] == "train.replay" and s["parent"] in ids}
    return 100.0 * len(replayed) / len(steps)
