"""``tokenize_ms.eval``: the sum over one chunk of the ``encode.tokenize`` spans,
the host's time in the tokenizer, one call per class, from the program's span
record (``utils/profiling.py``).

Reads the first profiled slice, one chunk, which the loop runs under a profile
of the card's activity alone, so the host keeps its pace: the spans inside the
record's first ``zeroshot.classifier`` span and inside the first
``encode.images`` span after it. None where the record holds none (a program
without spans)."""
from iterated_learning_for_vlm_tpu_torch.utils import profiling


def first_chunk(spans):
    spans = sorted(spans, key=lambda s: s["start_ns"])
    classifier = next((s for s in spans if s["name"] == "zeroshot.classifier"), None)
    if classifier is None:
        return []
    roots = [classifier] + [s for s in spans if s["name"] == "encode.images"
                            and s["start_ns"] >= classifier["end_ns"]][:1]
    tree = {s["id"] for s in roots}
    for s in spans:  # a parent starts before its children
        if s["parent"] in tree:
            tree.add(s["id"])
    return [s for s in spans if s["id"] in tree]


def read(run):
    record = getattr(profiling, "spans", None)
    parts = [s for s in first_chunk(record() if record else []) if s["name"] == "encode.tokenize"]
    if not parts:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in parts)
