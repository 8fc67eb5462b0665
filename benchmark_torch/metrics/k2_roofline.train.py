"""``k2_roofline.train``: K2's bound over K2's device time in the profiled steps.

The bound of a step is each tower's layers times the bound of one K2-fwd and
one K2-bwd launch at that tower's shape (``flops.k2_*_bound_s``: image S =
grid^2 + 1 over its heads, text S = the step's context, causal); the steps'
bounds are scaled to the launches the wrappers counted (``.launches``). The
time is every ``tiny_attention_{fwd,bwd}`` kernel of the trace."""
import flops
import harness
from reference.clip import sizes


def read(run):
    trace, counted = run.trace, run.counters
    if trace is None:
        return None
    seconds = harness.kernel_seconds(trace, "tiny_attention_fwd_kernel",
                                     "tiny_attention_bwd_kernel")
    launches = counted.get("tiny_attention_fwd", 0) + counted.get("tiny_attention_bwd", 0)
    if seconds <= 0 or not launches:
        return None
    img, txt = sizes(run.config)["image"], sizes(run.config)["text"]
    b = run.traffic["batch_size"]
    s_img = (img["resolution"] // img["patch"]) ** 2 + 1
    bound, per_steps = 0.0, 0
    for ctx in trace["contexts"]:
        for fn in (flops.k2_fwd_bound_s, flops.k2_bwd_bound_s):
            bound += img["layers"] * fn(b, s_img, img["heads"], False)
            bound += txt["layers"] * fn(b, ctx, txt["heads"], True)
        per_steps += 2 * (img["layers"] + txt["layers"])
    return 100.0 * bound * (launches / per_steps) / seconds
