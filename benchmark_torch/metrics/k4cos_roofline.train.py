"""``k4cos_roofline.train``: the cosine K4's bound over its device time in the profiled steps.

The bound of a step is, for every block's window attention, the bound of one
K4-cosine-fwd and one K4-cosine-bwd launch at that block's shape
(``flops_swinv2.k4cos_calls``: windows, N, heads, the shift mask's windows;
``flops_swinv2.k4cos_*_bound_s``); the steps' bounds are scaled to the
launches the wrappers counted (``.launches``). The time is every
``window_attention_cos_{fwd,bwd}`` kernel of the trace. None for a program
without the cosine form."""
import flops_swinv2
import harness


def read(run):
    trace, counted = run.trace, run.counters
    if trace is None:
        return None
    seconds = harness.kernel_seconds(trace, "window_attention_cos_fwd_kernel",
                                     "window_attention_cos_bwd_kernel")
    launches = (counted.get("window_attention_cos_fwd", 0)
                + counted.get("window_attention_cos_bwd", 0))
    if seconds <= 0 or not launches:
        return None
    calls = flops_swinv2.k4cos_calls(run.config, run.traffic["batch_size"])
    per_step = sum(flops_swinv2.k4cos_fwd_bound_s(*c) + flops_swinv2.k4cos_bwd_bound_s(*c)
                   for c in calls)
    return 100.0 * per_step * (launches / (2 * len(calls))) / seconds
