"""``k4_roofline.train``: K4's bound over K4's device time in the profiled steps.

The bound of a step is, for every block's window attention, the bound of one
K4-fwd and one K4-bwd launch at that block's shape (``flops_swin.k4_calls``:
windows, N, heads, the shift mask's windows; ``flops_swin.k4_*_bound_s``);
the steps' bounds are scaled to the launches the wrappers counted
(``.launches``). The time is every ``window_attention_{fwd,bwd}`` kernel of
the trace. None for a program without K4."""
import flops_swin
import harness


def read(run):
    trace, counted = run.trace, run.counters
    if trace is None:
        return None
    seconds = harness.kernel_seconds(trace, "window_attention_fwd_kernel",
                                     "window_attention_bwd_kernel")
    launches = counted.get("window_attention_fwd", 0) + counted.get("window_attention_bwd", 0)
    if seconds <= 0 or not launches:
        return None
    calls = flops_swin.k4_calls(run.config, run.traffic["batch_size"])
    per_step = sum(flops_swin.k4_fwd_bound_s(*c) + flops_swin.k4_bwd_bound_s(*c) for c in calls)
    return 100.0 * per_step * (launches / (2 * len(calls))) / seconds
