"""``k2_roofline_text.train``: K2's bound over K2's device time in the profiled
steps of a cell whose image tower takes no K2 call (Swin-MoE's windows run on
K4), so that every K2 launch is the text tower's.

The bound of a step is the text tower's layers times the bound of one K2-fwd
and one K2-bwd launch at the step's context, causal (``flops.k2_*_bound_s``);
the steps' bounds are scaled to the launches the wrappers counted
(``.launches``). The time is every ``tiny_attention_{fwd,bwd}`` kernel of the
trace. None without a trace or a K2 launch."""
import flops
import harness


def read(run):
    trace, counted = run.trace, run.counters
    if trace is None:
        return None
    seconds = harness.kernel_seconds(trace, "tiny_attention_fwd_kernel",
                                     "tiny_attention_bwd_kernel")
    launches = counted.get("tiny_attention_fwd", 0) + counted.get("tiny_attention_bwd", 0)
    if seconds <= 0 or not launches:
        return None
    txt = run.config["model"]["kwargs"]["text_encode"]
    b = run.traffic["batch_size"]
    bound, per_steps = 0.0, 0
    for ctx in trace["contexts"]:
        for fn in (flops.k2_fwd_bound_s, flops.k2_bwd_bound_s):
            bound += txt["layers"] * fn(b, ctx, txt["heads"], True)
        per_steps += 2 * txt["layers"]
    return 100.0 * bound * (launches / per_steps) / seconds
