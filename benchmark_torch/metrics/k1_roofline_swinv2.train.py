"""``k1_roofline_swinv2.train``: K1's bound over K1's device time in the profiled
steps of a CLIP-FDT with a Swin tower.

As ``k1_roofline.train``, but the image query head reads the Swin tower's
last-stage grid (``flops_swinv2.k1_calls``: 6 x 6 = 36 tokens at 192 px, no
pads) where that reader reckons a ViT's patch grid: a step runs K1-fwd, dq
and dsd once per tower (``flops.k1_*_bound_s``), the text tower's over the
step's context with its pad mask; the steps' bounds are scaled to the
launches the wrappers counted (``.launches``). The time is every
``codebook_pool_*`` kernel of the trace."""
import flops
import flops_swinv2
import harness


def read(run):
    trace, counted = run.trace, run.counters
    fdt = run.config["model"]["kwargs"].get("fdt")
    if trace is None or not fdt:
        return None
    seconds = harness.kernel_seconds(trace, "codebook_pool_")
    launches = sum(counted.get(k, 0) for k in ("codebook_pool_fwd", "codebook_pool_bwd_dq",
                                                "codebook_pool_bwd_dsd"))
    if seconds <= 0 or not launches:
        return None
    b, n = run.traffic["batch_size"], fdt["sd_num"]
    bound, per_steps = 0.0, 0
    for ctx in trace["contexts"]:
        for tokens, depth, masked in flops_swinv2.k1_calls(run.config, ctx):
            for fn in (flops.k1_fwd_bound_s, flops.k1_dq_bound_s, flops.k1_dsd_bound_s):
                bound += fn(b, tokens, n, depth, masked)
        per_steps += 6
    return 100.0 * bound * (launches / per_steps) / seconds
