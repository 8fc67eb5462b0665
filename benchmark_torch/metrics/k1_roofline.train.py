"""``k1_roofline.train``: K1's bound over K1's device time in the profiled steps.

A step runs K1-fwd, dq and dsd once per tower: the image tower over its
grid^2 patch tokens, the text tower over the step's context with its pad
mask (``flops.k1_*_bound_s``); the steps' bounds are scaled to the launches
the wrappers counted (``.launches``). The time is every ``codebook_pool_*``
kernel of the trace (dq and dsd each launch a route and a gather kernel)."""
import flops
import harness
from reference.clip import sizes


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
    img = sizes(run.config)["image"]
    b, n, d = run.traffic["batch_size"], fdt["sd_num"], fdt["sd_dim"]
    grid = (img["resolution"] // img["patch"]) ** 2
    bound, per_steps = 0.0, 0
    for ctx in trace["contexts"]:
        for tokens, masked in ((grid, False), (ctx, True)):
            for fn in (flops.k1_fwd_bound_s, flops.k1_dq_bound_s, flops.k1_dsd_bound_s):
                bound += fn(b, tokens, n, d, masked)
        per_steps += 6
    return 100.0 * bound * (launches / per_steps) / seconds
