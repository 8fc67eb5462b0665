"""``idle_share.train``: the share of the profiled steps' wall time in which no
operation ran on the device (1 - the union of the device intervals / the
window)."""


def read(run):
    trace = run.trace
    if trace is None or not trace["kernels"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
