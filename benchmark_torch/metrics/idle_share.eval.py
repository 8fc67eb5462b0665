"""``idle_share.eval``: the share of a profiled chunk's wall time (125 classes'
prompt batches and one image batch) in which no operation ran on the device."""


def read(run):
    trace = run.trace
    if trace is None or not trace["kernels"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
