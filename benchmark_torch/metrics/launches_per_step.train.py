"""``launches_per_step.train``: device kernels per step in the profiled steps
(every kernel event of the ``torch.profiler`` trace)."""


def read(run):
    trace = run.trace
    if trace is None or not trace["kernels"]:
        return None
    return len(trace["kernels"]) / trace["steps"]
