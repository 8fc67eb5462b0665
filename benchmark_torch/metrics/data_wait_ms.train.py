"""``data_wait_ms.train``: the mean host time a window step waited in ``next()``
of the Solver's batch source (the harness's clock around each call)."""


def read(run):
    waits = run.window.get("data_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
