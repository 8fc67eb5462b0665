"""``mfu.train``: the model FLOPs of the window's steps (``flops.train_step_flops``
at each step's batch and text context) over the window's wall time, as a share
of the card's bf16 peak."""
import flops


def read(run):
    window = run.window
    if not window.get("steps"):
        return None
    batch = run.traffic["batch_size"]
    total = sum(flops.train_step_flops(run.config, batch, ctx) for ctx in window["contexts"])
    return 100.0 * total / window["seconds"] / flops.BF16_FLOPS
