"""``mfu_swinmoe.train``: the model FLOPs of the window's steps
(``flops_swin.train_step_flops`` at each step's batch and text context: each
token through one expert, no padded slot counted) over the window's wall
time, as a share of the card's bf16 peak."""
import flops_swin


def read(run):
    window = run.window
    if not window.get("steps"):
        return None
    batch = run.traffic["batch_size"]
    total = sum(flops_swin.train_step_flops(run.config, batch, ctx) for ctx in window["contexts"])
    return 100.0 * total / window["seconds"] / flops_swin.BF16_FLOPS
