"""``mfu_fdt_swinv2.train``: the model FLOPs of the window's steps
(``flops_swinv2.train_step_flops`` at each step's batch and text context)
over the window's wall time, as a share of the card's bf16 peak."""
import flops_swinv2


def read(run):
    window = run.window
    if not window.get("steps"):
        return None
    batch = run.traffic["batch_size"]
    total = sum(flops_swinv2.train_step_flops(run.config, batch, ctx)
                for ctx in window["contexts"])
    return 100.0 * total / window["seconds"] / flops_swinv2.BF16_FLOPS
