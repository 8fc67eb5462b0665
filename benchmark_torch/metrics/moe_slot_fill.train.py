"""``moe_slot_fill.train``: tokens the experts kept over the capacity slots
they computed, summed over the MoE layers and every step of the run, from the
layers' device counters (``counters["moe"]``: routed, kept, slots, the largest
expert's load), read once after the run. None for a program without them."""


def read(run):
    moe = (run.counters or {}).get("moe")
    if not moe or not moe[2]:
        return None
    return 100.0 * moe[1] / moe[2]
