"""Read the numbers a cell's correctness limits are set from.

    python3 benchmark_torch/calibrate.py --workload fdt_b32.train.ctx32 \\
        --seeds 11,12,13 --variants program,fp8,half_batch [--seconds 30]

For each seed, the cell's loop (``calibrate``) runs the program as a cell's
run drives it and the float32 reference, and reads the gaps between them
for each variant, one JSON line per seed and variant:

- ``program``: the port (the lower reading of each limit);
- ``fp8``: the control, the reference computed as fp8 GEMMs compute it, in
  the program's place (one precision below the configuration's bfloat16);
- ``half_batch``: a training fault planted in the reference: the loss taken
  over half of the rows.

Training reads need no window; an eval cell runs its window for
``--seconds``, so as many answers are compared as a run compares. The
cell's own runs never run the control or a fault. Needs the card.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program,fp8,half_batch")
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]
    import harness

    cell = harness.resolve(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in cell.loop.calibrate(cell, seed, args.variants.split(","), device,
                                         time.perf_counter(), args.seconds):
            print(json.dumps({"workload": args.workload, "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
