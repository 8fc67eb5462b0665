"""Run one cell of the PyTorch port's benchmark once and print its result line.

    python3 benchmark_torch/run.py --workload fdt_b32.train.ctx32 --seed 7 \\
        --seconds 30 --trace 0

The cell's configuration, traffic mix, loop, limits and per-layer readers
are found by name (``harness.resolve``). The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and the compared numbers
under ``checks``); the compared numbers are also the last lines of standard
error. Without a CUDA card, or with fewer cards than the cell asks for, the
run prints no result and exits with 2.
"""
import time

PROCESS_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every build and kernel cache stays inside the checkout, at fixed paths, so
# only a cell's first run there builds (the port's nvcc library goes to
# build/torch_kernels/ and its native augment to build/torch_native/)
os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH_DIR / ".cache" / "torch_extensions")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("run.py: no CUDA device; the benchmark measures the card and runs nowhere "
              "else", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(BENCH_DIR)]
    import harness

    cell = harness.resolve(args.workload)
    chips = int(cell.entry["chips"])
    if torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    outcome = cell.loop.run(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device=torch.device("cuda", 0),
                            process_start=PROCESS_START)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": outcome["memory_peak_bytes"]}
    harness.emit(cell, outcome, bool(args.trace), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
