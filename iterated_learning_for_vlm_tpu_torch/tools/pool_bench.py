"""Device times of the codebook-pooling kernels (K1) at the main-path shapes.

Run on a machine with a CUDA GPU, from the root of a checkout:

    python -m iterated_learning_for_vlm_tpu_torch.tools.pool_bench [--iters 20]

For each shape (B = 256, codebook 4096 x 512, bf16: the CLIP-FDT image tower
T=49, the text tower at T=32 and T=77 with pads, the ViT-B/16 image tower
T=196) it checks, then times, K1-fwd, K1-bwd dq and K1-bwd dsd. The backward
calls take the forward kernel's amax. Each call is checked against its plain
version (``max_abs_err`` beside the tolerance ``chip_smoke.py`` uses) and
timed two ways over ``--iters`` calls after a warm-up: ``*_ms`` by CUDA
events around the calls (host launch gaps included) and ``*_kernel_ms`` as
the summed durations of the codebook kernels under ``torch.profiler``
(device time alone; ``*_kernels`` splits it by kernel name). A shape the
checkout's kernels refuse is reported as an error. It prints one JSON object
with the card's name and power limit. To compare two versions of the kernels
on one card, run it from both checkouts in turns (a, b, b, a) in one call.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch

from ..ops import codebook_attention as cb

SHAPES = [("image T=49", 49, False), ("text T=32 pads", 32, True),
          ("text T=77 pads", 77, True), ("B/16 image T=196", 196, False)]
# chip_smoke.py's tolerances: the forward's fp32 sums of 512 bf16 products in
# another order; the backward's fp32 sums rounded to bf16 (one ulp + noise)
POOL_ATOL, POOL_RTOL = 1e-4, 1e-5
POOL_BWD_ATOL, POOL_BWD_RTOL = 1e-4, 8e-3


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int) -> dict:
    """Mean device milliseconds per call of each codebook kernel ``fn``
    launches (by kernel name), from their durations under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"codebook_pool\w*", e.key).group(0): e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "codebook_pool" in e.key}


def max_err(got, ref, atol, rtol):
    """(max |got - ref|, every element within atol + rtol |ref|)."""
    err = (got.float() - ref.float()).abs()
    return err.max().item(), bool(torch.all(err <= atol + rtol * ref.float().abs()))


def inputs(dev, b, t, with_keep):
    g = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn(b, t, 512, generator=g, device=dev).to(torch.bfloat16)
    sd = torch.randn(4096, 512, generator=g, device=dev).to(torch.bfloat16)
    keep = None
    if with_keep:
        lens = torch.randint(2, t + 1, (b,), generator=g, device=dev)
        keep = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
    gp = torch.randn(b, 4096, generator=g, device=dev)
    return q, sd, keep, gp


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pool_bench: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    rows = {}
    for name, t, with_keep in SHAPES:
        q, sd, keep, gp = inputs(dev, args.batch, t, with_keep)
        temp = 1.0
        try:
            got_p, amax = cb.codebook_pool_fwd(q, sd, keep, temp)
        except ValueError as err:  # an older checkout's kernels may not take this T
            rows[name] = {"error": str(err)}
            continue
        args_b = (q, sd, keep, temp, amax, gp)
        ref_p, _ = cb.codebook_pool_fwd_reference(q, sd, keep, temp)
        checks = {"fwd": max_err(got_p, ref_p, POOL_ATOL, POOL_RTOL)}
        del ref_p, got_p
        ref_dq = cb.codebook_pool_bwd_dq_reference(*args_b)
        checks["dq"] = max_err(cb.codebook_pool_bwd_dq(*args_b), ref_dq, POOL_BWD_ATOL,
                               POOL_BWD_RTOL)
        del ref_dq
        checks["dsd"] = max_err(cb.codebook_pool_bwd_dsd(*args_b),
                                cb.codebook_pool_bwd_dsd_reference(*args_b), POOL_BWD_ATOL,
                                POOL_BWD_RTOL)
        calls = {"fwd": lambda: cb.codebook_pool_fwd(q, sd, keep, temp),
                 "dq": lambda: cb.codebook_pool_bwd_dq(*args_b),
                 "dsd": lambda: cb.codebook_pool_bwd_dsd(*args_b)}
        row = {f"{what}_ms": device_ms(fn, args.iters) for what, fn in calls.items()}
        for what, fn in calls.items():
            row[f"{what}_kernels"] = kernel_ms(fn, args.iters)
            row[f"{what}_kernel_ms"] = sum(row[f"{what}_kernels"].values())
        row.update({f"{what}_max_abs_err": err for what, (err, _) in checks.items()})
        row.update({f"{what}_within_tol": ok for what, (_, ok) in checks.items()})
        rows[name] = row
    print(json.dumps({"nvidia_smi": smi[0] if smi else None, "batch": args.batch,
                      "times": rows}))


if __name__ == "__main__":
    main()
