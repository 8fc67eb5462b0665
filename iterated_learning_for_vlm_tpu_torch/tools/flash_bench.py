"""Device times of the flash-attention kernels (K3) at the tower shapes.

Run on a machine with a CUDA GPU, from the root of a checkout:

    python -m iterated_learning_for_vlm_tpu_torch.tools.flash_bench [--iters 20]

For each shape (B = 256: vision S=50 H=12, text S=77 and S=32 H=8 with the
causal flag, ViT-B/16 S=197 H=12) it times K3-fwd as training calls it
(with lse), K3-bwd from that lse, and the two together, q/k/v being the
column blocks of one packed [B, S, 3D] tensor as the towers pass them, two
ways over ``--iters`` calls after a warm-up: ``*_ms`` by CUDA events around
the calls (what a caller waits for, host launch gaps included) and
``*_kernel_ms`` as the summed durations of the K3 kernels under
``torch.profiler`` (device time alone; at the small shapes a call's host
work can outlast its kernels). It prints one JSON object with the card's
name and power limit. To compare two versions of the kernels on one card,
run it from both checkouts in turns (a, b, b, a) in one session.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import flash_attention as fl

SHAPES = [("vision S=50 H=12", 50, 12, False), ("text S=77 H=8 causal", 77, 8, True),
          ("text S=32 H=8 causal", 32, 8, True), ("ViT-B/16 S=197 H=12", 197, 12, False)]


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


def kernel_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of the K3 kernels ``fn`` launches,
    from their durations under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "flash_attention" in e.key) / 1e3 / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    rows = {}
    for name, s, h, causal in SHAPES:
        g = torch.Generator(device=dev).manual_seed(s)
        b, d = args.batch, 64 * h
        qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = (t.reshape(b, s, h, 64) for t in qkv.split(d, dim=-1))
        dout = torch.randn(b, s, h, 64, generator=g, device=dev).to(torch.bfloat16)
        _, lse = fl.flash_attention_fwd(q, k, v, None, causal, with_lse=True)

        def pair():
            _, lse_ = fl.flash_attention_fwd(q, k, v, None, causal, with_lse=True)
            return fl.flash_attention_bwd(q, k, v, None, lse_, dout, causal)

        calls = {"fwd": lambda: fl.flash_attention_fwd(q, k, v, None, causal, with_lse=True),
                 "bwd": lambda: fl.flash_attention_bwd(q, k, v, None, lse, dout, causal),
                 "fwd_bwd": pair}
        rows[name] = {f"{what}_ms": device_ms(fn, args.iters) for what, fn in calls.items()}
        rows[name].update({f"{what}_kernel_ms": kernel_ms(fn, args.iters)
                           for what, fn in calls.items()})
    print(json.dumps({"nvidia_smi": smi[0] if smi else None, "batch": args.batch,
                      "times": rows}))


if __name__ == "__main__":
    main()
