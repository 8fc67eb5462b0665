"""Device times and output digests of the window-attention kernels (K4).

Run on a machine with a CUDA GPU, from the root of a checkout:

    python -m iterated_learning_for_vlm_tpu_torch.tools.window_bench [--iters 20]

At each Swin-B stage at 192 px (stage 0: N=144, 4 heads, shifted, 16 masks;
stage 1: N=144, 8 heads, shifted and not; stage 2: N=144, 16 heads; stage 3:
N=36, 32 heads; 256 images), for the dot-product form and the cosine form
(head scales 5 .. 30), it times K4-fwd and K4-bwd as the summed durations of
their kernels under ``torch.profiler`` over ``--iters`` calls, beside each
call's bound (its bytes over 3.35 TB/s), and gives a SHA-256 of each output
(the forward's; dqkv; the bias's and the scale's gradients) and the bias
slices a launch stages (``.stagings``, None where the wrappers lack it). It
prints one JSON object with the card's name and power limit. To compare two
versions of the kernels, run it from both checkouts in turns (a, b, b, a)
on one card: equal digests are equal bits.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import torch

from ..ops import window_attention as wa

HBM_BPS = 3.35e12
# (name, windows an image, ws, heads, shifted)
STAGES = [("stage 0 N=144 H=4 shifted", 16, 12, 4, True),
          ("stage 1 N=144 H=8 shifted", 4, 12, 8, True),
          ("stage 1 N=144 H=8", 4, 12, 8, False),
          ("stage 2 N=144 H=16", 1, 12, 16, False),
          ("stage 3 N=36 H=32", 1, 6, 32, False)]


def kernel_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of the K4 kernels ``fn`` launches,
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
               and "window_attention" in e.key) / 1e3 / iters


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def stage_inputs(dev, batch, nw, ws, heads, shifted):
    """qkv, bias and dout of one stage, as ``chip_smoke.py`` phase 3d makes them."""
    g = torch.Generator(device=dev).manual_seed(ws * 100 + heads)
    n, c, w = ws * ws, 32 * heads, batch * nw
    qkv = torch.randn(w, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, heads, generator=g, device=dev)
    index = torch.from_numpy(wa.relative_position_index(ws)).to(dev)
    rel = wa.RelativePositionBias.apply(table, index, ws)
    hw = ws * round(nw ** 0.5)
    mask = torch.from_numpy(wa.shift_mask(hw, ws, ws // 2)).to(dev) if shifted else None
    dout = torch.randn(w, n, c, generator=g, device=dev).to(torch.bfloat16)
    return qkv, wa.combined_bias(rel, mask), dout


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("window_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    rows = {}
    for name, nw, ws, heads, shifted in STAGES:
        qkv, bias, dout = stage_inputs(dev, args.batch, nw, ws, heads, shifted)
        for form in ("dot", "cos"):
            scale = torch.linspace(5.0, 30.0, heads, device=dev) if form == "cos" else None
            if scale is None:
                fwd, bwd = wa.window_attention_fwd, wa.window_attention_bwd
                calls = {"fwd": lambda: fwd(qkv, bias, heads),
                         "bwd": lambda: bwd(qkv, bias, heads, dout)}
            else:
                fwd, bwd = wa.window_attention_cos_fwd, wa.window_attention_cos_bwd
                calls = {"fwd": lambda: fwd(qkv, bias, scale, heads),
                         "bwd": lambda: bwd(qkv, bias, scale, heads, dout)}
            row = {}
            for what, fn in calls.items():
                wrapper = fwd if what == "fwd" else bwd
                before = getattr(wrapper, "stagings", None)
                got = fn()
                torch.cuda.synchronize()
                outs = got if isinstance(got, tuple) else (got,)
                staged = None if before is None else wrapper.stagings - before
                ms = kernel_ms(fn, args.iters)
                bound = nbytes(qkv, bias, scale, *outs, dout if what == "bwd" else None) \
                    / HBM_BPS * 1e3
                row[what] = {"kernel_ms": ms, "bound_ms": bound, "share": bound / ms,
                             "stagings": staged,
                             "reuse": None if not staged else qkv.shape[0] * heads / staged,
                             "digests": [digest(t) for t in outs]}
                del got, outs
            rows[f"{form} {name}"] = row
        del qkv, bias, dout
        torch.cuda.empty_cache()
    print(json.dumps({"nvidia_smi": smi[0] if smi else None, "batch": args.batch,
                      "times": rows}))


if __name__ == "__main__":
    main()
