#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the CLIP-FDT ViT-B/32 serving path on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It drives the port (``iterated_learning_for_vlm_tpu_torch``, no JAX) the way
a serving user would: ``model_entry`` at the serving config (the model
``tools/bench_serve.py`` times: full ViT-B/32 widths and depth, bf16, both
kernels on, random weights from seed 0) and ``TorchEncoder`` at batch 256.
Phases, each reported on its own lines:

1. device: fail without CUDA; print ``nvidia-smi`` name and power limit;
2. build: compile the kernels from ``csrc/`` with nvcc;
3. kernels: each hand-written kernel against its plain PyTorch version at the
   main-path shapes, in bf16, max abs error beside the tolerance, and both
   times (CUDA events);
4. serve: reset the launch counters, encode 256 images and 256 texts at the
   ctx-32 and ctx-77 buckets, read the counters; embeddings must be finite,
   unit-norm, match the plain path within a cosine bound, and every kernel
   must have launched;
5. timing: embeds/s per tower at batch 256, kernel path against plain path,
   and a ``torch.profiler`` table of one kernel-path batch per tower.

Any failure exits non-zero. The line before the last is the kernels JSON,
the last ``{"ok": true, "device": {...}}``. All numbers also go to
``build/chip_smoke.json`` (git-ignored).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 256
SEED = 0
SD_TEMPERATURE = 125.0  # the temperature tools/bench_serve.py serves at
K1_SOURCE = "iterated_learning_for_vlm_tpu_torch/csrc/codebook_pool_fwd.cu"
K2_SOURCE = "iterated_learning_for_vlm_tpu_torch/csrc/tiny_attention_fwd.cu"
K1_REPLACES = "iterated_learning_for_vlm_tpu/ops/codebook_attention.py:35"
K2_REPLACES = "iterated_learning_for_vlm_tpu/ops/fused_attention.py:135"
# K2 output: bf16 rounding of fp32 sums taken in another order (and p rounded
# to bf16 before p @ v on both sides): two bf16 ulps at |out| <= 2, plus 1%.
ATTN_ATOL, ATTN_RTOL = 2e-2, 1e-2
# K1 pooled logits: fp32 sums of the same 512 bf16 products in another order.
POOL_ATOL, POOL_RTOL = 1e-4, 1e-5
# Serving embeddings: bf16 towers with rounding at the same places, in another
# summation order; the plain path also rounds att and the codebook to bf16
# before att @ sd, where the fused path keeps fp32.
EMBED_MIN_COS = 0.999
NORM_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def serving_config(fused: bool) -> dict:
    """``bench.py:model_cfg(fused=True, fused_attn=True)``, the serving model."""
    return {
        "type": "clip_fdt_vitb32",
        "kwargs": {
            "image_encode": {"embed_dim": 512, "fused_attn": fused, "fused_attn_group": 2,
                             "fused_attn_sample_group": 2, "fused_attn_bwd_fuse3": False},
            "text_encode": {"embed_dim": 512, "fused_attn": fused, "fused_attn_group": 2,
                            "fused_attn_sample_group": 2, "fused_attn_bwd_fuse3": False},
            "fdt": {"sd_temperature": 1000, "att_func_type": "sparsemax", "pool_type": "max",
                    "sd_num": 4096, "sd_dim": 512, "raw_img_ft_dim": 768,
                    "raw_txt_ft_dim": 512, "sparsemax_method": "bisect",
                    "use_fused_kernel": fused},
            "dtype": "bfloat16", "remat": False, "use_flash": False, "unroll": True,
        },
    }


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(plain, kernel, iters: int = 10):
    """Times in turns (plain, kernel, kernel, plain) so drift hits both."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# -- phase 3: kernels against their plain versions ---------------------------
def attention_case(dev, name, b, s, h, causal):
    from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(s)
    d = 64 * h
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    mask = fa.causal_bias(s, dev) if causal else None
    got = fa.tiny_attention_fwd(qkv, h, causal=causal, qkv_bias=bias3)
    ref = fa.attention_reference(qkv + bias3, h, mask)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    ok = bool(torch.all(err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()))
    plain_ms, ms = paired_ms(lambda: fa.attention_reference(qkv + bias3, h, mask),
                             lambda: fa.tiny_attention_fwd(qkv, h, causal, bias3))
    row = {"case": name, "max_abs_err": err.max().item(), "atol": ATTN_ATOL,
           "rtol": ATTN_RTOL, "within_tol": ok, "ms": ms, "plain_ms": plain_ms}
    log(f"kernel tiny_attention_fwd {name}: max_abs_err={row['max_abs_err']:.3e} "
        f"(tol {ATTN_ATOL} + {ATTN_RTOL}*|ref|) ok={ok} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    check(ok, f"tiny_attention_fwd {name} disagrees with attention_reference")
    return row


def pool_case(dev, name, b, t, with_keep):
    from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb

    g = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn(b, t, 512, generator=g, device=dev).to(torch.bfloat16)
    sd = torch.randn(4096, 512, generator=g, device=dev).to(torch.bfloat16)
    keep = None
    if with_keep:
        lens = torch.randint(2, t + 1, (b,), generator=g, device=dev)
        keep = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
    temp = 1.0  # keeps the logits O(1), where absolute errors are largest
    got_p, got_a = cb.codebook_pool_fwd(q, sd, keep, temp)
    ref_p, ref_a = cb.codebook_pool_fwd_reference(q, sd, keep, temp)
    torch.cuda.synchronize()
    err = (got_p - ref_p).abs()
    ok = bool(torch.all(err <= POOL_ATOL + POOL_RTOL * ref_p.abs()))
    inner = torch.einsum("btd,nd->btn", q.float(), sd.float()) * 512 ** -0.5
    if keep is not None:
        inner = inner * keep[..., None]
    top2 = inner.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1] > 10 * POOL_ATOL) | (top2[:, 0] == top2[:, 1])
    amax_ok = bool(torch.equal(got_a[decided], ref_a[decided]))
    del inner
    plain_ms, ms = paired_ms(lambda: cb.codebook_pool_fwd_reference(q, sd, keep, temp),
                             lambda: cb.codebook_pool_fwd(q, sd, keep, temp))
    row = {"case": name, "max_abs_err": err.max().item(), "atol": POOL_ATOL,
           "rtol": POOL_RTOL, "within_tol": ok, "amax_equal": amax_ok,
           "amax_compared": decided.float().mean().item(), "ms": ms, "plain_ms": plain_ms}
    log(f"kernel codebook_pool_fwd {name}: max_abs_err={row['max_abs_err']:.3e} "
        f"(tol {POOL_ATOL} + {POOL_RTOL}*|ref|) ok={ok} amax_equal={amax_ok} on "
        f"{row['amax_compared']:.4f} of entries (top-2 gap > {10 * POOL_ATOL}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    check(ok and amax_ok, f"codebook_pool_fwd {name} disagrees with its plain version")
    return row


# -- phase 4: the serving path ----------------------------------------------
def make_texts(rng, n, ctx, max_len):
    """Token rows SOT, random ids, EOT (the highest id), zero pads, with the
    pad mask; the longest row has ``max_len`` tokens, fixing the bucket."""
    lens = rng.integers(3, max_len + 1, n)
    lens[0] = max_len
    tokens = np.zeros((n, ctx), np.int64)
    pad = np.full((n, ctx), -np.inf, np.float32)
    for i, ln in enumerate(lens):
        tokens[i, 0] = 49406
        tokens[i, 1:ln - 1] = rng.integers(1, 49406, ln - 2)
        tokens[i, ln - 1] = 49407
        pad[i, :ln] = 0.0
    return tokens, pad


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def main() -> int:
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke FAILED: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
    from iterated_learning_for_vlm_tpu_torch.models import model_entry
    from iterated_learning_for_vlm_tpu_torch.ops import _build
    from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb
    from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

    check("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} sm_{''.join(map(str, torch.cuda.get_device_capability(0)))} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    report = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__}

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {lib.name} in {report['build_s']:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions, main-path shapes
    k2 = [attention_case(dev, f"vision B={BATCH} S=50 H=12", BATCH, 50, 12, False),
          attention_case(dev, f"text B={BATCH} S=77 H=8 causal", BATCH, 77, 8, True),
          attention_case(dev, f"text B={BATCH} S=32 H=8 causal", BATCH, 32, 8, True)]
    k1 = [pool_case(dev, f"image B={BATCH} T=49", BATCH, 49, False),
          pool_case(dev, f"text B={BATCH} T=32 pads", BATCH, 32, True)]
    report["kernel_checks"] = {"tiny_attention_fwd": k2, "codebook_pool_fwd": k1}

    # 4. the serving path, kernel path and plain path from the same weights
    model = model_entry(serving_config(True), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    plain = model_entry(serving_config(False), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    plain.load_state_dict(model.state_dict())
    enc = TorchEncoder(model, batch_size=BATCH, text_buckets=(16, 32),
                       sd_temperature=SD_TEMPERATURE)
    enc_plain = TorchEncoder(plain, batch_size=BATCH, text_buckets=(16, 32),
                             sd_temperature=SD_TEMPERATURE)
    rng = np.random.default_rng(SEED)
    images = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
    tok32, pad32 = make_texts(rng, BATCH, 77, 32)
    tok77, pad77 = make_texts(rng, BATCH, 77, 77)

    def serve(e):
        return (e.encode_images(images), e.encode_texts_tokens(tok32, pad32),
                e.encode_texts_tokens(tok77, pad77))

    serve(enc)  # first call: cuBLAS/cuDNN set-up, outside the counted run
    torch.cuda.synchronize()
    fa.tiny_attention_fwd.launches = 0
    cb.codebook_pool_fwd.launches = 0
    t0 = time.perf_counter()
    outs = serve(enc)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"tiny_attention_fwd": fa.tiny_attention_fwd.launches,
                "codebook_pool_fwd": cb.codebook_pool_fwd.launches}
    log(f"serve: {BATCH} images + {BATCH} texts @ctx32 + {BATCH} texts @ctx77 in {serve_s:.3f} s "
        f"(host clock, numpy in and out); launches {launches}")
    check(launches["tiny_attention_fwd"] == 3 * 12,
          f"tiny_attention_fwd launched {launches['tiny_attention_fwd']} times, expected 36")
    check(launches["codebook_pool_fwd"] == 3,
          f"codebook_pool_fwd launched {launches['codebook_pool_fwd']} times, expected 3")
    outs_plain = serve(enc_plain)
    serve_rows = {}
    for name, got, ref in zip(("image", "text_ctx32", "text_ctx77"), outs, outs_plain):
        check(got.shape == (BATCH, 512), f"{name} embeddings have shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"{name} embeddings are not finite")
        norm_err = float(np.abs(np.linalg.norm(got, axis=-1) - 1).max())
        cos = float(cosines(got, ref).min())
        serve_rows[name] = {"min_cos_vs_plain": cos, "max_norm_err": norm_err}
        log(f"serve {name}: finite, |norm-1| max {norm_err:.2e} (tol {NORM_ATOL}), "
            f"min cosine vs plain path {cos:.6f} (bound {EMBED_MIN_COS})")
        check(norm_err <= NORM_ATOL, f"{name} embeddings are not unit-norm")
        check(cos >= EMBED_MIN_COS, f"{name} embeddings disagree with the plain path")
    # the towers alone, token by token, kernel path against plain path
    x_img = torch.from_numpy(images).to(dev)
    t32 = torch.from_numpy(tok32[:, :32]).to(dev)
    p32 = torch.from_numpy(pad32[:, :32]).to(dev)
    with torch.inference_mode():
        for name, a, b in (("vision tokens", model.visual.tokens(x_img),
                            plain.visual.tokens(x_img)),
                           ("text words ctx32", model.encode_text.words(t32),
                            plain.encode_text.words(t32))):
            cos = torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1)
            log(f"serve {name}: min cosine vs plain path {cos.min().item():.6f} "
                f"(bound {EMBED_MIN_COS})")
            check(cos.min().item() >= EMBED_MIN_COS, f"{name} disagree with the plain path")
    report["serve"] = {"seconds_host": serve_s, "launches": launches, **serve_rows}

    # 5. embeds/s at batch 256, device time, kernel path vs plain path
    t77 = torch.from_numpy(tok77).to(dev)
    p77 = torch.from_numpy(pad77).to(dev)
    timing = {}
    for name, fast_fn, plain_fn in (
            ("image", lambda: enc.image_batch(x_img), lambda: enc_plain.image_batch(x_img)),
            ("text_ctx32", lambda: enc.text_batch(t32, p32),
             lambda: enc_plain.text_batch(t32, p32)),
            ("text_ctx77", lambda: enc.text_batch(t77, p77),
             lambda: enc_plain.text_batch(t77, p77))):
        plain_ms, ms = paired_ms(plain_fn, fast_fn, iters=10)
        timing[name] = {"ms": ms, "plain_ms": plain_ms, "embeds_per_s": BATCH / ms * 1e3,
                        "plain_embeds_per_s": BATCH / plain_ms * 1e3}
        log(f"timing {name} bs{BATCH}: kernel path {ms:.3f} ms "
            f"({timing[name]['embeds_per_s']:.1f} embeds/s), plain path {plain_ms:.3f} ms "
            f"({timing[name]['plain_embeds_per_s']:.1f} embeds/s)")
    report["timing"] = timing
    torch.cuda.reset_peak_memory_stats()
    enc.text_batch(t77, p77)
    torch.cuda.synchronize()
    report["peak_mem_text_ctx77_bytes"] = torch.cuda.max_memory_allocated()

    from torch.profiler import ProfilerActivity, profile

    for name, fn in (("image", lambda: enc.image_batch(x_img)),
                     ("text_ctx77", lambda: enc.text_batch(t77, p77))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        log(f"profile {name}:\n" + prof.key_averages().table(
            sort_by="cuda_time_total", row_limit=18, max_name_column_width=60))

    report["seconds_total"] = time.perf_counter() - t_start
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernels = [
        {"name": "codebook_pool_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["codebook_pool_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in k1), "ms": k1[0]["ms"],
         "plain_ms": k1[0]["plain_ms"], "shape": k1[0]["case"]},
        {"name": "tiny_attention_fwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["tiny_attention_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in k2), "ms": k2[0]["ms"],
         "plain_ms": k2[0]["plain_ms"], "shape": k2[0]["case"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
