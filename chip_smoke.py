#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: CLIP-FDT ViT-B/32 serving and training on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It drives the port (``iterated_learning_for_vlm_tpu_torch``, no JAX) the way
its users would: ``model_entry`` at the bench config (the model
``tools/bench_serve.py`` serves and ``bench.py`` trains: full ViT-B/32 widths
and depth, bf16, both kernels on, random weights from seed 0),
``TorchEncoder`` at batch 256, and ``make_train_step`` with
``ILController.on_step`` at batch 256. Phases, each reported on its own lines:

1. device: fail without CUDA; print ``nvidia-smi`` name and power limit;
2. build: compile the kernels from ``csrc/`` with nvcc;
3. kernels: each forward kernel against its plain PyTorch version at the
   main-path shapes, in bf16, max abs error beside the tolerance, and both
   times (CUDA events, in turns);
3b. backward kernels: K2-bwd (dqkv and dbias3 through autograd of
   ``fused_tiny_attention``) and K1-bwd dq / dsd (fed the forward kernel's
   amax on both sides) the same way;
4. serve: reset the launch counters, encode 256 images and 256 texts at the
   ctx-32 and ctx-77 buckets, read the counters; embeddings must be finite,
   unit-norm, match the plain path within a cosine bound, and every forward
   kernel must have launched;
5. timing: embeds/s per tower at batch 256, kernel path against plain path,
   and a ``torch.profiler`` table of one kernel-path batch per tower;
6. train: one step at batch 256, ctx 32 on the kernel path (counters reset
   just before, read just after: 24 / 24 / 2 / 2 / 2 launches of K2-fwd,
   K2-bwd, K1-fwd, K1-bwd dq, K1-bwd dsd) and on the plain path from the same
   weights; loss and every parameter's gradient against the plain path;
7. IL: six kernel-path steps under ``ResetConfig(reset_steps=2,
   smooth_steps=1, reset_nums=3)``: the reset after step 4 redraws exactly
   the reference text leaves and zeroes their moments, step 5 leaves the
   codebook at its snapshot and the frozen vision tower unmoved, and after
   step 6 nothing is held or frozen;
8. train timing: pairs/s at batch 256, ctx 32 and ctx 77, kernel path against
   plain path, the peak memory of a step and a ``torch.profiler`` table of
   one kernel-path step.

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
TRAIN_TEMPERATURE = 1000.0  # bench.py's and the CC3M config's starting sd temperature
CSRC = "iterated_learning_for_vlm_tpu_torch/csrc/"
JAX_OPS = "iterated_learning_for_vlm_tpu/ops/"
# name -> (source, the TPU kernel body it replaces)
KERNELS = {
    "codebook_pool_fwd": (CSRC + "codebook_pool_fwd.cu", JAX_OPS + "codebook_attention.py:35"),
    "codebook_pool_bwd_dq": (CSRC + "codebook_pool_bwd.cu", JAX_OPS + "codebook_attention.py:115"),
    "codebook_pool_bwd_dsd": (CSRC + "codebook_pool_bwd.cu",
                              JAX_OPS + "codebook_attention.py:150"),
    "tiny_attention_fwd": (CSRC + "tiny_attention_fwd.cu", JAX_OPS + "fused_attention.py:135"),
    "tiny_attention_bwd": (CSRC + "tiny_attention_bwd.cu", JAX_OPS + "fused_attention.py:173"),
}
# launches of one train step: 12 layers x 2 towers of K2 each way, one K1 per tower
TRAIN_LAUNCHES = {"tiny_attention_fwd": 24, "tiny_attention_bwd": 24, "codebook_pool_fwd": 2,
                  "codebook_pool_bwd_dq": 2, "codebook_pool_bwd_dsd": 2}
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
# K2-bwd dqkv: fp32 sums in another order rounded to bf16, after p and ds were
# rounded to bf16 at the same places on both sides; as K2-fwd.
ATTN_BWD_ATOL, ATTN_BWD_RTOL = 2e-2, 1e-2
# dbias3, taken through autograd of fused_tiny_attention (TinyAttention.backward)
# against the plain dqkv's fp32 sum over (B, S), both cast to the bf16 bias
# dtype: the fp32 sums differ by <= 2e-3 on an H100 (their dqkv differ by one
# bf16 ulp of small values), so the bf16 casts differ by that plus one bf16 ulp.
BIAS_GRAD_ATOL = 4e-3
# K1-bwd dq/dsd: the same routed products summed in fp32 in another order,
# rounded to bf16: one bf16 ulp (<= 2^-7 relative) plus fp32 noise near 0.
POOL_BWD_ATOL, POOL_BWD_RTOL = 1e-4, 8e-3
# Train step, kernel path vs plain path: bf16 towers that round the attention
# and the codebook product at other places; the loss is ~ln(256) = 5.5. On an
# H100 either bf16 path's vision-tower gradients lie at cosine 0.986-0.993
# from an fp32 step's, and the two paths at >= 0.991 from each other.
TRAIN_LOSS_ATOL = 1e-2
GRAD_MIN_COS = 0.98
SCALAR_GRAD_RTOL = 5e-2  # one-element parameters (logit_scale): relative error
PCONFIG = {"ln_w": {"weight_decay": 0}, "ln_b": {"weight_decay": 0},
           "bias": {"weight_decay": 0}, "logit_scale": {"weight_decay": 0}}
# leaves the FDT forward never reads: their gradient is exactly 0 on both paths
UNREAD = ("visual.ln_post.", "visual.proj", "encode_text.text_projection.", "logit_scale_sd")
# what the reference IL reset redraws in the text tower (train/il.py)
TEXT_ROOTS = ("encode_text.", "txt_query_model.")
REDRAWN = (".ln_", "q_map.0.", "q_map.3.", "out_proj.", "c_fc.", "c_proj.", "text_projection.",
           "q_map.1.", "q_map.4.")


def log(msg: str) -> None:
    print(msg, flush=True)


def model_config(fused: bool) -> dict:
    """``bench.py:model_cfg(remat=False, fused=True, flash=False, unroll=True,
    fused_attn=True)``: the model ``tools/bench_serve.py`` serves and
    ``bench.py`` trains; ``fused=False`` is the plain path."""
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


# -- phase 3b: backward kernels against their plain versions -----------------
def attention_bwd_case(dev, name, b, s, h, causal):
    from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(s + 1000)
    d = 64 * h
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    dout = torch.randn(b, s, d, generator=g, device=dev).to(torch.bfloat16)
    qkv_k, bias_k = qkv.clone().requires_grad_(), bias3.clone().requires_grad_()
    fa.fused_tiny_attention(qkv_k, h, qkv_bias=bias_k, causal=causal).backward(dout)
    got, got_b = qkv_k.grad, bias_k.grad.float()
    ref = fa.attention_bwd_reference(qkv, h, causal, bias3, dout)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    ok = bool(torch.all(err <= ATTN_BWD_ATOL + ATTN_BWD_RTOL * ref.float().abs()))
    ref_b = ref.float().sum(dim=(0, 1)).to(bias3.dtype).float()
    bf16_ulp = torch.exp2(torch.floor(torch.log2(ref_b.abs().clamp_min(1e-30))) - 7)
    bias_diff = (got_b - ref_b).abs()
    bias_err = bias_diff.max().item()
    bias_ok = bool(torch.all(bias_diff <= BIAS_GRAD_ATOL + bf16_ulp))
    bias_tol = f"{BIAS_GRAD_ATOL} + 1 bf16 ulp of |ref| (max {bf16_ulp.max().item():.3g})"
    del qkv_k, bias_k, got
    plain_ms, ms = paired_ms(lambda: fa.attention_bwd_reference(qkv, h, causal, bias3, dout),
                             lambda: fa.tiny_attention_bwd(qkv, h, causal, bias3, dout))
    row = {"case": name, "max_abs_err": err.max().item(), "atol": ATTN_BWD_ATOL,
           "rtol": ATTN_BWD_RTOL, "within_tol": ok, "dbias3_max_abs_err": bias_err,
           "dbias3_tol": bias_tol, "dbias3_within_tol": bias_ok, "ms": ms, "plain_ms": plain_ms}
    log(f"kernel tiny_attention_bwd {name} (autograd of fused_tiny_attention): dqkv "
        f"max_abs_err={row['max_abs_err']:.3e} (tol {ATTN_BWD_ATOL} + {ATTN_BWD_RTOL}*|ref|) "
        f"ok={ok}; dbias3 max_abs_err={bias_err:.3e} (tol {bias_tol}) ok={bias_ok} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    check(ok and bias_ok, f"tiny_attention_bwd {name} disagrees with its plain version")
    return row


def pool_bwd_cases(dev, name, b, t, with_keep):
    """K1-bwd dq and dsd against their plain versions, from the same amax
    (the forward kernel's), so only the summation order differs."""
    from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb

    g = torch.Generator(device=dev).manual_seed(t + 100)
    q = torch.randn(b, t, 512, generator=g, device=dev).to(torch.bfloat16)
    sd = torch.randn(4096, 512, generator=g, device=dev).to(torch.bfloat16)
    keep = None
    if with_keep:
        lens = torch.randint(2, t + 1, (b,), generator=g, device=dev)
        keep = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
    gp = torch.randn(b, 4096, generator=g, device=dev)
    temp = 1.0
    _, amax = cb.codebook_pool_fwd(q, sd, keep, temp)
    args = (q, sd, keep, temp, amax, gp)
    rows = []
    for entry, kernel, plain in (
            ("codebook_pool_bwd_dq", cb.codebook_pool_bwd_dq, cb.codebook_pool_bwd_dq_reference),
            ("codebook_pool_bwd_dsd", cb.codebook_pool_bwd_dsd,
             cb.codebook_pool_bwd_dsd_reference)):
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        ok = bool(torch.all(err <= POOL_BWD_ATOL + POOL_BWD_RTOL * ref.float().abs()))
        pads_zero = True
        if keep is not None and entry.endswith("dq"):
            pads_zero = bool(torch.all(got[keep == 0] == 0))
        del got, ref
        plain_ms, ms = paired_ms(lambda: plain(*args), lambda: kernel(*args))
        row = {"case": name, "entry": entry, "max_abs_err": err.max().item(),
               "atol": POOL_BWD_ATOL, "rtol": POOL_BWD_RTOL, "within_tol": ok,
               "pads_zero": pads_zero, "ms": ms, "plain_ms": plain_ms}
        log(f"kernel {entry} {name}: max_abs_err={row['max_abs_err']:.3e} "
            f"(tol {POOL_BWD_ATOL} + {POOL_BWD_RTOL}*|ref|) ok={ok} pads_zero={pads_zero} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
        check(ok and pads_zero, f"{entry} {name} disagrees with its plain version")
        rows.append(row)
    return rows


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


# -- phases 6-8: the training path -------------------------------------------
def reset_counters(*fns) -> None:
    for fn in fns:
        fn.launches = 0


def make_trainer(model):
    """The bench trainer: masked AdamW at the CC3M config's lr schedule, weight
    decay and logit-scale clamp, on a fresh state."""
    from iterated_learning_for_vlm_tpu_torch.train import optim, schedule
    from iterated_learning_for_vlm_tpu_torch.train.step import make_train_step
    from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState

    params = dict(model.named_parameters())
    state = TrainState.create(params, optim.adamw_init(params),
                              optim.trainable_mask_tree(params), params["space_dict"])
    step = make_train_step(model, schedule.cosine(5e-5, 5e-4, 0.0, 500, 80000, reset_steps=6000),
                           optim.build_wd_tree(params, 0.1, PCONFIG), is_fdt=True,
                           grad_clip_type="logit_scale_param_value", grad_clip_value=3.0,
                           grad_clip_max_value=6.0)
    return params, state, step


def train_batch(dev, rng, ctx):
    images = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
    tokens, pad = make_texts(rng, BATCH, ctx, ctx)
    return {"image": torch.from_numpy(images).to(dev), "tokens": torch.from_numpy(tokens).to(dev),
            "pad_mask": torch.from_numpy(pad).to(dev)}


def compare_grads(params_k, params_p):
    """Per-parameter gradient agreement of the two paths: cosine, or the
    relative error of a one-element parameter; exact None on unread leaves."""
    worst, rows = 1.0, {}
    for name, pk in params_k.items():
        gk, gp = pk.grad, params_p[name].grad
        if name.startswith(UNREAD) or not pk.requires_grad:
            check(gk is None and gp is None, f"{name} has a gradient on a path")
            continue
        check(gk is not None and gp is not None, f"{name} has no gradient")
        check(bool(torch.isfinite(gk).all()), f"{name} gradient is not finite")
        if gk.numel() == 1:
            rel = abs(gk.item() - gp.item()) / max(abs(gp.item()), 1e-12)
            rows[name] = {"rel_err": rel}
            check(rel <= SCALAR_GRAD_RTOL, f"{name} gradient differs by {rel:.3e}")
            continue
        cos = torch.nn.functional.cosine_similarity(gk.flatten().float(), gp.flatten().float(),
                                                    dim=0).item()
        rows[name] = {"cos": cos}
        worst = min(worst, cos)
        check(cos >= GRAD_MIN_COS, f"{name} gradient cosine {cos:.5f} < {GRAD_MIN_COS}")
    return worst, rows


def train_phase(model, plain, batch, counted):
    """One train step on each path from the same weights and state; the
    kernel path's launches counted from 0. Returns the launches, the report
    and the plain trainer (state, step) for the timing."""
    params_k, state_k, step_k = make_trainer(model)
    params_p, state_p, step_p = make_trainer(plain)
    sync()
    reset_counters(*counted.values())
    metrics_k = step_k(state_k, batch, TRAIN_TEMPERATURE)
    sync()
    launches = {name: fn.launches for name, fn in counted.items()}
    metrics_p = step_p(state_p, batch, TRAIN_TEMPERATURE)
    loss_k, loss_p = metrics_k["loss"].item(), metrics_p["loss"].item()
    log(f"train step bs{BATCH} ctx32: loss kernel path {loss_k:.6f}, plain path {loss_p:.6f} "
        f"(|diff| bound {TRAIN_LOSS_ATOL}); launches {launches}")
    check(np.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL,
          "train loss disagrees with the plain path")
    check(launches == TRAIN_LAUNCHES, f"train step launches {launches}, expected {TRAIN_LAUNCHES}")
    worst_cos, grad_rows = compare_grads(params_k, params_p)
    log(f"train grads: {len(grad_rows)} parameters compared, min cosine {worst_cos:.6f} "
        f"(bound {GRAD_MIN_COS}); logit_scale rel err "
        f"{grad_rows['logit_scale']['rel_err']:.3e} (bound {SCALAR_GRAD_RTOL}); "
        f"unread leaves exactly zero on both paths")
    report = {"loss": loss_k, "plain_loss": loss_p, "launches": launches,
              "min_grad_cos": worst_cos, "grads": grad_rows}
    return launches, report, (state_p, step_p)


def il_phase(model, batch):
    """Six kernel-path steps under a toy IL schedule; returns the report and
    the trainer (state, step), with nothing held or frozen."""
    from iterated_learning_for_vlm_tpu_torch.train.il import ILController, ResetConfig

    params_k, state_k, step_k = make_trainer(model)
    ctl = ILController(ResetConfig(reset_steps=2, smooth_steps=1, reset_nums=3), seed=SEED,
                       model=model)
    want = {n for n in params_k if n.startswith(TEXT_ROOTS) and any(k in n for k in REDRAWN)}
    losses = []
    for i in range(1, 7):
        if i == 5:
            vision = {n: p.detach().clone() for n, p in params_k.items()
                      if n.startswith(("visual.", "img_query_model."))}
        losses.append(step_k(state_k, batch, TRAIN_TEMPERATURE)["loss"].item())
        check(np.isfinite(losses[-1]), f"IL step {i} loss is not finite")
        before = {n: p.detach().clone() for n, p in params_k.items()} if i == 4 else None
        state_k = ctl.on_step(state_k, i)
        if i == 4:
            changed = {n for n, p in params_k.items() if not torch.equal(p, before[n])}
            check(changed == want, f"IL reset changed {sorted(changed ^ want)} unexpectedly")
            check(all(state_k.opt_state["count"][n] == 0.0
                      and not state_k.opt_state["mu"][n].any()
                      and not state_k.opt_state["nu"][n].any() for n in want),
                  "IL reset left moments on a redrawn leaf")
            check(state_k.hold_codebook and not state_k.trainable["visual.proj"],
                  "IL reset did not hold the codebook and freeze the vision tower")
            del before
        if i == 5:
            check(torch.equal(params_k["space_dict"], state_k.stored_codebook),
                  "the held codebook moved")
            check(all(torch.equal(params_k[n], v) for n, v in vision.items()),
                  "the frozen vision tower moved")
            del vision
    check(not state_k.hold_codebook and all(
        v for n, v in state_k.trainable.items() if n != "visual.conv1.weight"),
        "something is still held or frozen after the IL window")
    log(f"IL: losses {[round(x, 5) for x in losses]}; the reset after step 4 redrew "
        f"{len(want)} text leaves and zeroed their moments; step 5 kept the codebook at its "
        f"snapshot and the vision tower unmoved; after step 6 nothing is held or frozen")
    return {"losses": losses, "redrawn": len(want)}, (state_k, step_k)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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

    # 3b. backward kernels against their plain versions, main-path shapes
    k2b = [attention_bwd_case(dev, f"vision B={BATCH} S=50 H=12", BATCH, 50, 12, False),
           attention_bwd_case(dev, f"text B={BATCH} S=77 H=8 causal", BATCH, 77, 8, True),
           attention_bwd_case(dev, f"text B={BATCH} S=32 H=8 causal", BATCH, 32, 8, True)]
    k1b = (pool_bwd_cases(dev, f"image B={BATCH} T=49", BATCH, 49, False)
           + pool_bwd_cases(dev, f"text B={BATCH} T=32 pads", BATCH, 32, True))
    report["kernel_checks"].update({"tiny_attention_bwd": k2b, "codebook_pool_bwd": k1b})

    # 4. the serving path, kernel path and plain path from the same weights
    model = model_entry(model_config(True), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    plain = model_entry(model_config(False), device=dev,
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

    del enc, enc_plain, x_img
    torch.cuda.empty_cache()

    # 6. one train step, kernel path and plain path from the same weights
    counted = {"tiny_attention_fwd": fa.tiny_attention_fwd,
               "tiny_attention_bwd": fa.tiny_attention_bwd,
               "codebook_pool_fwd": cb.codebook_pool_fwd,
               "codebook_pool_bwd_dq": cb.codebook_pool_bwd_dq,
               "codebook_pool_bwd_dsd": cb.codebook_pool_bwd_dsd}
    batch32 = train_batch(dev, rng, 32)
    batch77 = train_batch(dev, rng, 77)
    train_launches, report["train_step"], (state_p, step_p) = train_phase(
        model, plain, batch32, counted)

    # 7. the IL cycle on the kernel path
    report["il"], (state_k, step_k) = il_phase(model, batch32)

    # 8. train timing, kernel path vs plain path, at ctx 32 and ctx 77
    train_timing = {}
    for ctx, batch in ((32, batch32), (77, batch77)):
        plain_ms, ms = paired_ms(lambda: step_p(state_p, batch, TRAIN_TEMPERATURE),
                                 lambda: step_k(state_k, batch, TRAIN_TEMPERATURE), iters=10)
        torch.cuda.reset_peak_memory_stats()
        step_k(state_k, batch, TRAIN_TEMPERATURE)
        torch.cuda.synchronize()
        train_timing[f"ctx{ctx}"] = {
            "ms": ms, "plain_ms": plain_ms, "pairs_per_s": BATCH / ms * 1e3,
            "plain_pairs_per_s": BATCH / plain_ms * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        row = train_timing[f"ctx{ctx}"]
        log(f"timing train step bs{BATCH} ctx{ctx}: kernel path {ms:.3f} ms "
            f"({row['pairs_per_s']:.1f} pairs/s), plain path {plain_ms:.3f} ms "
            f"({row['plain_pairs_per_s']:.1f} pairs/s); peak memory of a kernel-path step "
            f"{row['peak_mem_bytes'] / 2**30:.2f} GiB (both models and states resident)")
    report["train_timing"] = train_timing
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_k(state_k, batch32, TRAIN_TEMPERATURE)
        torch.cuda.synchronize()
    log("profile train step ctx32:\n" + prof.key_averages().table(
        sort_by="cuda_time_total", row_limit=25, max_name_column_width=60))

    report["seconds_total"] = time.perf_counter() - t_start
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    checks = {"codebook_pool_fwd": k1, "tiny_attention_fwd": k2, "tiny_attention_bwd": k2b,
              "codebook_pool_bwd_dq": [r for r in k1b if r["entry"] == "codebook_pool_bwd_dq"],
              "codebook_pool_bwd_dsd": [r for r in k1b if r["entry"] == "codebook_pool_bwd_dsd"]}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rows = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": train_launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
                        "shape": rows[0]["case"]})
        if name in launches:
            kernels[-1]["launches_serving"] = launches[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
