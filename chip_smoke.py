#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: CLIP-FDT and CLIP serving and training on one GPU.

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
   main-path shapes (K1 also at the text ctx-77 bucket and the ViT-B/16 image
   tower's T=196; K1 and K2 also at the ctx-16 bucket of phase 13's
   prompts), in bf16, max abs error beside the tolerance, and both
   times (CUDA events, in turns), beside the kernel's bound (the larger of
   its bytes over 3.35 TB/s and its bf16 operations over 989 TFLOP/s) and,
   for attention, the time of ``torch.nn.functional.scaled_dot_product_attention``
   on the same inputs (a yardstick only: no module of the port calls it);
   K2 also at S=77 with the causal mask passed as the ``[S, S]`` bias tensor
   (the JAX entry point's form; SDPA then takes it as ``attn_mask``);
3b. backward kernels: K2-bwd (dqkv and dbias3 through autograd of
   ``fused_tiny_attention``, the S=77 bias case too) and K1-bwd dq / dsd
   (fed the forward kernel's amax on both sides) the same way;
3c. flash attention: K3-fwd (with its lse, which the serving call leaves
   out), K3-bwd through autograd of ``flash_attention`` (from the saved lse)
   and the two together (beside SDPA's forward + backward), against their
   plain versions, q/k/v taken as the column blocks of one packed [B, S, 3D]
   tensor, at the vision (S=50), text (S=77 and 32, the causal flag) and
   ViT-B/16 (S=197) shapes, and S=77 with the causal mask as a bias;
3d. window attention: K4-fwd and K4-bwd (dqkv, and the bias's gradient; a
   second call equal bit for bit) against their plain versions at
   Swin-MoE-B's stages at 256 images (stage 0: N=144, 4 heads, shifted,
   with its 16 windows' masks; stage 1: N=144, 8 heads, shifted (4 masks)
   and not; stage 2: N=144, 16 heads; stage 3: N=36, 32 heads), beside SDPA
   with each window's bias as its ``attn_mask``, with each call's bias
   slices staged and the walk's reuse (windows x heads over them); the
   same for the cosine form (Swin V2: the scale's gradient too; SDPA over the
   unit rows); then one train step of CLIP Swin-MoE-B from ``configs/clip_swinmoe_b_cc3m.yaml``'s
   model block at 256 pairs, ctx 32 (K4's counters reset just before, read
   just after: 24 launches each way; the MoE layers' counters), its time
   and peak memory;
4. serve: reset the launch counters, encode 256 images and 256 texts at the
   ctx-32 and ctx-77 buckets, read the counters; embeddings must be finite,
   unit-norm, match the plain path within a cosine bound, and every forward
   kernel must have launched;
4b. captions: ``TorchEncoder.encode_texts`` of real captions through the
   port's own tokenizer (counters reset just before, read just after: 12
   K2-fwd, 1 K1-fwd), held against the plain path, with a known caption's
   token ids;
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

Then the CLIP-FDT models are freed and the baseline CLIP runs
(``configs/clip_cc3m.yaml``'s model block, bf16, seed 0), built three ways
from the same weights: the flash route (``use_flash: true``, kernels K3), the
K2 route (as shipped, ``fused_attn: true``) and the plain route (neither):

9. CLIP ViT-B/32: serve 256 images and 256 texts at ctx 32 and 77 on the
   flash route (36 K3-fwd launches, nothing else), one train step at batch
   256, ctx 32 (24 K3-fwd, 24 K3-bwd, nothing else) against the plain route,
   pairs/s and embeds/s of all three routes, and a profile of a flash step;
10. CLIP ViT-B/16 (S=197, which only K3 takes): one train step on the flash
   route (24 / 24 launches) against the plain route, a profile of one flash
   step (device time, K3's share, top ops) and one paired time.

Then the CLIP models are freed and the port's own training loop runs:

11. the solver: ``train/solver.py:Solver(...).train()`` on the card, in a
   temporary directory, from :func:`solver_config` (the CLIP-FDT model of
   phase 4 with both kernels on; ``configs/clip_fdt_cc3m.yaml``'s
   ``grad_clip`` / ``optimizer`` / ``lr_scheduler`` blocks with ``max_iter``
   12; synthetic data at batch 256 and ctx 77; the temperature halving every
   4 steps; IL reset every 4 steps, smooth 2, 3 resets; a save at 9 and at
   12). Run A trains 12 steps under a device-only ``torch.profiler``
   (counters reset just before ``train()``, read just after: 12 x the train
   step's launches in the wrappers' counters and as kernel records in the
   trace, which a replayed step's counters cannot stand in for; 0 plain
   routes; the step's calls eager, captured and replayed, some replayed);
   the reset after step 8 redraws exactly the reference text leaves, steps
   9-10 keep the codebook at its snapshot and the vision tower unmoved,
   nothing is held or frozen after step 12, and ``metrics.jsonl`` and
   ``log.txt`` carry the records. Run B resumes from ``ckpt_9`` in a fresh Solver and must give
   run A's losses of steps 10-12 and its final parameters bit for bit. It
   prints the per-step host times (not a throughput figure: the synthetic
   images are drawn on the host), the checkpoint's size, its save and
   restore seconds, and whether PyYAML imports here.

Then phase 11's models are freed and the data pipeline runs:

12. the pipeline: :func:`pipeline_config` (phase 11's model, ``grad_clip`` and
   ``optimizer``; the CC3M ``t_decay``, ``lr_scheduler`` with ``max_iter`` 8
   and ``data.train`` block, pointed at 5 shards of 512 224-px JPEGs written
   by the port's ``tools/make_train_shards.py`` into a temporary directory,
   8 of whose captions are long enough for the ctx-77 bucket; MOCOV2_single,
   context buckets [32, 77], the uint8 wire; no IL; saves at 5 and 8). Run A
   trains 8 steps through the native augment and ``prefetch_to_device``
   under a device-only ``torch.profiler`` (counters reset just before
   ``train()``: 8 x the train step's launches, counted and in the trace,
   some steps replayed, 0 plain routes, both contexts taken, no sample on
   the PIL tier, the first batch normalized on the card within 1 fp32 ulp
   of the host float wire);
   ``encode_images`` of 256 PIL images from the shards (ONECROP) with the
   bf16 serving cast must equal the uncast encoder's bit for bit (12 K2-fwd,
   1 K1-fwd); run B resumes from ``ckpt_5`` and must repeat run A's steps 6-8
   and final parameters bit for bit. It prints Pillow's version, the native
   build, per-step data and step host times (fenced on the loss; the host's
   decode sets them, so they are not throughput figures), the device memory
   and the pinned and pageable copy times of one uint8 batch. Without Pillow
   it says so and runs the same checks on synthetic data and uint8 arrays.

Phase 12's checkpoints stay on disk for the eval suite:

13. eval: the port's eval CLI (``eval/cli.py:main``, in-process, on the card)
   over phase 12's ``ckpt_8`` at the temperature its log ends with, with the
   model block written to a YAML file. Its data comes from seeds: the port's
   ``tools/make_eval_set.py`` writes a zero-shot set of 1000 classes x 2
   224-px images and a probe set of 64 classes x 16 train / 4 test images,
   ``tools/make_compositional_data.py`` the SugarCREPE probes (256 items in
   each of its 5 SugarCREPE-named splits); the phase writes a retrieval JSON
   of 1000 images x 5 captions and a CREPE CSV and a COLA JSON over 48
   coloured-shape scenes. Runs: zero-shot with the 80-prompt ensemble
   (1000 x 80 prompts, ImageNet-1k's classifier shape) at batch 256,
   retrieval at recall@1/5/10, the linear probe (``--val_proportion 0.2``,
   ``--feature_root``) and again with ``--skip_load`` (the same metrics, no
   model built), ``sugar_crepe`` at batch 64, ``crepe``, ``cola``, zero-shot
   with the soup ``ckpt_5,ckpt_8``, and ``build`` over the records. Each run
   (counters reset just before, read just after) must launch K2-fwd 12
   times and K1-fwd once per encoder batch, nothing else, take no plain
   route and give finite metrics in range; it prints its seconds, images/s
   and texts/s through the encoder's fenced batch calls and the host share
   (the time outside them). The soup's image embeddings must equal those of
   a model loaded with the mean of the two state dicts, and
   ``Solver.evaluate(8)`` on a Solver restored from ``ckpt_8`` must give the
   CLI's SugarCREPE metrics bit for bit and leave every parameter as it was.

14. the rest of what a researcher does with the checkpoint, over phase 12's
   ``ckpt_8``, shards and phase 13's data: (a) the CLI's
   ``image_caption_selection`` (1000 coloured-shape scenes, each with its
   true caption first and one swapped-attribute negative from
   ``data/compositional.py``) and ``captioning`` (phase 13's retrieval set:
   the best of its 5000 captions for each image, BLEU/ROUGE-L/CIDEr-D), 12
   K2-fwd and 1 K1-fwd per encoder batch; (b) ``clip_fdt_vitb16`` at full
   width (:func:`b16_config`: phase 4's block with ``image_encode: {use_flash:
   true}``, bf16, seed 0) against the plain path from the same weights:
   serving 256 images (S=197, T=196) and texts at ctx 32 and 77 (12 K3-fwd,
   24 K2-fwd, 3 K1-fwd), then 3 train steps at bs 256, ctx 32, the first
   against the plain path's (loss, every gradient at cosine >= 0.98), each
   launching K3 12/12, K2 12/12 and K1 2/2/2, with embeds/s and pairs/s by
   CUDA events and a profile of one more step; (c) ``return_attn`` on a
   ``clip_vitb32_auxilary`` (phase 9's weights, K2 route) and on the B/16
   model: nothing launched, rows summing to 1, the embeddings against the
   kernel routes', ``extract_patch_ft`` / ``extract_word_ft``; (d) the port's
   ``tools/run_codebook_viz.py`` over the checkpoint and shards (8 batches,
   top 8, 32 codes: PNG grids and ``text_codes.json``), the kernel call's
   pooled logits against the plain token maps, and ``tools/inference.py``'s
   ``.npz`` against ``TorchEncoder`` bit for bit; (e) ``--model_type
   ja_clip`` through the CLI on the card over a tiny HF directory built
   offline, when ``transformers`` is installed (else it says so).

15. data parallel, each rank a child process of this script (its
   ``--rank-job`` entry, :func:`rank_job`) launched through ``python -m
   torch.distributed.run``, over phase 12's shards and checkpoints and
   phase 13's eval sets: (a) two ranks share ``cuda:0`` over Gloo (NCCL
   refuses two ranks on one device) and train :func:`ddp_config` through
   ``cli_entry --multihost``: 128 rows a rank (256 in all), synced context
   buckets, the IL reset after step 4, saves at 4 and 6 that rank 0 alone
   writes. Every step of each rank launches the train step's kernels (0 K3,
   0 plain routes) at the bucket of the longer of the ranks' longest
   captions, with the same loss on both; the ranks' parameter digests are
   equal after the reset and at the end; two new ranks resume from
   ``ckpt_4`` and repeat steps 5-6 and the final parameters bit for bit.
   (b) Run A's first step against one process's step on the same 256 rows
   and weights: loss within 2e-3 relative, every gradient at cosine >=
   0.98. (c) A world of one under NCCL (``--nproc_per_node 1``) against the
   Solver with no group, 2 steps at 256: the losses bit for bit, both step
   times. (d) The eval CLI's ``--distributed`` on two ranks over
   ``ckpt_8``, zero-shot (1000 classes x 80 prompts) and retrieval: phase
   13's metrics, 12 K2-fwd and 1 K1-fwd per encoder batch on each rank,
   rank 0 alone printing and writing the record. It prints each rank's
   step times (Gloo stages CUDA collectives through the host: no measure of
   DDP speed), the gradient bytes all-reduced a step and the seconds.

Every driven phase (4, 4b, 6, 7, 9, 10, 11, 12, 13, 14, 15) also resets the plain-route counters
(``attention_route.plain_routes``, ``codebook_route.plain_routes``: a kernel
knob that got the plain path) just before and requires them at 0 just
after, so the main path never slips onto the plain route unseen.

Any failure exits non-zero. The line before the last is the kernels JSON
(each kernel's train-step launches; for K4 the Swin-MoE step's and its
launches in every later phase of this process, which must be none; for the
others their launches in phase 11's and phase 12's runs,
in phase 13's eval runs, in phase 14's runs and on rank 0 in phase 15's run A,
error, times, bound and library time at its first shape),
the last ``{"ok": true, "device": {...}}``. All numbers also go to
``build/chip_smoke.json`` (git-ignored).
"""
from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
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
    "flash_attention_fwd": (CSRC + "flash_attention_fwd.cu", JAX_OPS + "flash_attention.py:29"),
    "flash_attention_bwd": (CSRC + "flash_attention_bwd.cu", JAX_OPS + "flash_attention.py:45"),
    # no TPU kernel stands behind K4: the JAX tower's window attention is two einsums
    "window_attention_fwd": (CSRC + "window_attention_fwd.cu",
                             "iterated_learning_for_vlm_tpu/models/swin.py:91"),
    "window_attention_bwd": (CSRC + "window_attention_bwd.cu",
                             "iterated_learning_for_vlm_tpu/models/swin.py:91"),
}
# launches of one train step: 12 layers x 2 towers of K2 each way, one K1 per tower
TRAIN_LAUNCHES = {"tiny_attention_fwd": 24, "tiny_attention_bwd": 24, "codebook_pool_fwd": 2,
                  "codebook_pool_bwd_dq": 2, "codebook_pool_bwd_dsd": 2,
                  "flash_attention_fwd": 0, "flash_attention_bwd": 0}
# the CLIP flash route: K3 in every layer of both towers, and no other kernel
CLIP_SERVE_LAUNCHES = {name: 0 for name in TRAIN_LAUNCHES} | {"flash_attention_fwd": 36}
CLIP_TRAIN_LAUNCHES = {name: 0 for name in TRAIN_LAUNCHES} | {"flash_attention_fwd": 24,
                                                              "flash_attention_bwd": 24}
# launches of one Swin-MoE-B train step: K4 each way in each of the 24 blocks
SWIN_LAUNCHES = {"window_attention_fwd": 24, "window_attention_bwd": 24}
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
# dbias3, taken through autograd of fused_tiny_attention (TinyAttention.backward),
# is the fp32 sum over (B, S) of the kernel's dqkv cast to bf16: it must equal
# that sum bit for bit. Against the plain dqkv's sum, each of the B*S summed
# elements may differ within the dqkv tolerance, so the fp32 sums may differ by
# the sum of those tolerances, and the bf16 casts by that plus one bf16 ulp.
# (The key block is analytically 0, so both sums there are rounding noise.)
# K1-bwd dq/dsd: the same routed products summed in fp32 in another order,
# rounded to bf16: one bf16 ulp (<= 2^-7 relative) plus fp32 noise near 0.
POOL_BWD_ATOL, POOL_BWD_RTOL = 1e-4, 8e-3
# K3-fwd and K3-bwd: both sides form the same fp32 values (p and ds unrounded)
# in another summation order and round once to bf16: one bf16 ulp of |ref|
# (<= 2^-7 relative), plus 1e-3 for fp32 noise on values near 0.
FLASH_ATOL, FLASH_RTOL = 1e-3, 2.0 ** -7
# K3-fwd's lse: the log-sum-exp of the same fp32 logits (bf16 products summed
# in another order), in base 2 with one log per row: ~1e-6 at |lse| <= 10.
LSE_ATOL = 1e-4
# Train step, kernel path vs plain path: bf16 towers that round the attention
# and the codebook product at other places; the loss is ~ln(256) = 5.5. On an
# H100 either bf16 path's vision-tower gradients lie at cosine 0.986-0.993
# from an fp32 step's, and the two paths at >= 0.991 from each other.
TRAIN_LOSS_ATOL = 1e-2
GRAD_MIN_COS = 0.98
SCALAR_GRAD_RTOL = 5e-2  # one-element parameters (logit_scale): relative error
# K4-fwd and K4-bwd round at the same places as their plain versions (p and ds
# to bf16 before the products, fp32 sums in another order, one rounding of
# each output): as K2's.
WIN_ATOL, WIN_RTOL = 2e-2, 1e-2
# K4-bwd's bias gradient sums W fp32 ds values per entry in another order (the
# blocks' strided window sets, then their partials): relative to its norm,
# fp32 noise that grows as sqrt(W) ulps, well under 1e-4 at W = 4096.
WIN_DBIAS_RTOL = 1e-4
# The cosine form's dq and dk are its products times the head's scale s_h
# and the row's inverse norm, where the dot form's carry 32^-1/2 (about the
# inverse norm of these random rows). Both sides round ds times the inverse
# norms to bf16, so where their fp32 ds differs by an ulp the two roundings
# can part, and that noise grows with s_h (5 .. 30 here): the absolute
# tolerance on dq and dk is WIN_COS_ATOL * s_h (0.125 read at stage 0, 4096
# windows, against 0.02 + 1% of |ref|). The scale's gradient sums, per head,
# W N dot products of a row with that gradient: the same parted roundings
# and fp32 order over ~10^6 terms of both signs, relative to its norm over
# the heads (3.2e-4 read at stage 0).
WIN_COS_ATOL = WIN_ATOL
WIN_DSCALE_RTOL = 1e-3
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): a kernel's
# bound is the larger of its bytes over HBM_BPS and its operations over BF16_FLOPS
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
# captions for phase 4b, and the reference tokenizer's ids of the first
CAPTIONS = ["a photo of a cat", "A dog runs on the beach at sunset.",
            "two people riding bicycles down a busy city street",
            "a bowl of ramen with an egg, green onions and pork",
            "Crème brûlée on a white plate", "an aerial view of a river delta",
            "it's a red double-decker bus in London", "a child's drawing of a house"]
CAT_TOKENS = [49407, 320, 1125, 539, 320, 2368, 49408]
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


def clip_config(route: str, mtype: str = "clip_vitb32") -> dict:
    """``configs/clip_cc3m.yaml``'s model block; ``route`` "k2" is the shipped
    form (``fused_attn: true``), "flash" adds ``use_flash: true`` (which
    turns the fused route off), "plain" has neither."""
    fused = route != "plain"
    kw = {
        "dtype": "bfloat16", "unroll": True,
        "image_encode": {"fused_attn": fused, "embed_dim": 512},
        "text_encode": {"embed_dim": 512, "fused_attn": fused, "fused_attn_group": 2,
                        "fused_attn_sample_group": 4},
        "clip": {"use_allgather": True},
    }
    if route == "flash":
        kw["use_flash"] = True
    return {"type": mtype, "kwargs": kw}


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


def bound_ms(nbytes: float, ops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_ops(b, s, h, causal, products):
    """bf16 operations of ``products`` [S, S] x [S, 64] products over B*H
    heads, counting only the (query, key) pairs the causal mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2.0 * products * b * h * pairs * 64


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sdpa_fwd(q, k, v, causal, mask=None):
    """``scaled_dot_product_attention`` on the [B, H, S, D] views of q, k, v
    ([B, S, H, D]); with ``mask``, an additive ``attn_mask`` ([S, S] or
    [B, H, S, S]) in q's dtype in place of ``is_causal``."""
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    kw = {"is_causal": causal} if mask is None else {"attn_mask": mask.to(q.dtype)}
    return lambda: torch.nn.functional.scaled_dot_product_attention(*heads, **kw)


def sdpa_fwd_bwd(q, k, v, causal, dout, mask=None):
    """The same forward and its backward through autograd, for the output
    gradient ``dout`` ([B, S, H, D])."""
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    grad = dout.transpose(1, 2)
    kw = {"is_causal": causal} if mask is None else {"attn_mask": mask.to(q.dtype)}

    def call():
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, **kw)
        return torch.autograd.grad(out, leaves, grad)

    return call


def timed_row(row, plain, kernel, library=None, iters=10):
    """Times in turns (plain, kernel[, library], ...back) into ``row``."""
    fns = {"plain_ms": plain, "ms": kernel}
    if library is not None:
        fns["library_ms"] = library
    row.update({"library_ms": None} | turns_ms(fns, iters))
    return row


def timing_text(row) -> str:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    return (f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.1%} of it)")


# -- phase 3: kernels against their plain versions ---------------------------
def attention_case(dev, name, b, s, h, causal, route="flag"):
    """K2-fwd against its plain version; a causal case takes the flag
    (``route`` "flag", the towers' route) or the causal mask as the [S, S]
    bias tensor ("bias", the JAX entry point's form)."""
    from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(s)
    d = 64 * h
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    mask = fa.causal_bias(s, dev) if causal else None
    bias = mask if route == "bias" else None
    flag = causal and route == "flag"
    got = fa.tiny_attention_fwd(qkv, h, causal=flag, qkv_bias=bias3, bias=bias)
    ref = fa.attention_reference(qkv + bias3, h, mask)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    ok = bool(torch.all(err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()))
    x = qkv + bias3  # the yardstick gets the bias added beforehand
    lib_fwd = sdpa_fwd(*(t.reshape(b, s, h, 64) for t in x.split(d, dim=-1)), causal, bias)
    row = {"case": name, "route": route, "max_abs_err": err.max().item(), "atol": ATTN_ATOL,
           "rtol": ATTN_RTOL, "within_tol": ok}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes(qkv, bias3, bias, got),
                                                attention_ops(b, s, h, causal, 2))
    del ref, got
    timed_row(row, lambda: fa.attention_reference(qkv + bias3, h, mask),
              lambda: fa.tiny_attention_fwd(qkv, h, flag, bias3, bias), lib_fwd)
    log(f"kernel tiny_attention_fwd {name}: max_abs_err={row['max_abs_err']:.3e} "
        f"(tol {ATTN_ATOL} + {ATTN_RTOL}*|ref|) ok={ok} {timing_text(row)}")
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
    row = {"case": name, "max_abs_err": err.max().item(), "atol": POOL_ATOL,
           "rtol": POOL_RTOL, "within_tol": ok, "amax_equal": amax_ok,
           "amax_compared": decided.float().mean().item()}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes(q, sd, keep, got_p, got_a),
                                                2.0 * b * t * sd.shape[0] * sd.shape[1])
    timed_row(row, lambda: cb.codebook_pool_fwd_reference(q, sd, keep, temp),
              lambda: cb.codebook_pool_fwd(q, sd, keep, temp))
    log(f"kernel codebook_pool_fwd {name}: max_abs_err={row['max_abs_err']:.3e} "
        f"(tol {POOL_ATOL} + {POOL_RTOL}*|ref|) ok={ok} amax_equal={amax_ok} on "
        f"{row['amax_compared']:.4f} of entries (top-2 gap > {10 * POOL_ATOL}) "
        f"{timing_text(row)}")
    check(ok and amax_ok, f"codebook_pool_fwd {name} disagrees with its plain version")
    return row


# -- phase 3b: backward kernels against their plain versions -----------------
def attention_bwd_case(dev, name, b, s, h, causal, route="flag"):
    """K2-bwd through autograd of ``fused_tiny_attention`` against its plain
    version; ``route`` as in :func:`attention_case`."""
    from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(s + 1000)
    d = 64 * h
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    dout = torch.randn(b, s, d, generator=g, device=dev).to(torch.bfloat16)
    bias = fa.causal_bias(s, dev) if causal and route == "bias" else None
    flag = causal and route == "flag"
    qkv_k, bias_k = qkv.clone().requires_grad_(), bias3.clone().requires_grad_()
    fa.fused_tiny_attention(qkv_k, h, bias, qkv_bias=bias_k, causal=flag).backward(dout)
    got, got_b = qkv_k.grad, bias_k.grad.float()
    ref = fa.attention_bwd_reference(qkv, h, flag, bias3, dout, bias)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    tol = ATTN_BWD_ATOL + ATTN_BWD_RTOL * ref.float().abs()
    ok = bool(torch.all(err <= tol))
    # the share of dqkv elements that differ from the plain version, per block
    differ = [(a != r).float().mean().item() for a, r in zip(got.split(d, dim=-1),
                                                              ref.split(d, dim=-1))]
    own_b = got.sum(dim=(0, 1), dtype=torch.float32).to(bias3.dtype).float()
    ref_b = ref.float().sum(dim=(0, 1)).to(bias3.dtype).float()
    bf16_ulp = torch.exp2(torch.floor(torch.log2(ref_b.abs().clamp_min(1e-30))) - 7)
    bias_tol_t = tol.sum(dim=(0, 1)) + bf16_ulp
    bias_diff = (got_b - ref_b).abs()
    bias_err = bias_diff.max().item()
    bias_ok = bool(torch.equal(got_b, own_b)) and bool(torch.all(bias_diff <= bias_tol_t))
    bias_tol = (f"equal to the sum of its own dqkv; vs plain: the summed dqkv tolerance + "
                f"1 bf16 ulp (min {bias_tol_t.min().item():.3g})")
    row = {"case": name, "route": route, "max_abs_err": err.max().item(),
           "atol": ATTN_BWD_ATOL, "rtol": ATTN_BWD_RTOL, "within_tol": ok,
           "share_differing_dq_dk_dv": differ, "dbias3_max_abs_err": bias_err,
           "dbias3_tol": bias_tol, "dbias3_within_tol": bias_ok}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes(qkv, bias3, bias, dout, got),
                                                attention_ops(b, s, h, causal, 5))
    del qkv_k, bias_k, got, ref, err, tol
    x = qkv + bias3
    lib_bwd = sdpa_fwd_bwd(*(t.reshape(b, s, h, 64) for t in x.split(d, dim=-1)), causal,
                           dout.reshape(b, s, h, 64), bias)
    timed_row(row, lambda: fa.attention_bwd_reference(qkv, h, flag, bias3, dout, bias),
              lambda: fa.tiny_attention_bwd(qkv, h, flag, bias3, dout, bias), lib_bwd)
    log(f"kernel tiny_attention_bwd {name} (autograd of fused_tiny_attention): dqkv "
        f"max_abs_err={row['max_abs_err']:.3e} (tol {ATTN_BWD_ATOL} + {ATTN_BWD_RTOL}*|ref|) "
        f"ok={ok}, share of elements differing dq/dk/dv "
        f"{differ[0]:.2e}/{differ[1]:.2e}/{differ[2]:.2e}; dbias3 max_abs_err={bias_err:.3e} "
        f"({bias_tol}) ok={bias_ok} {timing_text(row)} (library: forward + backward)")
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
        # bytes the function needs: dq reads the codebook, dsd the tokens;
        # both read the routing (amax, g, keep) and write their gradient
        row = {"case": name, "entry": entry, "max_abs_err": err.max().item(),
               "atol": POOL_BWD_ATOL, "rtol": POOL_BWD_RTOL, "within_tol": ok,
               "pads_zero": pads_zero}
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes(sd if entry.endswith("dq") else q, keep, amax, gp, got),
            2.0 * b * sd.shape[0] * sd.shape[1])
        del got, ref
        timed_row(row, lambda: plain(*args), lambda: kernel(*args))
        log(f"kernel {entry} {name}: max_abs_err={row['max_abs_err']:.3e} "
            f"(tol {POOL_BWD_ATOL} + {POOL_BWD_RTOL}*|ref|) ok={ok} pads_zero={pads_zero} "
            f"{timing_text(row)}")
        check(ok and pads_zero, f"{entry} {name} disagrees with its plain version")
        rows.append(row)
    return rows


# -- phase 3c: flash attention against its plain versions --------------------
def flash_case(dev, name, b, s, h, causal, route="flag"):
    """K3-fwd (with lse, as the train step calls it), K3-bwd through autograd
    of ``flash_attention`` (from the forward's saved lse), and the two
    together, against their plain versions; q, k, v are the column blocks of
    one packed [B, S, 3D] tensor, as the towers pass them. A causal case
    takes the flag (``route`` "flag", the towers' route) or the causal bias
    ("bias"). Returns the forward, backward and forward + backward rows."""
    from iterated_learning_for_vlm_tpu_torch.ops import flash_attention as fl
    from iterated_learning_for_vlm_tpu_torch.ops.fused_attention import causal_bias

    g = torch.Generator(device=dev).manual_seed(s + 2000)
    d = 64 * h
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(b, s, h, 64, generator=g, device=dev).to(torch.bfloat16)
    bias = causal_bias(s, dev) if causal and route == "bias" else None
    flag = causal and route == "flag"

    def heads(t):
        return [x.reshape(b, s, h, 64) for x in t.split(d, dim=-1)]

    def within(got, ref):
        return bool(torch.all((got.float() - ref.float()).abs()
                              <= FLASH_ATOL + FLASH_RTOL * ref.float().abs()))

    q, k, v = heads(qkv)
    rows = []
    got, lse = fl.flash_attention_fwd(q, k, v, bias, flag, with_lse=True)
    ref, ref_lse = fl.flash_attention_lse_reference(q, k, v, bias, flag)
    serve_equal = torch.equal(got, fl.flash_attention_fwd(q, k, v, bias, flag))
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = within(got, ref) and lse_err <= LSE_ATOL and serve_equal
    lib_fwd, lib_bwd = sdpa_fwd(q, k, v, causal), sdpa_fwd_bwd(q, k, v, causal, dout)
    rows.append({"case": name, "route": route, "max_abs_err": (got.float() - ref.float()).abs()
                 .max().item(), "lse_max_abs_err": lse_err, "serving_output_equal": serve_equal,
                 "atol": FLASH_ATOL, "rtol": FLASH_RTOL, "within_tol": ok})
    rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound_ms(
        nbytes(q, k, v, bias, got, lse), attention_ops(b, s, h, causal, 2))
    del got, ref
    timed_row(rows[-1], lambda: fl.flash_attention_lse_reference(q, k, v, bias, flag),
              lambda: fl.flash_attention_fwd(q, k, v, bias, flag, with_lse=True), lib_fwd)
    log(f"kernel flash_attention_fwd {name}: max_abs_err={rows[-1]['max_abs_err']:.3e} "
        f"(tol {FLASH_ATOL} + 2^-7*|ref|), lse max_abs_err={lse_err:.3e} (tol {LSE_ATOL}), "
        f"serving call (no lse) equal: {serve_equal}; ok={ok} {timing_text(rows[-1])}")
    check(ok, f"flash_attention_fwd {name} disagrees with flash_attention_lse_reference")

    qkv_k = qkv.clone().requires_grad_()
    fl.flash_attention(*heads(qkv_k), bias, causal=flag).backward(dout)
    refs = fl.flash_attention_bwd_reference(q, k, v, bias, ref_lse, dout, flag)
    torch.cuda.synchronize()
    grads = [got.reshape(ref.shape) for got, ref in zip(heads(qkv_k.grad), refs)]
    errs = [(got.float() - ref.float()).abs().max().item() for got, ref in zip(grads, refs)]
    ok = all(within(got, ref) for got, ref in zip(grads, refs))
    rows.append({"case": name, "route": route, "max_abs_err": max(errs),
                 "max_abs_err_dq_dk_dv": errs, "atol": FLASH_ATOL, "rtol": FLASH_RTOL,
                 "within_tol": ok})
    rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound_ms(
        nbytes(q, k, v, bias, lse, dout, qkv_k.grad), attention_ops(b, s, h, causal, 5))
    del qkv_k, refs, grads
    timed_row(rows[-1], lambda: fl.flash_attention_bwd_reference(q, k, v, bias, lse, dout, flag),
              lambda: fl.flash_attention_bwd(q, k, v, bias, lse, dout, flag), lib_bwd)
    log(f"kernel flash_attention_bwd {name} (autograd of flash_attention, from the saved lse): "
        f"max_abs_err dq/dk/dv={errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {FLASH_ATOL} + "
        f"2^-7*|ref|) ok={ok} {timing_text(rows[-1])} (library: forward + backward)")
    check(ok, f"flash_attention_bwd {name} disagrees with flash_attention_bwd_reference")

    def kernel_pair():
        out, lse_ = fl.flash_attention_fwd(q, k, v, bias, flag, with_lse=True)
        return out, fl.flash_attention_bwd(q, k, v, bias, lse_, dout, flag)

    def plain_pair():
        out, lse_ = fl.flash_attention_lse_reference(q, k, v, bias, flag)
        return out, fl.flash_attention_bwd_reference(q, k, v, bias, lse_, dout, flag)

    rows.append({"case": name, "route": route})
    rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound_ms(
        nbytes(q, k, v, bias, dout) + 4 * nbytes(q), attention_ops(b, s, h, causal, 7))
    timed_row(rows[-1], plain_pair, kernel_pair, lib_bwd)
    log(f"kernel flash_attention_fwd+bwd {name} (the two as a train step runs them, beside "
        f"the library's forward + backward): {timing_text(rows[-1])}")
    return rows


# -- phase 3d: K4, Swin's window attention, against its plain versions -------
# Swin-B's stages at 192 px: (name, (windows an image, ws, heads, shifted))
K4_STAGES = [(f"stage 0 B={BATCH} N=144 H=4 shifted", (16, 12, 4, True)),
             (f"stage 1 B={BATCH} N=144 H=8 shifted", (4, 12, 8, True)),
             (f"stage 1 B={BATCH} N=144 H=8", (4, 12, 8, False)),
             (f"stage 2 B={BATCH} N=144 H=16", (1, 12, 16, False)),
             (f"stage 3 B={BATCH} N=36 H=32", (1, 6, 32, False))]


def window_case(dev, name, nw, ws, heads, shifted, cosine=False):
    """K4-fwd and K4-bwd (dqkv and the bias's gradient) against their plain
    versions at one stage of Swin-B at ``BATCH`` images: ``nw`` windows of
    ws x ws tokens an image, head width 32, the bias of a random
    relative-position table plus, when ``shifted``, the shift mask. With
    ``cosine``, the cosine form (Swin V2) at head scales 5 .. 30, and the
    scale's gradient too. Each row also gives the bias slices a call staged
    (``.stagings``) and the walk's reuse, windows x heads over them. Returns
    the forward and the backward rows."""
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device=dev).manual_seed(ws * 100 + heads)
    n, c, w = ws * ws, 32 * heads, BATCH * nw
    qkv = torch.randn(w, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, heads, generator=g, device=dev)
    index = torch.from_numpy(wa.relative_position_index(ws)).to(dev)
    rel = wa.RelativePositionBias.apply(table, index, ws)
    hw = ws * round(nw ** 0.5)
    mask = torch.from_numpy(wa.shift_mask(hw, ws, ws // 2)).to(dev) if shifted else None
    bias = wa.combined_bias(rel, mask)
    dout = torch.randn(w, n, c, generator=g, device=dev).to(torch.bfloat16)
    scale = torch.linspace(5.0, 30.0, heads, device=dev) if cosine else None
    # the yardstick: SDPA over [W, H, N, 32] with the bias per window as its
    # attn_mask (the cosine form: over the unit rows, q's times the head's
    # scale and sqrt(32), which SDPA's own 32^-1/2 takes back)
    q, k, v = (t.reshape(w, n, heads, 32) for t in qkv.split(c, dim=-1))
    if cosine:
        unit = [t.float() / (t.float().norm(dim=-1, keepdim=True) + 1e-12) for t in (q, k)]
        q = (unit[0] * scale[:, None] * 32 ** 0.5).to(torch.bfloat16)
        k = unit[1].to(torch.bfloat16)
        del unit
    per_window = bias.repeat(w // bias.shape[0], 1, 1, 1)
    lib_fwd = sdpa_fwd(q, k, v, False, per_window)
    lib_bwd = sdpa_fwd_bwd(q, k, v, False, dout.reshape(w, n, heads, 32), per_window)
    del per_window
    if cosine:
        label = "window_attention_cos"
        counted = wa.window_attention_cos_fwd, wa.window_attention_cos_bwd

        def kernel_fwd():
            return wa.window_attention_cos_fwd(qkv, bias, scale, heads)

        def kernel_bwd():
            return wa.window_attention_cos_bwd(qkv, bias, scale, heads, dout)
    else:
        label = "window_attention"
        counted = wa.window_attention_fwd, wa.window_attention_bwd

        def kernel_fwd():
            return wa.window_attention_fwd(qkv, bias, heads)

        def kernel_bwd():
            return wa.window_attention_bwd(qkv, bias, heads, dout)

    def plain_fwd():
        return wa.window_attention_reference(qkv, bias, heads, scale)

    def plain_bwd():
        return wa.window_attention_bwd_reference(qkv, bias, heads, dout, scale)

    staged = counted[0].stagings
    got = kernel_fwd()
    staged = counted[0].stagings - staged
    ref = plain_fwd()
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    ok = bool(torch.all(err <= WIN_ATOL + WIN_RTOL * ref.float().abs()))
    fwd = {"case": name, "max_abs_err": err.max().item(), "atol": WIN_ATOL, "rtol": WIN_RTOL,
           "within_tol": ok, "stagings": staged, "reuse": w * heads / staged}
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(nbytes(qkv, bias, scale, got),
                                                2.0 * 2 * w * heads * n * n * 32)
    del got, ref, err
    timed_row(fwd, plain_fwd, kernel_fwd, lib_fwd)
    log(f"kernel {label}_fwd {name}: max_abs_err={fwd['max_abs_err']:.3e} "
        f"(tol {WIN_ATOL} + {WIN_RTOL}*|ref|) ok={ok} {timing_text(fwd)} "
        f"reuse={fwd['reuse']:.2f} ({staged} stagings)")
    check(ok, f"{label}_fwd {name} disagrees with window_attention_reference")

    staged = counted[1].stagings
    got, want, again = kernel_bwd(), plain_bwd(), kernel_bwd()
    staged = (counted[1].stagings - staged) // 2
    torch.cuda.synchronize()
    err = (got[0].float() - want[0].float()).abs()
    atol = torch.full((3 * c,), WIN_ATOL, device=dev)
    if cosine:  # dq and dk carry each head's scale
        atol[:2 * c] = WIN_COS_ATOL * scale.clamp_min(1.0).repeat_interleave(32).repeat(2)
    ok = bool(torch.all(err <= atol + WIN_RTOL * want[0].float().abs()))
    gaps = [((a - b).norm() / b.norm()).item() for a, b in zip(got[1:], want[1:])]
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    bwd = {"case": name, "max_abs_err": err.max().item(), "atol": WIN_ATOL, "rtol": WIN_RTOL,
           "within_tol": ok, "dbias_rel_err": gaps[0], "dbias_rtol": WIN_DBIAS_RTOL,
           "repeats_bit_for_bit": repeat, "stagings": staged, "reuse": w * heads / staged}
    ok = ok and gaps[0] <= WIN_DBIAS_RTOL and repeat
    if cosine:
        bwd.update(dscale_rel_err=gaps[1], dscale_rtol=WIN_DSCALE_RTOL)
        ok = ok and gaps[1] <= WIN_DSCALE_RTOL
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(nbytes(qkv, bias, scale, dout, *got),
                                                2.0 * 5 * w * heads * n * n * 32)
    del got, want, again, err
    timed_row(bwd, plain_bwd, kernel_bwd, lib_bwd)
    log(f"kernel {label}_bwd {name}: dqkv max_abs_err={bwd['max_abs_err']:.3e} "
        f"(tol {WIN_ATOL}{' * s_h on dq, dk' if cosine else ''} + {WIN_RTOL}*|ref|); "
        f"|diff|/|ref| of dbias, dscale "
        f"{', '.join(f'{x:.3e}' for x in gaps)} (tol {WIN_DBIAS_RTOL}, {WIN_DSCALE_RTOL}); "
        f"a second call equal bit for bit: {repeat}; ok={ok} {timing_text(bwd)} "
        f"(library: forward + backward) reuse={bwd['reuse']:.2f} ({staged} stagings)")
    check(ok, f"{label}_bwd {name} disagrees with window_attention_bwd_reference")
    return fwd, bwd


def swin_phase(dev, report):
    """One Swin-MoE train step at batch 256 from ``configs/clip_swinmoe_b_cc3m.yaml``'s
    model block (published widths, bf16), K4's counters reset just before
    and read just after: 24 launches each way, finite loss and moe_aux, the
    MoE layers' counters; then the step's time and peak memory. Returns the
    launches; the model is freed."""
    from iterated_learning_for_vlm_tpu_torch.models import model_entry
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa
    from iterated_learning_for_vlm_tpu_torch.utils.config import load_config

    block = load_config(str(REPO / "configs" / "clip_swinmoe_b_cc3m.yaml")).model.to_dict()
    model = model_entry(block, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    params, state, step = make_trainer(model, is_fdt=False)
    rng = np.random.default_rng(SEED + 16)
    res = model.visual.cfg.input_resolution
    tokens, pad = make_texts(rng, BATCH, 32, 32)
    batch = {"image": torch.from_numpy(rng.standard_normal((BATCH, res, res, 3),
                                                           dtype=np.float32)).to(dev),
             "tokens": torch.from_numpy(tokens).to(dev), "pad_mask": torch.from_numpy(pad).to(dev)}
    moe = model.visual.moe_layers()
    step(state, batch, TRAIN_TEMPERATURE)  # first call: cuBLAS set-up, outside the count
    sync()
    reset_counters(wa.window_attention_fwd, wa.window_attention_bwd)
    for layer in moe:
        layer.counters = None
    metrics = step(state, batch, TRAIN_TEMPERATURE)
    sync()
    launches = {"window_attention_fwd": wa.window_attention_fwd.launches,
                "window_attention_bwd": wa.window_attention_bwd.launches}
    loss = metrics["loss"].item()
    routed, kept, slots, largest = (int(v) for v in torch.stack([m.counters for m in moe])
                                    .sum(dim=0).cpu())
    want_routed = sum(BATCH * blk.resolution ** 2 for stage in model.visual.layers
                      for blk in stage.blocks if blk.moe)
    log(f"swin-moe train step bs{BATCH} ctx32 {res}px: loss {loss:.6f}; launches {launches}; "
        f"{len(moe)} MoE layers: routed {routed}, kept {kept} ({kept / slots:.4f} of {slots} "
        f"slots), the largest expert load summed over layers {largest}")
    check(np.isfinite(loss), "the Swin-MoE train step's loss is not finite")
    check(launches == SWIN_LAUNCHES, f"swin-moe launches {launches}, expected {SWIN_LAUNCHES}")
    check(routed == want_routed and 0 < kept <= min(routed, slots),
          f"MoE counters routed {routed} (expected {want_routed}), kept {kept}, slots {slots}")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch, TRAIN_TEMPERATURE), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    log(f"timing swin-moe train step bs{BATCH} ctx32: {ms:.3f} ms ({BATCH / ms * 1e3:.1f} "
        f"pairs/s, CUDA events over 5 steps); peak memory {peak / 2**30:.2f} GiB")
    report["swin_step"] = {"loss": loss, "launches": launches, "moe_routed": routed,
                           "moe_kept": kept, "moe_slots": slots, "ms": ms,
                           "pairs_per_s": BATCH / ms * 1e3, "peak_mem_bytes": peak}
    del model, params, state, step, batch, moe, metrics
    gc.collect()
    torch.cuda.empty_cache()
    reset_counters(wa.window_attention_fwd, wa.window_attention_bwd)
    return launches


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


def route_counters():
    from iterated_learning_for_vlm_tpu_torch.models.fdt import codebook_route
    from iterated_learning_for_vlm_tpu_torch.models.layers import attention_route

    return attention_route, codebook_route


def reset_routes() -> None:
    for fn in route_counters():
        fn.plain_routes = 0


def check_routes(label: str) -> None:
    """No kernel knob of the phase got the plain path."""
    plain = {fn.__name__: fn.plain_routes for fn in route_counters()}
    check(not any(plain.values()), f"{label}: a kernel knob took the plain route {plain}")


# the device kernel each counted wrapper launches once a call, by a fragment of
# its name in a profiler trace
TRACED_KERNELS = {"tiny_attention_fwd": "tiny_attention_fwd_kernel",
                  "tiny_attention_bwd": "tiny_attention_bwd_kernel",
                  "codebook_pool_fwd": "codebook_pool_fwd_kernel",
                  "codebook_pool_bwd_dq": "codebook_pool_dq_gather_kernel",
                  "codebook_pool_bwd_dsd": "codebook_pool_bwd_dsd_kernel",
                  "flash_attention_fwd": "flash_attention_fwd_kernel",
                  "flash_attention_bwd": "flash_attention_bwd_dq_kernel"}


TRACE_PAD = 2000  # small kernels run at a trace's end, past the counted ones


def traced_launches(fn):
    """``fn()`` under a device-only ``torch.profiler``: (its result, the
    kernel records of each counted wrapper's kernel in the trace). A train
    step replayed as a CUDA graph adds the wrappers' counts that its capture
    made; these records are what the card ran."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
        # a trace can lack the records of the last kernels before its stop,
        # though the device has run them (PERF.md §7): let those be padding
        pad = torch.zeros(1, device="cuda")
        for _ in range(TRACE_PAD):
            pad.add_(1)
        sync()
    with tempfile.TemporaryDirectory(prefix="ilvlm_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            names = [e["name"] for e in json.load(f).get("traceEvents", [])
                     if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return out, {name: sum(frag in n for n in names) for name, frag in TRACED_KERNELS.items()}


def graph_counts(step) -> dict:
    """How the train step ran its calls: eagerly, captured, replayed."""
    return {k: getattr(step.graphs, k) for k in ("eager", "captures", "replays")}


def make_trainer(model, is_fdt: bool = True):
    """The bench trainer: masked AdamW at the CC3M config's lr schedule, weight
    decay and logit-scale clamp, on a fresh state (CLIP: no codebook, and the
    baseline config's schedule)."""
    from iterated_learning_for_vlm_tpu_torch.train import optim, schedule
    from iterated_learning_for_vlm_tpu_torch.train.step import make_train_step
    from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState

    params = dict(model.named_parameters())
    state = TrainState.create(params, optim.adamw_init(params), optim.trainable_mask_tree(params),
                              params["space_dict"] if is_fdt else None)
    lr = (schedule.cosine(5e-5, 5e-4, 0.0, 500, 80000, reset_steps=6000) if is_fdt
          else schedule.cosine(5e-5, 5e-4, 0.0, 500, 72000))
    step = make_train_step(model, lr, optim.build_wd_tree(params, 0.1, PCONFIG), is_fdt=is_fdt,
                           grad_clip_type="logit_scale_param_value", grad_clip_value=3.0,
                           grad_clip_max_value=6.0)
    return params, state, step


def train_batch(dev, rng, ctx):
    images = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
    tokens, pad = make_texts(rng, BATCH, ctx, ctx)
    return {"image": torch.from_numpy(images).to(dev), "tokens": torch.from_numpy(tokens).to(dev),
            "pad_mask": torch.from_numpy(pad).to(dev)}


def compare_grads(params_k, params_p, unread=UNREAD):
    """Per-parameter gradient agreement of the two paths: cosine, or the
    relative error of a one-element parameter; exact None on unread leaves."""
    worst, rows = 1.0, {}
    for name, pk in params_k.items():
        gk, gp = pk.grad, params_p[name].grad
        if name.startswith(unread) or not pk.requires_grad:
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


def train_phase(model, plain, batch, counted, expected=TRAIN_LAUNCHES, is_fdt=True,
                label="train step"):
    """One train step on each path from the same weights and state; the
    kernel path's launches counted from 0. Returns the launches, the report
    and both trainers (state, step), kernel path first, for the timing."""
    params_k, state_k, step_k = make_trainer(model, is_fdt)
    params_p, state_p, step_p = make_trainer(plain, is_fdt)
    sync()
    reset_counters(*counted.values())
    reset_routes()
    metrics_k = step_k(state_k, batch, TRAIN_TEMPERATURE)
    sync()
    launches = {name: fn.launches for name, fn in counted.items()}
    check_routes(label)
    metrics_p = step_p(state_p, batch, TRAIN_TEMPERATURE)
    loss_k, loss_p = metrics_k["loss"].item(), metrics_p["loss"].item()
    log(f"{label} bs{BATCH} ctx32: loss kernel path {loss_k:.6f}, plain path {loss_p:.6f} "
        f"(|diff| bound {TRAIN_LOSS_ATOL}); launches {launches}")
    check(np.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL,
          f"{label} loss disagrees with the plain path")
    check(launches == expected, f"{label} launches {launches}, expected {expected}")
    worst_cos, grad_rows = compare_grads(params_k, params_p, UNREAD if is_fdt else ())
    log(f"{label} grads: {len(grad_rows)} parameters compared, min cosine {worst_cos:.6f} "
        f"(bound {GRAD_MIN_COS}); logit_scale rel err "
        f"{grad_rows['logit_scale']['rel_err']:.3e} (bound {SCALAR_GRAD_RTOL})"
        + ("; unread leaves exactly zero on both paths" if is_fdt else ""))
    report = {"loss": loss_k, "plain_loss": loss_p, "launches": launches,
              "min_grad_cos": worst_cos, "grads": grad_rows}
    return launches, report, (state_k, step_k), (state_p, step_p)


def turns_ms(fns: dict, iters: int) -> dict:
    """Mean device ms per call of each function, timed in turns forward and
    back (a, b, c, c, b, a) so drift hits them alike."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        times[name].append(cuda_ms(fns[name], iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


def il_phase(model, batch):
    """Six kernel-path steps under a toy IL schedule; returns the report and
    the trainer (state, step), with nothing held or frozen."""
    from iterated_learning_for_vlm_tpu_torch.train.il import ILController, ResetConfig

    params_k, state_k, step_k = make_trainer(model)
    ctl = ILController(ResetConfig(reset_steps=2, smooth_steps=1, reset_nums=3), seed=SEED,
                       model=model)
    want = {n for n in params_k if n.startswith(TEXT_ROOTS) and any(k in n for k in REDRAWN)}
    losses = []
    reset_routes()
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
    check_routes("IL")
    log(f"IL: losses {[round(x, 5) for x in losses]}; the reset after step 4 redrew "
        f"{len(want)} text leaves and zeroed their moments; step 5 kept the codebook at its "
        f"snapshot and the vision tower unmoved; after step 6 nothing is held or frozen")
    return {"losses": losses, "redrawn": len(want)}, (state_k, step_k)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# -- phases 9-10: the baseline CLIP, flash route against the K2 and plain routes
def clip_serve_phase(encs, images, texts, counted):
    """Phase 9's serving: the flash route's launches, counted from 0, and its
    embeddings against the plain route's."""
    def serve(e):
        return (e.encode_images(images), *(e.encode_texts_tokens(t, p) for t, p in texts))

    serve(encs["flash"])  # first call: library set-up, outside the counted run
    sync()
    reset_counters(*counted.values())
    reset_routes()
    outs = serve(encs["flash"])
    sync()
    launches = {name: fn.launches for name, fn in counted.items()}
    check_routes("CLIP serve")
    log(f"CLIP serve: {BATCH} images + {BATCH} texts @ctx32 + {BATCH} texts @ctx77 on the "
        f"flash route; launches {launches}")
    check(launches == CLIP_SERVE_LAUNCHES,
          f"CLIP serve launches {launches}, expected {CLIP_SERVE_LAUNCHES}")
    rows = {}
    for name, got, ref in zip(("image", "text_ctx32", "text_ctx77"), outs, serve(encs["plain"])):
        check(got.shape == (BATCH, 512), f"CLIP {name} embeddings have shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"CLIP {name} embeddings are not finite")
        norm_err = float(np.abs(np.linalg.norm(got, axis=-1) - 1).max())
        cos = float(cosines(got, ref).min())
        rows[name] = {"min_cos_vs_plain": cos, "max_norm_err": norm_err}
        log(f"CLIP serve {name}: finite, |norm-1| max {norm_err:.2e} (tol {NORM_ATOL}), "
            f"min cosine vs plain route {cos:.6f} (bound {EMBED_MIN_COS})")
        check(norm_err <= NORM_ATOL, f"CLIP {name} embeddings are not unit-norm")
        check(cos >= EMBED_MIN_COS, f"CLIP {name} embeddings disagree with the plain route")
    return launches, {"launches": launches, **rows}


def clip_phases(dev, rng, counted, report):
    """Phases 9 and 10. Returns the flash route's serving and train-step
    launches (ViT-B/32)."""
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
    from iterated_learning_for_vlm_tpu_torch.models import model_entry
    from torch.profiler import ProfilerActivity, profile

    def build(route, mtype="clip_vitb32"):
        return model_entry(clip_config(route, mtype), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED))

    # 9. CLIP ViT-B/32, three routes from the same weights
    models = {route: build(route) for route in ("flash", "k2", "plain")}
    for route in ("k2", "plain"):
        models[route].load_state_dict(models["flash"].state_dict())
    encs = {r: TorchEncoder(m, batch_size=BATCH, text_buckets=(16, 32)) for r, m in models.items()}
    images = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
    texts = (make_texts(rng, BATCH, 77, 32), make_texts(rng, BATCH, 77, 77))
    serve_launches, report["clip_serve"] = clip_serve_phase(encs, images, texts, counted)

    x_img = torch.from_numpy(images).to(dev)
    t77, p77 = (torch.from_numpy(a).to(dev) for a in texts[1])
    serve_timing = {}
    for name, fn in (("image", lambda e: e.image_batch(x_img)),
                     ("text_ctx77", lambda e: e.text_batch(t77, p77))):
        ms = turns_ms({r: (lambda e=e: fn(e)) for r, e in encs.items()}, iters=10)
        serve_timing[name] = {r: {"ms": t, "embeds_per_s": BATCH / t * 1e3} for r, t in ms.items()}
        log(f"timing CLIP {name} bs{BATCH}: " + ", ".join(
            f"{r} route {t:.3f} ms ({BATCH / t * 1e3:.1f} embeds/s)" for r, t in ms.items()))
    report["clip_serve_timing"] = serve_timing
    del encs, x_img

    batch32, batch77 = train_batch(dev, rng, 32), train_batch(dev, rng, 77)
    train_launches, report["clip_train_step"], flash_tr, plain_tr = train_phase(
        models["flash"], models["plain"], batch32, counted, CLIP_TRAIN_LAUNCHES, is_fdt=False,
        label="CLIP B/32 train step")
    trainers = {"flash": flash_tr, "k2": make_trainer(models["k2"], is_fdt=False)[1:],
                "plain": plain_tr}
    train_timing = {}
    for ctx, batch in ((32, batch32), (77, batch77)):
        ms = turns_ms({r: (lambda st=st, fn=fn: fn(st, batch, 0.0))
                       for r, (st, fn) in trainers.items()}, iters=10)
        train_timing[f"ctx{ctx}"] = {r: {"ms": t, "pairs_per_s": BATCH / t * 1e3}
                                     for r, t in ms.items()}
        log(f"timing CLIP B/32 train step bs{BATCH} ctx{ctx}: " + ", ".join(
            f"{r} route {t:.3f} ms ({BATCH / t * 1e3:.1f} pairs/s)" for r, t in ms.items()))
    report["clip_train_timing"] = train_timing
    state_f, step_f = trainers["flash"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_f(state_f, batch32, 0.0)
        sync()
    log("profile CLIP B/32 flash-route train step ctx32:\n" + prof.key_averages().table(
        sort_by="cuda_time_total", row_limit=25, max_name_column_width=60))
    del models, trainers, flash_tr, plain_tr, state_f, step_f, batch77
    torch.cuda.empty_cache()

    # 10. CLIP ViT-B/16: S=197 in the vision tower, which only K3 takes
    fast, plain = build("flash", "clip_vitb16"), build("plain", "clip_vitb16")
    plain.load_state_dict(fast.state_dict())
    b16_launches, report["clip_b16_train_step"], (state_f, step_f), (state_p, step_p) = (
        train_phase(fast, plain, batch32, counted, CLIP_TRAIN_LAUNCHES, is_fdt=False,
                    label="CLIP B/16 train step"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_f(state_f, batch32, 0.0)
        sync()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k3 = {re.search(r"flash_attention\w*", e.key).group(0): e for e in kernels
          if "flash_attention" in e.key}
    k3_ms = sum(e.self_device_time_total for e in k3.values()) / 1e3
    report["clip_b16_profile"] = {"device_ms": device_ms, "k3_ms": k3_ms, "k3": {
        name: {"calls": e.count, "ms": e.self_device_time_total / 1e3} for name, e in k3.items()}}
    log(f"profile CLIP B/16 flash-route train step ctx32: {device_ms:.3f} ms of device time, "
        f"K3 kernels {k3_ms:.3f} ms ({k3_ms / device_ms:.1%}: "
        + ", ".join(f"{name} {e.count}x {e.self_device_time_total / 1e3:.3f} ms"
                    for name, e in k3.items()) + ")\n"
        + events.table(sort_by="cuda_time_total", row_limit=25, max_name_column_width=60))
    plain_ms, ms = paired_ms(lambda: step_p(state_p, batch32, 0.0),
                             lambda: step_f(state_f, batch32, 0.0), iters=3)
    report["clip_b16_train_timing"] = {"ms": ms, "plain_ms": plain_ms,
                                       "pairs_per_s": BATCH / ms * 1e3,
                                       "plain_pairs_per_s": BATCH / plain_ms * 1e3}
    log(f"timing CLIP B/16 train step bs{BATCH} ctx32: flash route {ms:.3f} ms "
        f"({BATCH / ms * 1e3:.1f} pairs/s), plain route {plain_ms:.3f} ms "
        f"({BATCH / plain_ms * 1e3:.1f} pairs/s)")
    return serve_launches, train_launches


# -- phase 11: the port's training loop ---------------------------------------
SOLVER_STEPS = 12
# configs/clip_fdt_cc3m.yaml's pconfig: no weight decay on norms, biases, scale
CC3M_PCONFIG = {"bn_w": {"weight_decay": 0}, "bn_b": {"weight_decay": 0},
                "ln_w": {"weight_decay": 0}, "ln_b": {"weight_decay": 0},
                "bias": {"weight_decay": 0}, "logit_scale": {"weight_decay": 0}}


def solver_config() -> dict:
    """Phase 11's config, a dict (the smoke reads no file and needs no
    PyYAML): the bench model with both kernels on, ``configs/clip_fdt_cc3m.yaml``'s
    ``grad_clip``, ``optimizer`` and ``lr_scheduler`` blocks with ``max_iter``
    12, and a compressed schedule: T halves every 4 steps; the IL reset fires
    at step 8, its smooth phase ends at 10, its window at 12; saves at 9 and
    12."""
    return {
        "model": model_config(fused=True),
        "grad_clip": {"type": "logit_scale_param_value", "value": 3, "max_value": 6},
        "t_decay": {"org_t": 1000, "sd_T_decay_iter": 4, "sd_T_decay_w": 0.5, "sd_T_min": 0.01},
        "optimizer": {"type": "AdamW",
                      "kwargs": {"lr": 0.00005, "weight_decay": 0.1, "betas": [0.9, 0.98],
                                 "eps": 0.00000001},
                      "pconfig": CC3M_PCONFIG},
        "lr_scheduler": {"type": "Cosine",
                         "kwargs": {"base_lr": 0.00005, "warmup_lr": 0.0005, "min_lr": 0.0,
                                    "warmup_steps": 500, "max_iter": SOLVER_STEPS}},
        "data": {"train": {"synthetic": True, "batch_size": BATCH, "num_batches": SOLVER_STEPS,
                           "epoch": 1}},
        "saver": {"print_freq": 4, "val_freq": 0, "save_freq": 9},
        "reset": {"enable": True, "reset_steps": 4, "reset_nums": 3, "smooth_steps": 2,
                  "semantics": "reference"},
    }


def instrument(solver, checks: bool):
    """Wrap the Solver's step and IL controller (no device sync on the way):
    each step's loss (a device scalar) and host times, and with ``checks``
    the IL phase checks of run A."""
    rec = {"loss": {}, "enter": {}, "exit": {}}
    params, step_fn, on_step = solver.params, solver.train_step, solver.il.on_step
    snap = {}
    want = {n for n in params if n.startswith(TEXT_ROOTS) and any(k in n for k in REDRAWN)}

    def spy_step(state, batch, temperature):
        rec["enter"][state.step + 1] = time.perf_counter()
        metrics = step_fn(state, batch, temperature)
        rec["loss"][state.step] = metrics["loss"]
        return metrics

    def spy_il(state, step):
        if checks and step in (9, 10):
            check(torch.equal(params["space_dict"], state.stored_codebook)
                  and torch.equal(params["space_dict"], snap["space_dict"]),
                  f"solver: the codebook left its snapshot in step {step}")
            check(all(torch.equal(params[n], v) for n, v in snap.items()),
                  f"solver: the frozen vision tower moved in step {step}")
        before = None
        if checks and step == 8:
            before = {n: p.detach().clone() for n, p in params.items()}
        state = on_step(state, step)
        if before is not None:
            changed = {n for n, p in params.items() if not torch.equal(p, before[n])}
            check(changed == want, f"solver: the reset changed {sorted(changed ^ want)} "
                                   "unexpectedly")
            check(all(state.opt_state["count"][n] == 0.0 and not state.opt_state["mu"][n].any()
                      and not state.opt_state["nu"][n].any() for n in want),
                  "solver: the reset left moments on a redrawn leaf")
            check(state.hold_codebook and not state.trainable["visual.proj"],
                  "solver: the reset did not hold the codebook and freeze the vision tower")
            snap.update({n: p.detach().clone() for n, p in params.items()
                         if n.startswith(("visual.", "img_query_model.")) or n == "space_dict"})
            rec["redrawn"] = len(want)
            del before
        rec["exit"][step] = time.perf_counter()
        return state

    solver.train_step, solver.il.on_step = spy_step, spy_il
    return rec


def solver_phase(dev, counted, report):
    """Phase 11: the port's Solver on the card, run A (12 steps) and run B
    (a fresh Solver resumed from run A's ``ckpt_9``). Returns run A's launches."""
    from iterated_learning_for_vlm_tpu_torch.train import checkpoint as ckpt
    from iterated_learning_for_vlm_tpu_torch.train import solver as solver_mod
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    yaml_ok = importlib.util.find_spec("yaml") is not None
    saves = []
    save_checkpoint = solver_mod.save_checkpoint

    def timed_save(*args, **kwargs):  # the loop's blocking part of an async save
        t0 = time.perf_counter()
        path = save_checkpoint(*args, **kwargs)
        saves.append(time.perf_counter() - t0)
        return path

    solver_mod.save_checkpoint = timed_save
    row = {"yaml_importable": yaml_ok}
    with tempfile.TemporaryDirectory(prefix="ilvlm_solver_") as tmp:
        t0 = time.perf_counter()
        a = solver_mod.Solver(Config(solver_config()), output_path=os.path.join(tmp, "a"),
                              exp_name="smoke", device=dev)
        sync()
        row["build_s"] = time.perf_counter() - t0
        step_a = a.train_step
        rec_a = instrument(a, checks=True)
        sync()
        reset_counters(*counted.values())
        reset_routes()
        t0 = time.perf_counter()
        _, launches = traced_launches(a.train)
        row["train_a_s"] = time.perf_counter() - t0
        counters = {name: fn.launches for name, fn in counted.items()}
        row["graph"] = graph_counts(step_a)
        check_routes("solver")
        want = {name: SOLVER_STEPS * n for name, n in TRAIN_LAUNCHES.items()}
        check(launches == want, f"solver launches in the trace {launches}, expected {want}")
        check(counters == want, f"solver launch counters {counters}, expected {want}")
        check(sum(row["graph"].values()) == SOLVER_STEPS and row["graph"]["replays"],
              f"solver: the train step ran {row['graph']}")
        losses_a = {s: v.item() for s, v in rec_a["loss"].items()}
        check(sorted(losses_a) == list(range(1, SOLVER_STEPS + 1))
              and all(np.isfinite(v) for v in losses_a.values()),
              f"solver losses are not 12 finite values: {losses_a}")
        check(not a.state.hold_codebook and all(
            v for n, v in a.state.trainable.items() if n != "visual.conv1.weight"),
            "solver: something is still held or frozen after the IL window")
        with open(os.path.join(a.output_path, "metrics.jsonl")) as f:
            metrics_steps = [json.loads(line)["step"] for line in f]
        with open(os.path.join(a.output_path, "log.txt")) as f:
            il_lines = [line.strip() for line in f if ": IL " in line]
        check(metrics_steps == [4, 8, 12], f"solver metrics.jsonl steps {metrics_steps}")
        check(any("step 8: IL reset" in x for x in il_lines)
              and any("step 10: IL smooth end" in x for x in il_lines),
              f"solver log.txt IL lines {il_lines}")
        names = sorted(os.listdir(a.save_path))
        check(names == ["ckpt_12.pth.tar", "ckpt_9.pth.tar"], f"solver checkpoints {names}")
        ckpt_9 = os.path.join(a.save_path, "ckpt_9.pth.tar")
        row["checkpoint_bytes"] = os.path.getsize(ckpt_9)
        row["async_save_blocking_s"] = saves[:]
        steps = sorted(rec_a["exit"])
        row["step_host_ms"] = [1e3 * (rec_a["exit"][s] - rec_a["enter"][s]) for s in steps]
        row["data_host_ms"] = [1e3 * (rec_a["enter"][s] - rec_a["exit"][s - 1]) for s in steps[1:]]
        row["meters"] = {"batch_time": a.meters["batch_time"].avg}
        final = {n: p.detach().cpu() for n, p in a.params.items()}
        os.remove(os.path.join(a.save_path, "ckpt_12.pth.tar"))
        del a, rec_a
        gc.collect()
        torch.cuda.empty_cache()

        # run B: a fresh Solver resumed from ckpt_9, inside the codebook hold
        t0 = time.perf_counter()
        b = solver_mod.Solver(Config(solver_config()), output_path=os.path.join(tmp, "b"),
                              exp_name="smoke", ckpt_path=ckpt_9, device=dev)
        sync()
        row["build_and_restore_b_s"] = time.perf_counter() - t0
        check(b._last_iter == 9 and b.state.hold_codebook, "solver: the resume lost its state")
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(ckpt_9, b.model, b.state)  # again, timed alone
        sync()
        row["restore_s"] = time.perf_counter() - t0
        rec_b = instrument(b, checks=False)
        reset_counters(*counted.values())
        reset_routes()
        b.train()
        sync()
        check_routes("solver resume")
        losses_b = {s: v.item() for s, v in rec_b["loss"].items()}
        diffs = {n: (p.detach().cpu() != final[n]).sum().item() for n, p in b.params.items()}
        bitwise = (all(losses_b[s] == losses_a[s] for s in (10, 11, 12))
                   and sorted(losses_b) == [10, 11, 12] and not any(diffs.values()))
        row["resume"] = {"losses_a": [losses_a[s] for s in (10, 11, 12)],
                         "losses_b": [losses_b.get(s) for s in (10, 11, 12)],
                         "bit_for_bit": bitwise,
                         "params_differing": {n: d for n, d in diffs.items() if d}}
        t0 = time.perf_counter()
        ckpt.save_checkpoint(b.save_path, b.model, b.state, SOLVER_STEPS)
        row["sync_save_s"] = time.perf_counter() - t0
        del b, rec_b, final
        gc.collect()
        torch.cuda.empty_cache()
    solver_mod.save_checkpoint = save_checkpoint
    report["solver"] = row | {"launches": launches}
    log(f"solver: {SOLVER_STEPS} steps of Solver.train() at bs{BATCH} ctx77 in "
        f"{row['train_a_s']:.2f} s under a device profiler (build {row['build_s']:.2f} s); "
        f"the step ran {row['graph']}; kernels in the trace {launches}, the wrappers' "
        "counters the same; "
        f"losses {[round(losses_a[s], 5) for s in sorted(losses_a)]}; the reset after step 8 "
        "redrew the reference text leaves and zeroed their moments, steps 9-10 kept the "
        "codebook at its snapshot and the vision tower unmoved, nothing held or frozen after "
        f"step 12; metrics.jsonl steps {metrics_steps}; log.txt: {il_lines}")
    log("solver host times (host clock, no device sync; the synthetic images are drawn on "
        "the host, so these are not throughput figures): step ms "
        + ", ".join(f"{x:.1f}" for x in row["step_host_ms"]) + "; data ms "
        + ", ".join(f"{x:.1f}" for x in row["data_host_ms"])
        + f"; meter (last 4 steps) batch_time {row['meters']['batch_time'] * 1e3:.1f} ms")
    log(f"solver checkpoint: {row['checkpoint_bytes']} bytes; async save in the loop blocked "
        + ", ".join(f"{x:.3f}" for x in row["async_save_blocking_s"])
        + f" s; a synchronous save {row['sync_save_s']:.3f} s; restore {row['restore_s']:.3f} s; "
        f"resumed Solver built and restored in {row['build_and_restore_b_s']:.3f} s")
    log(f"solver resume from ckpt_9: losses of steps 10-12 {row['resume']['losses_b']} against "
        f"run A's {row['resume']['losses_a']}; bit for bit: {bitwise}"
        + ("" if bitwise else f"; parameters differing {row['resume']['params_differing']}"))
    log(f"solver: PyYAML importable on this machine: {yaml_ok}")
    check(bitwise, "solver: the resume from ckpt_9 did not repeat run A bit for bit")
    return launches


# -- phase 12: the data pipeline --------------------------------------------------
PIPE_STEPS = 8
PIPE_SHARDS, PIPE_PER_SHARD = 5, 512
# captions made 34 tokens long (the class caption four times), past the ctx-32
# bucket: for seed 0 the 8 steps run at ctx 77, 32, 32, 32, 77, 32, 32, 77
PIPE_LONG = set(np.random.default_rng(12).choice(PIPE_SHARDS * PIPE_PER_SHARD, 8,
                                                 replace=False).tolist())
# configs/clip_fdt_cc3m.yaml's t_decay (T stays at 1000 for 2700 steps)
CC3M_T_DECAY = {"org_t": 1000, "sd_T_decay_iter": 2700, "sd_T_decay_w": 1, "sd_T_min": 0.01}


def long_caption(k: int, caption: str) -> str:
    return " ".join([caption] * 4) if k in PIPE_LONG else caption


def shard_train_block(data_path: str) -> dict:
    """``configs/clip_fdt_cc3m.yaml``'s ``data.train`` pointed at the phase's
    shards and cut to their size (the default uint8 wire)."""
    return {"epoch": 30, "data_path": data_path, "transforms": "MOCOV2_single",
            "num_samples": PIPE_SHARDS * PIPE_PER_SHARD, "num_shards": PIPE_SHARDS,
            "workers": 5, "batch_size": BATCH, "context_buckets": [32, 77],
            "context_buckets_sync": True}


def pipeline_config(train: dict) -> dict:
    """Phase 12's config: phase 11's model, ``grad_clip`` and ``optimizer``,
    the CC3M ``t_decay`` and ``lr_scheduler`` with ``max_iter`` 8, the data
    block ``train``, no IL (phase 11 covers it), saves at 5 and 8."""
    cfg = solver_config()
    cfg["lr_scheduler"]["kwargs"]["max_iter"] = PIPE_STEPS
    cfg.update({"t_decay": CC3M_T_DECAY, "data": {"train": train},
                "saver": {"print_freq": 4, "val_freq": 0, "save_freq": 5},
                "reset": {"enable": False}})
    return cfg


def within_ulp(a: np.ndarray, b: np.ndarray):
    """(every element within one fp32 ulp, max |a - b|, elements that differ)."""
    diff = np.abs(a - b)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return bool(np.all(diff <= ulp)), float(diff.max()), int((diff != 0).sum())


def copy_times(dev, reps: int = 5) -> dict:
    """One bs-256 uint8 224-px batch: the host copy into pinned memory (host
    clock) and the copy to the card from pinned and from pageable memory
    (CUDA events), each the mean of ``reps``."""
    x = np.random.default_rng(SEED).integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
    src = torch.from_numpy(x)
    t0 = time.perf_counter()
    for _ in range(reps):
        pinned = src.pin_memory()
    pin_ms = (time.perf_counter() - t0) / reps * 1e3
    if dev.type != "cuda":
        return {"bytes": x.nbytes, "pin_ms": pin_ms, "pinned_h2d_ms": float("nan"),
                "pageable_h2d_ms": float("nan")}
    out = {"bytes": x.nbytes, "pin_ms": pin_ms}
    for name, host in (("pinned_h2d_ms", pinned), ("pageable_h2d_ms", src)):
        out[name] = cuda_ms(lambda: host.to(dev, non_blocking=True), iters=reps, warmup=1)
    return out


def pipeline_phase(dev, counted, report, tmp):
    """Phase 12: ``Solver.train()`` from JPEG shards (run A, 8 steps) and its
    resume from ``ckpt_5`` (run B), then ``encode_images`` on PIL images with
    the bf16 serving cast. Without Pillow, synthetic data through the same
    prefetcher and the native augment on uint8 arrays. Everything it writes
    goes under ``tmp``. Returns run A's launches, its config and the paths of
    its checkpoints and log."""
    from iterated_learning_for_vlm_tpu_torch.data import augment as aug
    from iterated_learning_for_vlm_tpu_torch.data import native
    from iterated_learning_for_vlm_tpu_torch.data import pipeline as pipe
    from iterated_learning_for_vlm_tpu_torch.data.shards import iter_tar_samples
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
    from iterated_learning_for_vlm_tpu_torch.tools.make_train_shards import write_shards
    from iterated_learning_for_vlm_tpu_torch.train import solver as solver_mod
    from iterated_learning_for_vlm_tpu_torch.utils import profiling
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=False).stdout.split("\n")[0]
    row = {"pillow": pillow, "native_available": native.available(), "gxx": gxx}
    log(f"pipeline: Pillow {pillow}; native augment available {row['native_available']} "
        f"({native.library_path().name}, built by {gxx})")
    check(row["native_available"], "pipeline: the native augment did not build")
    tiers = {"native": 0, "pil": 0}

    def counted_tier(name, fn):
        def call(*args, **kwargs):
            tiers[name] += 1
            return fn(*args, **kwargs)
        return call

    tier_fns = aug._mocov2_native, aug._mocov2_pil
    aug._mocov2_native = counted_tier("native", tier_fns[0])
    aug._mocov2_pil = counted_tier("pil", tier_fns[1])
    rng = np.random.default_rng(SEED)
    if pillow:
        t0 = time.perf_counter()
        paths = write_shards(os.path.join(tmp, "shards"), PIPE_SHARDS, PIPE_PER_SHARD,
                             caption_fn=long_caption)
        row["write_shards_s"] = time.perf_counter() - t0
        train = shard_train_block(os.path.join(tmp, "shards",
                                               f"{{00000..{PIPE_SHARDS - 1:05d}}}.tar"))
        # the host float wire's first batch, from the same shards and seed
        fcfg = dict(train, wire_dtype="float32", image_size=224, context_length=77)
        host_first = next(iter(pipe.get_wds_dataset(fcfg, seed=SEED).dataloader))["image"]
    else:
        log(json.dumps({"phase12": "no Pillow on this machine: JPEG decode not run"}))
        train = {"synthetic": True, "batch_size": BATCH, "num_batches": PIPE_STEPS,
                 "epoch": 1}
        arrays = [rng.integers(0, 256, (256, 320, 3), dtype=np.uint8) for _ in range(BATCH)]
        u8 = np.stack([aug.mocov2_single(a, np.random.default_rng(i), out_u8=True)
                       for i, a in enumerate(arrays)])
        host_first = np.stack([aug.mocov2_single(a, np.random.default_rng(i))
                               for i, a in enumerate(arrays)])
        staged = next(pipe.prefetch_to_device(iter([{"image": u8}]), dev))["image"]
    cfg = pipeline_config(train)

    # run A: 8 steps from the shards, fenced on each loss
    a = solver_mod.Solver(Config(cfg), output_path=os.path.join(tmp, "a"),
                          exp_name="pipeline", device=dev)
    rec = {"loss": {}, "ctx": {}, "enter": {}, "exit": {}, "data": []}
    timer = profiling.StepTimer(warmup=1)
    step_fn, batches = a.train_step, a._batches

    def timed_batches(epoch, skip=0):  # the loop's wait for each next batch
        it = batches(epoch, skip)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            rec["data"].append(time.perf_counter() - t0)
            yield batch

    def spy_step(state, batch, temperature):
        step = state.step + 1
        rec["enter"][step] = time.perf_counter()
        rec["ctx"][step] = batch["tokens"].shape[1]
        if step == 1 and pillow:
            rec["first_image"] = batch["image"].detach().cpu().numpy()
        metrics = step_fn(state, batch, temperature)
        timer.tick(metrics["loss"])
        rec["exit"][step] = time.perf_counter()
        rec["loss"][step] = metrics["loss"]
        return metrics

    a.train_step, a._batches = spy_step, timed_batches
    sync()
    if dev.type == "cuda":  # the peak of this run alone
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counters(*counted.values())
    reset_routes()
    tiers.update(native=0, pil=0)
    t0 = time.perf_counter()
    _, launches = traced_launches(a.train)
    row["train_a_s"] = time.perf_counter() - t0
    counters = {name: fn.launches for name, fn in counted.items()}
    row["graph"] = graph_counts(step_fn)
    check_routes("pipeline")
    want = {name: PIPE_STEPS * n for name, n in TRAIN_LAUNCHES.items()}
    check(launches == want, f"pipeline launches in the trace {launches}, expected {want}")
    check(counters == want, f"pipeline launch counters {counters}, expected {want}")
    check(sum(row["graph"].values()) == PIPE_STEPS and row["graph"]["replays"],
          f"pipeline: the train step ran {row['graph']}")
    losses_a = {s: v.item() for s, v in rec["loss"].items()}
    check(sorted(losses_a) == list(range(1, PIPE_STEPS + 1))
          and all(np.isfinite(v) for v in losses_a.values()),
          f"pipeline losses are not {PIPE_STEPS} finite values: {losses_a}")
    ctxs = [rec["ctx"][s] for s in sorted(rec["ctx"])]
    row.update(losses_a=losses_a, ctx=ctxs, tiers=dict(tiers),
               step_host_ms=[1e3 * (rec["exit"][s] - rec["enter"][s]) for s in sorted(rec["exit"])],
               data_ms=[1e3 * x for x in rec["data"]],
               timer=timer.summary(), memory=profiling.device_memory_stats())
    check(tiers["pil"] == 0 and (tiers["native"] >= PIPE_STEPS * BATCH or not pillow),
          f"pipeline: augment tiers {tiers}, expected the native tier only")
    if pillow:
        check(set(ctxs) == {32, 77}, f"pipeline: batches ran at contexts {ctxs}, "
                                     "expected both 32 and 77")
        staged = rec.pop("first_image")
    else:
        staged = staged.cpu().numpy()
    ok, err, differ = within_ulp(staged, host_first)
    row["normalize"] = {"within_1_ulp": ok, "max_abs_diff": err, "elements_differing": differ}
    check(ok, f"pipeline: the device normalize is {err} from the host float path")
    log(f"pipeline: {PIPE_STEPS} steps of Solver.train() at bs{BATCH} from "
        + (f"{PIPE_SHARDS} JPEG shards x {PIPE_PER_SHARD} (written in "
           f"{row['write_shards_s']:.1f} s), MOCOV2_single" if pillow else "synthetic data")
        + f", in {row['train_a_s']:.2f} s under a device profiler; the step ran "
        f"{row['graph']}; kernels in the trace {launches}, the wrappers' counters the same; "
        "losses "
        f"{[round(losses_a[s], 5) for s in sorted(losses_a)]}; contexts {ctxs} "
        f"(ctx 32: {ctxs.count(32)}, ctx 77: {ctxs.count(77)}); augment tiers {tiers}")
    log(f"pipeline normalize: the first batch normalized on the device against the host "
        f"float wire: within 1 fp32 ulp {ok}, max |diff| {err:.3e}, {differ} elements differ")
    log("pipeline host times (not throughput figures: the host's decode sets them): "
"data_time (the loop's wait for each batch) ms " + ", ".join(f"{x:.1f}" for x in row["data_ms"])
        + "; step ms (fenced on the loss) " + ", ".join(f"{x:.1f}" for x in row["step_host_ms"])
        + f"; StepTimer {row['timer']}")
    log(f"pipeline device memory: {row['memory']}")
    row["copy"] = copy_times(dev)
    log("pipeline copy of one uint8 batch ({bytes} bytes): into pinned host memory "
        "{pin_ms:.2f} ms (host clock), pinned to the card {pinned_h2d_ms:.3f} ms, "
        "pageable to the card {pageable_h2d_ms:.3f} ms (CUDA events)".format(**row["copy"]))
    final = {n: p.detach().cpu() for n, p in a.params.items()}
    ckpt_5 = os.path.join(a.save_path, "ckpt_5.pth.tar")
    check(sorted(os.listdir(a.save_path)) == ["ckpt_5.pth.tar", "ckpt_8.pth.tar"],
          f"pipeline checkpoints {sorted(os.listdir(a.save_path))}")
    run_a = {"config": cfg, "ckpts": [ckpt_5, os.path.join(a.save_path, "ckpt_8.pth.tar")],
             "log": os.path.join(a.output_path, "log.txt")}

    # serving: PIL images (or, without Pillow, uint8 arrays) through ONECROP,
    # with the bf16 serving cast and without it
    if pillow:
        images = [pipe._decode_image(x) for x in itertools.islice(iter_tar_samples(paths[0]),
                                                                  BATCH)]
    else:
        images = arrays
    enc_cast = TorchEncoder(a.model, batch_size=BATCH, num_workers=4,
                            weight_dtype=torch.bfloat16, sd_temperature=SD_TEMPERATURE)
    enc = TorchEncoder(a.model, batch_size=BATCH, num_workers=4,
                       sd_temperature=SD_TEMPERATURE)
    enc_cast.encode_images(images[:8])  # first call: cuBLAS set-up, outside the count
    sync()
    reset_counters(*counted.values())
    reset_routes()
    emb_cast = enc_cast.encode_images(images)
    sync()
    check_routes("pipeline serving")
    serve_launches = {name: fn.launches for name, fn in counted.items() if fn.launches}
    emb = enc.encode_images(images)
    cast_params = {n: p.dtype for n, p in enc_cast.model.named_parameters()}
    row["serving"] = {"launches": serve_launches, "bit_for_bit": bool(np.array_equal(
        emb_cast, emb)), "bf16_params": sum(d == torch.bfloat16 for d in cast_params.values()),
        "fp32_params": sum(d == torch.float32 for d in cast_params.values())}
    log(f"pipeline serving: encode_images of {len(images)} "
        + ("PIL images from the shards" if pillow else "uint8 arrays")
        + f" (ONECROP, 4 workers) with weight_dtype=bfloat16 "
        f"({row['serving']['bf16_params']} parameters cast, "
        f"{row['serving']['fp32_params']} kept fp32): launches {serve_launches}; equal bit "
        f"for bit to the uncast encoder: {row['serving']['bit_for_bit']}")
    check(emb.shape == (BATCH, 512) and bool(np.isfinite(emb).all()),
          "pipeline serving: embeddings are malformed")
    check(row["serving"]["bit_for_bit"], "pipeline serving: the bf16 cast changed the "
                                         "embeddings")
    check(serve_launches == {"tiny_attention_fwd": 12, "codebook_pool_fwd": 1},
          f"pipeline serving launched {serve_launches}, expected 12 and 1")
    del enc, enc_cast, a, rec
    gc.collect()
    torch.cuda.empty_cache()

    # run B: a fresh Solver resumed from ckpt_5 skips 5 batches
    b = solver_mod.Solver(Config(cfg), output_path=os.path.join(tmp, "b"),
                          exp_name="pipeline", ckpt_path=ckpt_5, device=dev)
    check(b._last_iter == 5, "pipeline: the resume lost its step")
    losses_b, step_b = {}, b.train_step

    def spy_b(state, batch, temperature):
        metrics = step_b(state, batch, temperature)
        losses_b[state.step] = metrics["loss"]
        return metrics

    b.train_step = spy_b
    reset_routes()
    b.train()
    sync()
    check_routes("pipeline resume")
    losses_b = {s: v.item() for s, v in losses_b.items()}
    diffs = {n: (p.detach().cpu() != final[n]).sum().item() for n, p in b.params.items()}
    rest = list(range(6, PIPE_STEPS + 1))
    bitwise = (sorted(losses_b) == rest and all(losses_b[s] == losses_a[s] for s in rest)
               and not any(diffs.values()))
    row["resume"] = {"losses_a": [losses_a[s] for s in rest],
                     "losses_b": [losses_b.get(s) for s in rest], "bit_for_bit": bitwise,
                     "params_differing": {n: d for n, d in diffs.items() if d}}
    log(f"pipeline resume from ckpt_5: losses of steps 6-8 {row['resume']['losses_b']} "
        f"against run A's {row['resume']['losses_a']}; bit for bit: {bitwise}"
        + ("" if bitwise else f"; parameters differing {row['resume']['params_differing']}"))
    check(bitwise, "pipeline: the resume from ckpt_5 did not repeat run A bit for bit")
    del b, final
    gc.collect()
    torch.cuda.empty_cache()
    aug._mocov2_native, aug._mocov2_pil = tier_fns
    report["pipeline"] = row | {"launches": launches}
    return launches, run_a


# -- phase 13: the eval suite over phase 12's checkpoints --------------------------
# a zero-shot set of ImageNet-1k's classifier shape (1000 classes x 80 prompts),
# 2 images a class; a probe set of 64 classes x 16 train / 4 test images; a
# retrieval set of COCO-5k's test shape (5 captions an image) cut to 1000
# images; SugarCREPE probes of 256 items a split; CREPE rows and COLA pairs
EVAL_CLASSES, EVAL_PER_CLASS = 1000, 2
PROBE_CLASSES, PROBE_TRAIN, PROBE_TEST = 64, 16, 4
RET_IMAGES = 1000
RET_TEMPLATES = ("a photo of {}", "{}", "an image showing {}", "a close-up picture of {}",
                 "there is {} here")
SC_PER_SPLIT = 256
SC_SPLITS = 5  # the SugarCREPE-named splits make_compositional_data.py writes
GROUP_ITEMS = 48  # CREPE rows; COLA pairs are half as many
SC_BATCH = 64  # the Solver hook's encoder batch (TorchEncoder's default, as JAX's)


def eval_data(root: str) -> None:
    """Phase 13's data, from seeds: the zero-shot and probe sets and the
    SugarCREPE probes through the port's ``tools/make_eval_set.py`` and
    ``tools/make_compositional_data.py``; the retrieval JSON, CREPE CSV and
    COLA JSON over JPEGs of the same synthetic classes and coloured shapes."""
    import csv

    from PIL import Image

    from iterated_learning_for_vlm_tpu_torch.data import compositional as comp
    from iterated_learning_for_vlm_tpu_torch.data.synthetic import SyntheticClipData
    from iterated_learning_for_vlm_tpu_torch.tools import make_compositional_data, make_eval_set

    make_eval_set.main([f"{root}/zs", "--num-classes", str(EVAL_CLASSES), "--per-class",
                        str(EVAL_PER_CLASS)])
    make_eval_set.main([f"{root}/probe", "--num-classes", str(PROBE_CLASSES), "--per-class",
                        str(PROBE_TRAIN), "--split", "train"])
    make_eval_set.main([f"{root}/probe", "--num-classes", str(PROBE_CLASSES), "--per-class",
                        str(PROBE_TEST), "--split", "test", "--noise-seed", "778"])
    make_compositional_data.main([f"{root}/comp", "--shards", "0", "--eval-per-split",
                                  str(SC_PER_SPLIT)])
    gen = SyntheticClipData(batch_size=1, image_size=224, seed=SEED, correlated=True,
                            num_classes=RET_IMAGES)
    rng = np.random.default_rng((SEED, 13))
    os.makedirs(f"{root}/ret")
    items = []
    for k in range(RET_IMAGES):
        arr = np.clip((gen._class_image(k, rng) * 0.25 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(f"{root}/ret/{k}.jpg", quality=92)
        name = " ".join(gen._class_caption(k).split()[3:])
        items.append({"image": f"{k}.jpg", "captions": [t.format(name) for t in RET_TEMPLATES]})
    with open(f"{root}/ret.json", "w") as f:
        json.dump(items, f)

    def caption(pair):
        return comp.caption_for(comp.COLOR_NAMES[pair[0]], comp.SHAPES[pair[1]])

    pairs = comp.seen_pairs() + comp.unseen_pairs()
    rng = np.random.default_rng((SEED, 14))
    os.makedirs(f"{root}/scenes")
    drawn = [pairs[k % len(pairs)] for k in range(GROUP_ITEMS)]
    for k, (c, s) in enumerate(drawn):
        Image.fromarray(comp.to_uint8(comp.draw(c, s, 160, rng))).save(
            f"{root}/scenes/{k}.jpg", quality=92)
    crepe_dir = f"{root}/crepe/prod_hard_negatives/atom"
    os.makedirs(crepe_dir)
    with open(f"{crepe_dir}/prod_vg_hard_negs_atom_complexity_5.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_id", "caption", "hard_negs"])
        for k, (c, s) in enumerate(drawn):
            negs = [caption(comp.negative_pair(c, s, swap, rng))
                    for swap in ("color", "shape", "color", "shape", "color")]
            w.writerow([k, caption((c, s)), repr(negs)])
    with open(f"{root}/cola.json", "w") as f:
        json.dump([[f"{2 * i}.jpg", caption(drawn[2 * i]), f"{2 * i + 1}.jpg",
                    caption(drawn[2 * i + 1])] for i in range(GROUP_ITEMS // 2)], f)


def metrics_in_range(label: str, metrics) -> None:
    """Every metric finite and in its range: scores and recalls in [0, 1],
    CREPE's ranks among its 6 candidates, CIDEr-D (x10) in [0, 10]."""
    for key, value in metrics.items():
        if isinstance(value, dict):
            metrics_in_range(f"{label} {key}", value)
        elif key == "normalized":
            check(value is True, f"eval {label}: the probe's features were not normalized")
        elif key == "weight_decay":
            check(value in (0.0, 1e-6, 1e-4, 1e-2), f"eval {label}: weight decay {value}")
        else:
            hi = 6.0 if "rank" in key else 10.0 if key == "CIDEr" else 1.0
            check(np.isfinite(value) and 0.0 <= value <= hi,
                  f"eval {label}: {key} = {value} is not finite in [0, {hi}]")


class EvalRuns:
    """Runs of the eval CLI (``eval.cli.main``, in-process) or of a callable,
    each with the launch and plain-route counters reset just before and read
    just after: it must launch K2-fwd 12 times and K1-fwd once per encoder
    batch and nothing else, take no plain route and give finite metrics in
    range. Inside ``with``, the encoder's batch calls are fenced and timed
    (host clock), and the host work beside them (loading, the dataset, the
    tokenizer, preprocessing) is timed too. Each run's record goes to
    ``row["runs"][label]``; ``total`` sums the launches of all runs."""

    def __init__(self, counted, row, config, temperature, out, pretrained):
        self.counted, self.row, self.config = counted, row, config
        self.temperature, self.out, self.pretrained = temperature, out, pretrained
        self.total = {name: 0 for name in counted}
        self.stats, self.loads = {}, []

    def __enter__(self):
        from iterated_learning_for_vlm_tpu_torch.data.tokenizer import ClipTokenizer
        from iterated_learning_for_vlm_tpu_torch.eval import builder, cli
        from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder

        stats, loads = self.stats, self.loads

        def timed_batch(kind, fn):  # fenced: the caller copies the result to the host next
            def call(self, *args, **kwargs):
                if kind == "text":  # the context bucket the batch runs at
                    ctx = str(args[0].shape[1])
                    stats["text_ctx"][ctx] = stats["text_ctx"].get(ctx, 0) + 1
                t0 = time.perf_counter()
                out = fn(self, *args, **kwargs)
                torch.cuda.synchronize()
                stats[f"{kind}_s"] += time.perf_counter() - t0
                stats[f"{kind}_batches"] += 1
                return out
            return call

        def counted_items(kind, fn):
            def call(self, items, *args, **kwargs):
                stats[kind] += len(items)
                return fn(self, items, *args, **kwargs)
            return call

        def timed(key, fn):  # the host work beside the batch calls
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    stats[key] += time.perf_counter() - t0
            return call

        self._restore = [(TorchEncoder, name, getattr(TorchEncoder, name)) for name in
                         ("image_batch", "text_batch", "encode_images", "encode_texts",
                          "preprocess")]
        self._restore += [(cli, "_load_encoder", cli._load_encoder),
                          (builder, "build_dataset", builder.build_dataset),
                          (ClipTokenizer, "__call__", ClipTokenizer.__call__)]
        originals = {name: fn for _, name, fn in self._restore}
        TorchEncoder.image_batch = timed_batch("image", originals["image_batch"])
        TorchEncoder.text_batch = timed_batch("text", originals["text_batch"])
        TorchEncoder.encode_images = counted_items("images", originals["encode_images"])
        TorchEncoder.encode_texts = counted_items("texts", originals["encode_texts"])
        TorchEncoder.preprocess = timed("preprocess_s", originals["preprocess"])
        ClipTokenizer.__call__ = timed("tokenize_s", originals["__call__"])
        builder.build_dataset = timed("dataset_s", originals["build_dataset"])
        load_encoder = originals["_load_encoder"]
        cli._load_encoder = timed("load_s",
                                  lambda *a, **k: loads.append(1) or load_encoder(*a, **k))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._restore:
            setattr(owner, name, fn)

    def run(self, label, argv, batches, pretrained=None, batch_size=BATCH, fn=None):
        """``argv`` through the CLI (or ``fn()``), which must make ``batches``
        = (image, text) encoder batches. Returns its metrics."""
        from iterated_learning_for_vlm_tpu_torch.eval import cli

        counted, stats = self.counted, self.stats
        stats.update(images=0, texts=0, image_batches=0, text_batches=0, image_s=0.0,
                     text_s=0.0, load_s=0.0, dataset_s=0.0, tokenize_s=0.0, preprocess_s=0.0,
                     text_ctx={})
        self.loads.clear()
        sync()
        reset_counters(*counted.values())
        reset_routes()
        t0 = time.perf_counter()
        if fn is None:
            rec = cli.main(argv + ["--model_config", self.config, "--pretrained",
                                   pretrained or self.pretrained, "--batch_size",
                                   str(batch_size), "--sd_temperature", self.temperature,
                                   "--output", self.out])
            metrics = rec["metrics"]
        else:
            metrics = fn()
        sync()
        seconds = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counted.items()}
        check_routes(f"eval {label}")
        n = stats["image_batches"] + stats["text_batches"]
        want = {name: 0 for name in counted} | {"tiny_attention_fwd": 12 * n,
                                                 "codebook_pool_fwd": n}
        check(launches == want, f"eval {label}: launches {launches}, expected {want} for "
                                f"{n} encoder batches")
        check((stats["image_batches"], stats["text_batches"]) == batches,
              f"eval {label}: {stats['image_batches']} image and {stats['text_batches']} text "
              f"batches, expected {batches}")
        metrics_in_range(label, metrics)
        enc_s = stats["image_s"] + stats["text_s"]
        r = dict(stats, text_ctx=dict(stats["text_ctx"]), seconds=seconds,
                 launches={k: v for k, v in launches.items() if v},
                 images_per_s=stats["images"] / stats["image_s"] if stats["image_s"] else None,
                 texts_per_s=stats["texts"] / stats["text_s"] if stats["text_s"] else None,
                 host_share=1.0 - enc_s / seconds, models_loaded=len(self.loads),
                 metrics=metrics)
        self.row["runs"][label] = r
        for name in counted:
            self.total[name] += launches[name]
        rates = "".join(f", {stats[k]} {k} ({stats[f'{k[:-1]}_batches']} batches, "
                        f"{r[f'{k}_per_s']:.1f}/s through the encoder)"
                        for k in ("images", "texts") if stats[k])
        if stats["text_ctx"]:
            rates += f", text batches by context {dict(sorted(stats['text_ctx'].items()))}"
        host = {k[:-2]: stats[k] for k in ("load_s", "dataset_s", "tokenize_s", "preprocess_s")}
        host["other"] = seconds - enc_s - sum(host.values())
        r["host_s"] = host
        log(f"eval {label}: {seconds:.2f} s{rates}; host share {r['host_share']:.1%} (the "
            f"run's time outside the encoder's fenced batch calls: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in host.items())
            + f"); launches {r['launches']}; metrics {json.dumps(metrics)}")
        return metrics


def eval_phase(dev, counted, report, run_a, tmp):
    """Phase 13: the port's eval CLI (``eval.cli.main``) in-process on the card
    over phase 12's ``ckpt_8`` (and the soup of ``ckpt_5`` and ``ckpt_8``),
    then ``Solver.evaluate`` from ``ckpt_8``. Returns the launches of all its
    runs together, and what phase 14 reuses: the data root, the model's YAML
    config and the temperature."""
    from iterated_learning_for_vlm_tpu_torch.eval import builder, cli
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
    from iterated_learning_for_vlm_tpu_torch.eval.prompts import PROMPT_80
    from iterated_learning_for_vlm_tpu_torch.eval.model_loader import load_eval_encoder
    from iterated_learning_for_vlm_tpu_torch.models import model_entry
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    import yaml

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "eval")
    os.makedirs(root)
    with open(run_a["log"]) as f:
        temps = re.findall(r"Iter \[\d+/\d+\] .* T ([0-9.]+) ", f.read())
    check(bool(temps), "eval: no temperature in phase 12's log")
    temperature = temps[-1]
    config = os.path.join(root, "model.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"model": run_a["config"]["model"]}, f)
    t0 = time.perf_counter()
    eval_data(root)
    row = {"data_s": time.perf_counter() - t0, "sd_temperature": float(temperature), "runs": {}}
    log(f"eval: data written in {row['data_s']:.1f} s; the model block of phase 12 at T "
        f"{temperature} (phase 12's log) from {os.path.basename(run_a['ckpts'][1])}")

    out = os.path.join(root, "out", "{dataset}_{task}.json")
    ckpt_5, ckpt_8 = run_a["ckpts"]
    with EvalRuns(counted, row, config, temperature, out, ckpt_8) as ev:
        run = ev.run
        zs = run("zeroshot 1000 classes x 80 prompts",
                 ["eval", "--dataset", "wds/zs", "--dataset_root", f"{root}/zs", "--task",
                  "zeroshot_classification", "--template_set", "80"],
                 (-(-EVAL_CLASSES * EVAL_PER_CLASS // BATCH), EVAL_CLASSES * -(-80 // BATCH)))
        ret = run("retrieval 1000 images x 5 captions",
                  ["eval", "--dataset", f"retrieval_json:{root}/ret.json", "--dataset_root",
                   f"{root}/ret", "--recall_k", "1", "5", "10"],
                  (-(-RET_IMAGES // BATCH), -(-RET_IMAGES * len(RET_TEMPLATES) // BATCH)))
        probe_argv = ["eval", "--dataset", "wds/probe", "--dataset_root", f"{root}/probe",
                      "--task", "linear_probe", "--val_proportion", "0.2", "--feature_root",
                      f"{root}/features"]
        probe = run("linear probe 64 classes", probe_argv,
                    (-(-PROBE_CLASSES * PROBE_TRAIN // BATCH)
                     + -(-PROBE_CLASSES * PROBE_TEST // BATCH), 0))
        cached = run("linear probe --skip_load", probe_argv + ["--skip_load"], (0, 0))
        check(cached == probe and not row["runs"]["linear probe --skip_load"]["models_loaded"],
              "eval: --skip_load built a model or changed the probe's metrics")
        n_sc = SC_PER_SPLIT // SC_BATCH
        sugar = run("sugar_crepe", ["sugar_crepe", "--data_root", f"{root}/comp/eval",
                                    "--image_root", f"{root}/comp/eval/images"],
                    (SC_SPLITS * n_sc, 2 * SC_SPLITS * n_sc), batch_size=SC_BATCH)
        check(len(sugar) == SC_SPLITS + 1, f"eval: sugar_crepe scored {sorted(sugar)}")
        run("crepe", ["crepe", "--data_root", f"{root}/crepe", "--image_dirs", f"{root}/scenes",
                      "--complexities", "5"], (1, -(-6 * GROUP_ITEMS // BATCH)))
        run("cola", ["cola", "--json_path", f"{root}/cola.json", "--image_root",
                     f"{root}/scenes"], (1, 1))
        run("soup ckpt_5 + ckpt_8 zeroshot 64 classes",
            ["eval", "--dataset", "wds/probe", "--dataset_root", f"{root}/probe", "--task",
             "zeroshot_classification"], (1, PROBE_CLASSES), pretrained=f"{ckpt_5},{ckpt_8}")
        rows = cli.main(["build", os.path.join(root, "out"), "--output",
                         os.path.join(root, "results.csv")])
        check(len(rows) == 7, f"eval build: {len(rows)} rows, expected 7")
        log(f"eval build: {len(rows)} records into one CSV")

        # the soup against a model loaded with the mean of the two state dicts
        images = builder.build_dataset("wds/probe", root=f"{root}/probe").images
        soup = load_eval_encoder(config, [ckpt_5, ckpt_8], batch_size=BATCH,
                                 sd_temperature=float(temperature))
        sds = [torch.load(p, map_location="cpu", weights_only=True)["model"]
               for p in (ckpt_5, ckpt_8)]
        mean = {k: ((sds[0][k].double() + sds[1][k].double()) / 2).float() for k in sds[0]}
        ref = model_entry(Config(run_a["config"]).model, device=dev)
        ref.load_state_dict(mean)
        soup_equal = bool(np.array_equal(
            soup.encode_images(images),
            TorchEncoder(ref, batch_size=BATCH, sd_temperature=float(temperature))
            .encode_images(images)))
        log(f"eval soup: image embeddings of {len(images)} images equal to a model loaded "
            f"with the mean state dict: {soup_equal}")
        check(soup_equal, "eval: the soup's embeddings differ from the mean state dict's")

        # the device's share of the classifier's text batches (80 prompts a class)
        from torch.profiler import ProfilerActivity, profile

        with open(f"{root}/zs/classnames.txt") as f:
            names = f.read().split("\n")[:10]
        soup.encode_texts([t.format(names[0]) for t in PROMPT_80])
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for name in names:
                soup.encode_texts([t.format(name) for t in PROMPT_80])
            sync()
        device_ms = sum(getattr(e, "self_device_time_total", 0) for e in
                        prof.key_averages()) / 1e3 / len(names)
        fenced_ms = 1e3 * row["runs"]["zeroshot 1000 classes x 80 prompts"]["text_s"] / EVAL_CLASSES
        row["classifier_text_batch"] = {"device_ms": device_ms, "fenced_ms": fenced_ms,
                                        "device_share": device_ms / fenced_ms}
        log(f"eval profile: a class's 80 prompts (one text batch at batch 256) take "
            f"{device_ms:.3f} ms of device time (torch.profiler over {len(names)} classes) "
            f"against {fenced_ms:.3f} ms in the zero-shot run's fenced batch calls: the device "
            f"is busy {device_ms / fenced_ms:.1%} of that time")
        del soup, ref, sds, mean
        gc.collect()
        torch.cuda.empty_cache()

        # the Solver's SugarCREPE hook from ckpt_8 against the CLI, bit for bit
        hcfg = Config(run_a["config"])
        hcfg["data"] = {"train": {"synthetic": True, "batch_size": BATCH, "num_batches": 8},
                        "test": {"sc_data_root": f"{root}/comp/eval",
                                 "sc_image_root": f"{root}/comp/eval/images"}}
        solver = Solver(hcfg, output_path=os.path.join(root, "hook"), exp_name="hook",
                        ckpt_path=ckpt_8, device=dev)
        before = {n: p.detach().clone() for n, p in solver.params.items()}
        hook = run("Solver.evaluate(8)", None, (SC_SPLITS * n_sc, 2 * SC_SPLITS * n_sc),
                   fn=lambda: solver.evaluate(8))
        same = hook == sugar
        untouched = all(torch.equal(p, before[n]) for n, p in solver.params.items())
        log(f"eval hook: Solver.evaluate(8) equals the CLI's sugar_crepe bit for bit: {same}; "
            f"parameters untouched bit for bit: {untouched}; train mode after: "
            f"{solver.model.training}")
        check(same and untouched and solver.model.training,
              "eval: the Solver's hook differs from the CLI or changed the model")
        del solver, before
    total = ev.total
    gc.collect()
    torch.cuda.empty_cache()
    text_ctx = {}
    for r in row["runs"].values():
        for ctx, n in r["text_ctx"].items():
            text_ctx[ctx] = text_ctx.get(ctx, 0) + n
    row.update(seconds=time.perf_counter() - t_phase, launches=total, zeroshot=zs,
               retrieval=ret, text_ctx=text_ctx,
               image_batches=sum(r["image_batches"] for r in row["runs"].values()))
    log(f"eval: phase 13 in {row['seconds']:.1f} s; launches of its runs {total}; encoder "
        f"batches: {row['image_batches']} image (S=50, T=49), text by context {text_ctx}")
    report["eval"] = row
    return total, {"root": root, "config": config, "temperature": temperature}


# -- phase 14: caption tasks, clip_fdt_vitb16, attention maps, the visualizer --------
SELECT_IMAGES = 1000  # the retrieval set's size, each with one swapped-attribute negative
VIZ_BATCHES, VIZ_TOPK, VIZ_CODES = 8, 8, 32
# one clip_fdt_vitb16 train step on its kernel routes: K3 in the 12 image-tower
# layers (S=197), K2 in the 12 text-tower layers, K1 in both heads (T=196 and 32)
B16_TRAIN_LAUNCHES = {"tiny_attention_fwd": 12, "tiny_attention_bwd": 12,
                      "codebook_pool_fwd": 2, "codebook_pool_bwd_dq": 2,
                      "codebook_pool_bwd_dsd": 2, "flash_attention_fwd": 12,
                      "flash_attention_bwd": 12}
# serving 256 images and 256 texts at ctx 32 and at ctx 77
B16_SERVE_LAUNCHES = {name: 0 for name in TRAIN_LAUNCHES} | {
    "flash_attention_fwd": 12, "tiny_attention_fwd": 24, "codebook_pool_fwd": 3}
B16_TRAIN_STEPS = 3


def b16_config(kernels: bool) -> dict:
    """``clip_fdt_vitb16`` at full width: phase 4's model block with the type
    changed. Its image tower has S=197, past K2's 128, so the kernel routes
    add ``image_encode: {use_flash: true}``: vision attention on K3, text
    attention on K2, both heads on K1. ``kernels=False`` is the plain path."""
    cfg = model_config(kernels)
    cfg["type"] = "clip_fdt_vitb16"
    if kernels:
        cfg["kwargs"]["image_encode"]["use_flash"] = True
    return cfg


def selection_data(root: str) -> str:
    """1000 coloured-shape scenes (224 px), each with its true caption first and
    one swapped-attribute negative (``data/compositional.py:negative_pair``,
    colour and shape in turn), as a retrieval JSON; returns its path."""
    from PIL import Image

    from iterated_learning_for_vlm_tpu_torch.data import compositional as comp

    def caption(pair):
        return comp.caption_for(comp.COLOR_NAMES[pair[0]], comp.SHAPES[pair[1]])

    pairs = comp.seen_pairs() + comp.unseen_pairs()
    rng = np.random.default_rng((SEED, 15))
    os.makedirs(f"{root}/select")
    items = []
    for k in range(SELECT_IMAGES):
        c, s = pairs[k % len(pairs)]
        Image.fromarray(comp.to_uint8(comp.draw(c, s, 224, rng))).save(
            f"{root}/select/{k}.jpg", quality=92)
        neg = comp.negative_pair(c, s, ("color", "shape")[k % 2], rng)
        items.append({"image": f"{k}.jpg", "captions": [caption((c, s)), caption(neg)]})
    with open(f"{root}/select.json", "w") as f:
        json.dump(items, f)
    return f"{root}/select.json"


def counted_run(counted, label, fn, expected=None):
    """``fn()`` with the launch and plain-route counters reset just before and
    read just after; requires ``expected`` launches when given. Returns
    (result, launches, seconds on the host clock)."""
    sync()
    reset_counters(*counted.values())
    reset_routes()
    t0 = time.perf_counter()
    out = fn()
    sync()
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counted.items()}
    check_routes(label)
    if expected is not None:
        check(launches == expected, f"{label}: launches {launches}, expected {expected}")
    return out, launches, seconds


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] += n


def b16_phase(dev, counted, report, smi, total):
    """Phase 14b: ``clip_fdt_vitb16`` at full width, kernel routes against the
    plain path from the same weights: serving 256 images and texts, then
    ``B16_TRAIN_STEPS`` train steps at bs 256, ctx 32 (the first against the
    plain path's step). Returns the kernel-route model, for the attention
    maps."""
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
    from iterated_learning_for_vlm_tpu_torch.models import model_entry
    from torch.profiler import ProfilerActivity, profile

    row = {}
    model = model_entry(b16_config(True), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    plain = model_entry(b16_config(False), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    plain.load_state_dict(model.state_dict())
    check(tuple(model.visual.positional_embedding.shape) == (197, 768)
          and model.visual.transformer.resblocks[0].attn.use_flash
          and not model.encode_text.transformer.resblocks[0].attn.use_flash,
          "B/16: the image tower is not ViT-B/16 on the flash route")
    enc = TorchEncoder(model, batch_size=BATCH, text_buckets=(16, 32),
                       sd_temperature=SD_TEMPERATURE)
    enc_plain = TorchEncoder(plain, batch_size=BATCH, text_buckets=(16, 32),
                             sd_temperature=SD_TEMPERATURE)
    rng = np.random.default_rng((SEED, 16))
    images = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
    tok32, pad32 = make_texts(rng, BATCH, 77, 32)
    tok77, pad77 = make_texts(rng, BATCH, 77, 77)

    def serve(e):
        return (e.encode_images(images), e.encode_texts_tokens(tok32, pad32),
                e.encode_texts_tokens(tok77, pad77))

    serve(enc)  # first call: library set-up, outside the counted run
    outs, launches, _ = counted_run(counted, "B/16 serve", lambda: serve(enc),
                                    B16_SERVE_LAUNCHES)
    add_launches(total, launches)
    row["serve_launches"] = launches
    log(f"B/16 serve: {BATCH} images (S=197, T=196) + {BATCH} texts @ctx32 + {BATCH} texts "
        f"@ctx77; launches {launches}")
    for name, got, ref in zip(("image", "text_ctx32", "text_ctx77"), outs, serve(enc_plain)):
        check(got.shape == (BATCH, 512) and bool(np.isfinite(got).all()),
              f"B/16 {name} embeddings are malformed")
        norm_err = float(np.abs(np.linalg.norm(got, axis=-1) - 1).max())
        cos = float(cosines(got, ref).min())
        row[name] = {"min_cos_vs_plain": cos, "max_norm_err": norm_err}
        log(f"B/16 serve {name}: finite, |norm-1| max {norm_err:.2e} (tol {NORM_ATOL}), min "
            f"cosine vs plain path {cos:.6f} (bound {EMBED_MIN_COS})")
        check(norm_err <= NORM_ATOL and cos >= EMBED_MIN_COS,
              f"B/16 {name} embeddings disagree with the plain path")
    x_img = torch.from_numpy(images).to(dev)
    t32, p32 = (torch.from_numpy(a[:, :32]).to(dev) for a in (tok32, pad32))
    t77, p77 = (torch.from_numpy(a).to(dev) for a in (tok77, pad77))
    timing = {}
    for name, fast_fn, plain_fn in (
            ("image", lambda: enc.image_batch(x_img), lambda: enc_plain.image_batch(x_img)),
            ("text_ctx32", lambda: enc.text_batch(t32, p32),
             lambda: enc_plain.text_batch(t32, p32)),
            ("text_ctx77", lambda: enc.text_batch(t77, p77),
             lambda: enc_plain.text_batch(t77, p77))):
        plain_ms, ms = paired_ms(plain_fn, fast_fn, iters=5)
        timing[name] = {"ms": ms, "plain_ms": plain_ms, "embeds_per_s": BATCH / ms * 1e3,
                        "plain_embeds_per_s": BATCH / plain_ms * 1e3}
        log(f"timing B/16 {name} bs{BATCH}: kernel routes {ms:.3f} ms "
            f"({timing[name]['embeds_per_s']:.1f} embeds/s), plain path {plain_ms:.3f} ms "
            f"({timing[name]['plain_embeds_per_s']:.1f} embeds/s) [{smi}]")
    row["serve_timing"] = timing
    del enc, enc_plain, x_img, t77, p77

    batch32 = train_batch(dev, rng, 32)
    step_launches, row["train_step"], (state_k, step_k), (state_p, step_p) = train_phase(
        model, plain, batch32, counted, B16_TRAIN_LAUNCHES, label="CLIP-FDT B/16 train step")
    add_launches(total, step_launches)
    del state_p, step_p, plain
    gc.collect()  # the plain path's blocks stay in the allocator's cache for these steps
    events = [torch.cuda.Event(enable_timing=True) for _ in range(B16_TRAIN_STEPS)]

    def steps():
        events[0].record()
        losses = []
        for event in events[1:]:
            losses.append(step_k(state_k, batch32, TRAIN_TEMPERATURE)["loss"])
            event.record()
        return [x.item() for x in losses]

    want = {k: (B16_TRAIN_STEPS - 1) * v for k, v in B16_TRAIN_LAUNCHES.items()}
    (losses, _, _), launches = traced_launches(
        lambda: counted_run(counted, "B/16 train steps", steps, want))
    check(launches == want, f"B/16 train steps: kernels in the trace {launches}, "
                            f"expected {want}")
    add_launches(total, launches)
    check(all(np.isfinite(losses)), f"B/16 train losses {losses} are not finite")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    ms = sum(step_ms) / len(step_ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_k(state_k, batch32, TRAIN_TEMPERATURE)
        sync()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    shares = {}
    for key, pattern in (("k3", "flash_attention"), ("k1", "codebook_pool"),
                         ("k2", "tiny_attention")):
        shares[key] = sum(e.self_device_time_total for e in kernels if pattern in e.key) / 1e3
    row["train_timing"] = {"ms": ms, "step_ms": step_ms, "pairs_per_s": BATCH / ms * 1e3,
                           "losses": losses,
                           "launches_steps_2_3": launches, "device_ms": device_ms,
                           "kernel_ms": shares}
    log(f"timing CLIP-FDT B/16 train steps 2-{B16_TRAIN_STEPS} bs{BATCH} ctx32 (kernel "
        f"routes, CUDA events): {ms:.3f} ms a step ({BATCH / ms * 1e3:.1f} pairs/s; each "
        f"{[round(t, 3) for t in step_ms]} ms); launches "
        f"{launches}; losses {[round(x, 5) for x in losses]} [{smi}]")
    log(f"profile CLIP-FDT B/16 train step ctx32 (one more step): {device_ms:.3f} ms of device "
        f"time; K3 {shares['k3']:.3f} ms, K1 {shares['k1']:.3f} ms, K2 {shares['k2']:.3f} ms\n"
        + events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=60))
    report["b16"] = row
    del state_k, step_k, batch32, prof
    gc.collect()
    torch.cuda.empty_cache()
    return model


def attention_maps_phase(dev, counted, report, b16_model):
    """Phase 14c: ``return_attn`` and the token features on the card, on a
    ``clip_vitb32_auxilary`` with phase 9's CLIP weights (the K2 route) and on
    the B/16 CLIP-FDT: the maps come from the plain path (nothing launched,
    no plain route counted), each row sums to 1, and the embeddings match the
    kernel routes' call."""
    from iterated_learning_for_vlm_tpu_torch.models import model_entry

    rng = np.random.default_rng((SEED, 17))
    aux = model_entry(clip_config("k2", "clip_vitb32_auxilary"), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    x = torch.from_numpy(rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)).to(dev)
    tok, pad = (torch.from_numpy(a).to(dev) for a in make_texts(rng, BATCH, 77, 77))
    rows = {}
    for name, model in (("CLIP B/32 auxilary", aux), ("CLIP-FDT B/16", b16_model)):
        model.eval()
        with torch.inference_mode():
            ref_v, ref_t = model.visual(x)["embed"], model.encode_text(tok, pad)["embed"]
            (vis, txt), launches, _ = counted_run(
                counted, f"attention maps {name}",
                lambda: (model.visual(x, return_attn=True),
                         model.encode_text(tok, pad, return_attn=True)),
                {k: 0 for k in counted})
            patch = model.extract_patch_ft(x)
            word, mask = model.extract_word_ft(tok[:, :32], pad[:, :32])
        grid = model.vision_cfg.input_resolution // model.vision_cfg.patch_size
        s = grid * grid + 1
        aw, tw = vis["attn_weights"], txt["attn_weights"]
        check(aw.shape == (12, BATCH, s, s) and tw.shape == (12, BATCH, 77, 77)
              and vis["cls_attn"].shape == (12, BATCH, s), f"{name}: attention map shapes")
        row_err = max((w.sum(-1) - 1).abs().max().item() for w in (aw, tw))
        cos = min(torch.nn.functional.cosine_similarity(a.float(), b["embed"].float(), dim=-1)
                  .min().item() for a, b in ((ref_v, vis), (ref_t, txt)))
        feats_ok = (patch.shape[:2] == (BATCH, s - 1) and word.shape[:2] == (BATCH, 32)
                    and mask is not None and bool(torch.isfinite(patch).all())
                    and bool(torch.isfinite(word).all()))
        rows[name] = {"attn_shape": list(aw.shape), "max_row_sum_err": row_err,
                      "min_embed_cos_vs_kernel_route": cos, "patch_ft": list(patch.shape),
                      "word_ft": list(word.shape)}
        log(f"attention maps {name}: attn_weights {list(aw.shape)} / text {list(tw.shape)} "
            f"fp32 on the plain path, launches {launches} (none), rows sum to 1 within "
            f"{row_err:.2e} (tol 1e-3); embed min cosine vs the kernel routes {cos:.6f} (bound "
            f"{EMBED_MIN_COS}); extract_patch_ft {list(patch.shape)}, extract_word_ft "
            f"{list(word.shape)}, finite {feats_ok}")
        check(row_err <= 1e-3 and cos >= EMBED_MIN_COS and feats_ok
              and torch.equal(vis["cls_attn"], aw[:, :, 0, :]),
              f"attention maps {name} are malformed or disagree with the kernel routes")
        del vis, txt, aw, tw, patch, word
    report["attention_maps"] = rows
    del aux, x
    gc.collect()
    torch.cuda.empty_cache()


def viz_phase(dev, counted, report, run_a, ev_info, tmp, total):
    """Phase 14d: the port's ``tools/run_codebook_viz.py`` over phase 12's
    ``ckpt_8`` and shards; the pooled logits of the kernel call against the
    plain ``return_token_att`` call; ``tools/inference.py:dump_features``
    against ``TorchEncoder`` bit for bit."""
    from PIL import Image

    from iterated_learning_for_vlm_tpu_torch.data.pipeline import get_unshuffled_wds_dataset
    from iterated_learning_for_vlm_tpu_torch.eval.model_loader import load_eval_encoder
    from iterated_learning_for_vlm_tpu_torch.models.sparsemax import sparsemax_bisect
    from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb
    from iterated_learning_for_vlm_tpu_torch.tools import inference, run_codebook_viz

    import yaml

    row = {}
    ckpt_8 = run_a["ckpts"][1]
    train = run_a["config"]["data"]["train"]
    check("data_path" in train, "viz: phase 12 ran on synthetic data, no shards to sweep")
    cfg_path = os.path.join(tmp, "viz.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(run_a["config"], f)
    out = os.path.join(tmp, "code_viz")
    # per batch: the token maps (12 K2-fwd), the pooled weights (12 K2-fwd, 1
    # K1-fwd) and the captions (12 K2-fwd, 1 K1-fwd)
    want = {name: 0 for name in counted} | {"tiny_attention_fwd": 36 * VIZ_BATCHES,
                                             "codebook_pool_fwd": 2 * VIZ_BATCHES}
    wrote, launches, seconds = counted_run(
        counted, "codebook viz", lambda: run_codebook_viz.run(
            ["--config", cfg_path, "--ckpt", ckpt_8, "--out", out, "--batches",
             str(VIZ_BATCHES), "--topk", str(VIZ_TOPK), "--max_codes", str(VIZ_CODES)]), want)
    add_launches(total, launches)
    with open(wrote["text_codes"]) as f:
        codes = json.load(f)
    grids_ok = all(os.path.getsize(p) > 0 and Image.open(p).size[0] > 0 for p in wrote["grids"])
    row["viz"] = {"seconds": seconds, "grids": len(wrote["grids"]), "text_codes": len(codes),
                  "launches": {k: v for k, v in launches.items() if v}}
    log(f"viz: run_codebook_viz over {os.path.basename(ckpt_8)}: {VIZ_BATCHES} batches of "
        f"{train['batch_size']} from phase 12's shards, --topk {VIZ_TOPK}, --max_codes "
        f"{VIZ_CODES}: rendered {len(wrote['grids'])} PNG grids and text_codes.json with "
        f"{len(codes)} codes in {seconds:.2f} s; launches {row['viz']['launches']}")
    check(0 < len(wrote["grids"]) <= VIZ_CODES and grids_ok and codes,
          "viz: no grid or caption codes written")

    # the kernel call's pooled logits and weights against the plain token maps
    enc = load_eval_encoder(cfg_path, ckpt_8, batch_size=BATCH, device=dev)
    model = enc.model
    temp = model.fdt_cfg.sd_temperature
    dcfg = dict(train, workers=0, wire_dtype="float32")
    x = torch.from_numpy(next(iter(get_unshuffled_wds_dataset(dcfg).dataloader))["image"]).to(dev)
    with torch.inference_mode():
        token_att, _ = model.extract_img_sd_ft(x, return_token_att=True)
        weights, _ = model.extract_img_sd_ft(x)
        q = model.img_query_model.q_map(model._patches(x).to(model.dtype))
        pooled = cb.codebook_pool_fwd(q.contiguous(), model.space_dict.to(q.dtype).contiguous(),
                                      None, temp)[0]
    # an image's token maps are the unscaled q.sd products (no pad mask to apply)
    ref = token_att.amax(dim=1) * model.fdt_cfg.sd_dim ** -0.5 / temp
    err = (pooled - ref).abs()
    bound = POOL_ATOL + POOL_RTOL * ref.abs()
    w_err = (weights - sparsemax_bisect(ref)).abs().max().item()
    w_tol = 2 * bound.max().item()
    row["pooled"] = {"max_abs_err": err.max().item(), "weights_max_abs_err": w_err,
                     "weights_tol": w_tol}
    log(f"viz: pooled logits of the kernel call vs the plain return_token_att call at T=49, "
        f"T {temp}: max abs err {err.max().item():.3e} (tol {POOL_ATOL} + {POOL_RTOL}*|ref|); "
        f"the weights {w_err:.3e} (tol {w_tol:.3e}: sparsemax moves a weight by at most twice "
        f"the largest logit change)")
    check(bool(torch.all(err <= bound)) and w_err <= w_tol,
          "viz: the kernel's pooled weights disagree with the plain token maps")
    del token_att, weights, q, pooled, ref, x

    # the feature dump against the encoder, bit for bit
    root = ev_info["root"]
    enc = load_eval_encoder(ev_info["config"], ckpt_8, batch_size=BATCH,
                            sd_temperature=float(ev_info["temperature"]), device=dev)
    with open(f"{root}/ret.json") as f:
        items = json.load(f)[:BATCH]
    images = [Image.open(f"{root}/ret/{it['image']}").convert("RGB") for it in items]
    texts = [it["captions"][0] for it in items]
    path, launches, seconds = counted_run(
        counted, "feature dump",
        lambda: inference.dump_features(enc, images, texts, os.path.join(tmp, "features.npz")),
        {name: 0 for name in counted} | {"tiny_attention_fwd": 24, "codebook_pool_fwd": 2})
    add_launches(total, launches)
    z = np.load(path)
    same = (np.array_equal(z["image_embeds"], enc.encode_images(images))
            and np.array_equal(z["text_embeds"], enc.encode_texts(texts)))
    row["dump"] = {"seconds": seconds, "equal": same}
    log(f"viz: dump_features of {BATCH} images and {BATCH} captions in {seconds:.2f} s: the "
        f".npz equals TorchEncoder's outputs bit for bit: {same}")
    check(same, "viz: the feature dump differs from the encoder's outputs")
    report["viz"] = row
    del enc, model
    gc.collect()
    torch.cuda.empty_cache()


def hf_phase(dev, report, tmp):
    """Phase 14e: ``--model_type ja_clip`` through ``eval.cli.main`` on the card
    over a tiny rinna-shaped HF directory built offline, when ``transformers``
    is installed."""
    if importlib.util.find_spec("transformers") is None:
        log("hf_adapter: not run (transformers not installed)")
        report["hf_adapter"] = None
        return
    from transformers import (
        BertConfig, BertTokenizer, CLIPImageProcessor, CLIPVisionConfig,
        VisionTextDualEncoderConfig, VisionTextDualEncoderModel,
    )

    from iterated_learning_for_vlm_tpu_torch.eval import cli

    torch.manual_seed(SEED)
    d = os.path.join(tmp, "hf_ja_clip")
    vision = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                              num_attention_heads=2, image_size=32, patch_size=16)
    text = BertConfig(vocab_size=32, hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)
    VisionTextDualEncoderModel(VisionTextDualEncoderConfig.from_vision_text_configs(
        vision, text, projection_dim=16)).save_pretrained(d)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "dog",
                           "photo", "of", "the", "##s"]))
    BertTokenizer(os.path.join(d, "vocab.txt")).save_pretrained(d)
    CLIPImageProcessor(size={"shortest_edge": 32},
                       crop_size={"height": 32, "width": 32}).save_pretrained(d)
    loaded = []
    load_encoder = cli._load_encoder
    cli._load_encoder = lambda *a, **k: loaded.append(load_encoder(*a, **k)) or loaded[-1]
    try:
        t0 = time.perf_counter()
        rec = cli.main(["eval", "--model_type", "ja_clip", "--pretrained", d, "--dataset",
                        "dummy", "--batch_size", "8", "--quiet"])
        seconds = time.perf_counter() - t0
    finally:
        cli._load_encoder = load_encoder
    on_card = bool(loaded) and all(p.device.type == "cuda"
                                   for p in loaded[0].model.parameters())
    report["hf_adapter"] = {"seconds": seconds, "metrics": rec["metrics"], "on_card": on_card}
    log(f"hf_adapter: --model_type ja_clip through eval.cli.main in {seconds:.2f} s: metrics "
        f"{json.dumps(rec['metrics'])}; parameters on the card: {on_card}")
    check(on_card, "hf_adapter: the HF model's parameters are not on the card")
    metrics_in_range("hf_adapter", rec["metrics"])


def phase14(dev, counted, report, run_a, ev_info, tmp, smi):
    """Phase 14: the caption tasks over phase 12's ``ckpt_8``, ``clip_fdt_vitb16``
    at full width, the attention maps and token features, the codebook
    visualizer and the feature dump, and the HF adapter. Returns the launches
    of its driven runs together."""
    t_phase = time.perf_counter()
    total = {name: 0 for name in counted}
    root = ev_info["root"]
    t0 = time.perf_counter()
    select = selection_data(root)
    row = {"data_s": time.perf_counter() - t0, "runs": {}}
    log(f"captions: {SELECT_IMAGES} selection scenes written in {row['data_s']:.1f} s")
    out = os.path.join(root, "out14", "{dataset}_{task}.json")
    with EvalRuns(counted, row, ev_info["config"], ev_info["temperature"], out,
                  run_a["ckpts"][1]) as ev:
        sel = ev.run(f"image_caption_selection {SELECT_IMAGES} images x 2 captions",
                     ["eval", "--dataset", f"retrieval_json:{select}", "--dataset_root",
                      f"{root}/select", "--task", "image_caption_selection"],
                     (-(-SELECT_IMAGES // BATCH), -(-2 * SELECT_IMAGES // BATCH)))
        cap = ev.run(f"captioning {RET_IMAGES} images x {len(RET_TEMPLATES)} captions",
                     ["eval", "--dataset", f"retrieval_json:{root}/ret.json", "--dataset_root",
                      f"{root}/ret", "--task", "captioning"],
                     (-(-RET_IMAGES // BATCH), -(-RET_IMAGES * len(RET_TEMPLATES) // BATCH)))
    check(set(sel) == {"acc"} and set(cap) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                                                  "ROUGE_L", "CIDEr"},
          f"captions: metrics {sorted(sel)} / {sorted(cap)}")
    add_launches(total, ev.total)
    report["captions_eval"] = row
    gc.collect()
    torch.cuda.empty_cache()

    b16_model = b16_phase(dev, counted, report, smi, total)
    attention_maps_phase(dev, counted, report, b16_model)
    del b16_model
    gc.collect()
    torch.cuda.empty_cache()
    viz_phase(dev, counted, report, run_a, ev_info, tmp, total)
    hf_phase(dev, report, tmp)
    report["phase14"] = {"seconds": time.perf_counter() - t_phase, "launches": total}
    log(f"phase 14 in {report['phase14']['seconds']:.1f} s; launches of its driven runs {total}")
    return total


# -- phase 15: data parallel on the card --------------------------------------------
DDP_STEPS = 6  # IL reset at 4 (reset_steps 2), the codebook held through 5, window end at 6
DDP_SAVE = 4
DDP_WORLD1_STEPS = 2
DDP_LAUNCH_S = 300  # one launch's time limit; every rank's process is killed after it
# parameters the FDT forward never reads, by their port names: no gradient on either side
UNREAD_NAMES = ("visual.ln_post.weight", "visual.ln_post.bias", "visual.proj",
                "encode_text.text_projection.weight", "encode_text.text_projection.bias",
                "logit_scale_sd")
DDP_LOSS_RTOL = 2e-3


def ddp_config(train: dict, steps: int = DDP_STEPS) -> dict:
    """Phase 15's config: phase 12's :func:`pipeline_config` over its shards,
    ``steps`` steps, saves at 4 and at the end, and the IL schedule with
    ``reset_steps`` 2, ``smooth_steps`` 1 and 3 resets: the text tower is
    redrawn after step 4 (the first step that schedule can reset at), the
    codebook is held and the vision tower frozen through step 5, and the
    window closes at 6. ``batch_size`` is a rank's (128: 256 over two ranks)."""
    cfg = pipeline_config(dict(train, batch_size=BATCH // 2))
    cfg["lr_scheduler"]["kwargs"]["max_iter"] = steps
    cfg["saver"] = {"print_freq": 1, "val_freq": 0, "save_freq": DDP_SAVE}
    cfg["reset"] = {"enable": True, "reset_steps": 2, "reset_nums": 3, "smooth_steps": 1,
                    "semantics": "reference"}
    return cfg


def params_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_job(spec_path: str) -> int:
    """A phase-15 child: one rank (under ``torch.distributed.run``) or the one
    process of a run without a group. ``spec["job"]``: ``train`` runs the
    port's training launcher (``cli_entry.train_main(spec["argv"])``) with
    spies on its Solver (each step fenced: its context, this rank's longest
    caption, its loss, its launches and plain routes and its host ms; the
    parameters' digest after step ``DDP_SAVE`` and at the end; the
    checkpoint files this rank wrote; with ``capture`` the first step's batch
    and averaged gradients, for the one-process comparison); ``eval`` joins
    the group and runs the eval CLI with ``--distributed`` once for each
    ``spec["runs"]`` entry. The record goes to ``spec["out"]/rank<r>.json``."""
    sys.path.insert(0, str(REPO))
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb
    from iterated_learning_for_vlm_tpu_torch.ops import flash_attention as fl
    from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

    counted = {"tiny_attention_fwd": fa.tiny_attention_fwd,
               "tiny_attention_bwd": fa.tiny_attention_bwd,
               "codebook_pool_fwd": cb.codebook_pool_fwd,
               "codebook_pool_bwd_dq": cb.codebook_pool_bwd_dq,
               "codebook_pool_bwd_dsd": cb.codebook_pool_bwd_dsd,
               "flash_attention_fwd": fl.flash_attention_fwd,
               "flash_attention_bwd": fl.flash_attention_bwd}

    def counts():
        return {name: fn.launches for name, fn in counted.items()}

    def plain_routes():
        return sum(fn.plain_routes for fn in route_counters())

    rank = int(os.environ.get("RANK", 0))
    rec = {"rank": rank, "world": int(os.environ.get("WORLD_SIZE", 1)), "steps": {}}
    if spec["job"] == "train":
        from iterated_learning_for_vlm_tpu_torch import cli_entry
        from iterated_learning_for_vlm_tpu_torch.train import checkpoint as ckpt
        from iterated_learning_for_vlm_tpu_torch.train import solver as solver_mod

        base = solver_mod.Solver

        class Spied(base):
            def train(self):
                step_fn, on_step = self.train_step, self.il.on_step

                def spy_step(state, batch, temperature):
                    step = state.step + 1
                    sync()
                    before, routes = counts(), plain_routes()
                    t0 = time.perf_counter()
                    metrics = step_fn(state, batch, temperature)
                    sync()
                    ms = 1e3 * (time.perf_counter() - t0)
                    after = counts()
                    rec["steps"][step] = {
                        "ms": ms, "ctx": batch["tokens"].shape[1],
                        "local_len": int((batch["pad_mask"] == 0).sum(1).max()),
                        "loss": metrics["loss"].item(),
                        "launches": {k: after[k] - before[k] for k in after},
                        "plain_routes": plain_routes() - routes}
                    if spec.get("capture") and step == 1:
                        torch.save({k: v.cpu() for k, v in batch.items()},
                                   os.path.join(spec["out"], f"batch{rank}.pt"))
                        if rank == 0:
                            torch.save({n: None if p.grad is None else p.grad.cpu()
                                        for n, p in self.params.items()},
                                       os.path.join(spec["out"], "grads.pt"))
                    return metrics

                def spy_il(state, step):
                    state = on_step(state, step)
                    if step == DDP_SAVE:
                        rec["digest_after_reset"] = params_digest(self.params)
                    return state

                self.train_step, self.il.on_step = spy_step, spy_il
                rec["grad_bytes"] = sum(p.numel() * p.element_size()
                                        for p in self.model.parameters() if p.requires_grad)
                rec["wrapped"] = type(self.train_model).__name__
                rec["device"] = str(self.device)
                reset_counters(*counted.values())
                reset_routes()
                t0 = time.perf_counter()
                state = super().train()
                rec["train_s"] = time.perf_counter() - t0
                rec["launches"] = counts()
                rec["plain_routes"] = plain_routes()
                rec["digest_end"] = params_digest(self.params)
                rec["found"] = ckpt.find_last_checkpoint(self.save_path)
                return state

        writes = []
        write = ckpt._write

        def spy_write(payload, targets):
            writes.extend(targets)
            return write(payload, targets)

        solver_mod.Solver, ckpt._write = Spied, spy_write
        try:
            cli_entry.train_main(spec["argv"])
        finally:
            solver_mod.Solver, ckpt._write = base, write
        rec["writes"] = writes
    else:  # eval: every run through the CLI in one group
        import contextlib
        import io

        from iterated_learning_for_vlm_tpu_torch.eval import cli
        from iterated_learning_for_vlm_tpu_torch.parallel import mesh

        mesh.init_data_parallel("gloo")
        rec["runs"] = {}
        dump = json.dump
        for label, argv in spec["runs"].items():
            dumps = []
            json.dump = lambda *a, _d=dumps, **k: (_d.append(1), dump(*a, **k))[1]
            out = io.StringIO()
            sync()
            reset_counters(*counted.values())
            reset_routes()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    result = cli.main(argv)
            finally:
                json.dump = dump
            sync()
            rec["runs"][label] = {"seconds": time.perf_counter() - t0, "launches": counts(),
                                  "plain_routes": plain_routes(), "metrics": result["metrics"],
                                  "printed": out.getvalue(), "dumps": len(dumps)}
        import torch.distributed as dist

        dist.destroy_process_group()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def launch(label: str, spec: dict, nproc: int = 0):
    """Run :func:`rank_job` on ``spec``: under ``python -m torch.distributed.run
    --nproc_per_node nproc`` (``nproc`` > 0), else as one plain process.
    Fails the phase when any rank fails or the launch outlasts its limit;
    returns each rank's record and the launch's seconds."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(nproc)] if nproc else [sys.executable])
    t0 = time.perf_counter()
    proc = subprocess.Popen(head + [str(REPO / "chip_smoke.py"), "--rank-job", path], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DDP_LAUNCH_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        check(False, f"ddp {label}: the launch outlasted {DDP_LAUNCH_S} s:\n{out[-4000:]}")
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"ddp {label}: a rank failed (exit {proc.returncode}):\n"
                                f"{out[-6000:]}")
    recs = []
    for r in range(max(1, nproc)):
        with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, seconds


def check_train_ranks(label: str, recs, steps) -> None:
    """Every rank: the train step's launches each step, no plain route, no K3;
    the ranks' contexts, losses and parameter digests equal; each step's
    context the bucket of the longest caption of all ranks."""
    from iterated_learning_for_vlm_tpu_torch.data.pipeline import _bucket_for_len

    for r in recs:
        check(sorted(r["steps"], key=int) == [str(s) for s in steps],
              f"ddp {label}: rank {r['rank']} ran steps {sorted(r['steps'], key=int)}")
        for s, st in r["steps"].items():
            check(st["launches"] == TRAIN_LAUNCHES | {"flash_attention_fwd": 0,
                                                      "flash_attention_bwd": 0}
                  and st["plain_routes"] == 0,
                  f"ddp {label}: rank {r['rank']} step {s} launched {st['launches']}, "
                  f"{st['plain_routes']} plain routes")
    for s in map(str, steps):
        lens = [r["steps"][s]["local_len"] for r in recs]
        want = _bucket_for_len(max(lens), 77, (32, 77)) or 77
        ctxs = [r["steps"][s]["ctx"] for r in recs]
        check(ctxs == [want] * len(recs), f"ddp {label}: step {s} ran at contexts {ctxs}, "
                                          f"expected {want} (longest captions {lens})")
        losses = [r["steps"][s]["loss"] for r in recs]
        check(len(set(losses)) == 1, f"ddp {label}: step {s} losses differ {losses}")
    check(len({r["digest_end"] for r in recs}) == 1,
          f"ddp {label}: the ranks' final parameters differ")


def phase15(dev, report, run_a, ev_info, tmp, smi):
    """Phase 15: data parallel on the card, every rank launched as a user
    launches it. (a) two ranks sharing ``cuda:0`` over Gloo (NCCL refuses two
    ranks on one device) train phase 12's config from its shards through
    ``cli_entry --multihost``, 128 rows a rank, synced context buckets, the
    IL reset after step 4 and saves at 4 and 6, then two new ranks resume
    from ``ckpt_4``; (b) run A's first step against one process's step on
    the same 256 rows and weights; (c) a world of one under NCCL against the
    Solver with no group, 2 steps at 256; (d) the eval CLI's ``--distributed``
    on two ranks over phase 12's ``ckpt_8``, against phase 13's records.
    Returns rank 0's launches in run A."""
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    import yaml

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(tmp, "ddp")
    os.makedirs(root)
    train = run_a["config"]["data"]["train"]
    cfg = ddp_config(train)
    config = os.path.join(root, "ddp.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    row = {"nvidia_smi": smi, "note": "two ranks share one card over Gloo, which stages every "
           "CUDA collective through the host: these step times are no measure of DDP speed"}
    gloo = ["--multihost", "--dist_backend", "gloo", "--device", str(dev)]

    # (a) run A: 6 steps on two ranks; run B: two new ranks resume from ckpt_4
    out_a = os.path.join(root, "a")
    argv_a = ["--config", config, "--output_path", out_a, "--exp_name", "ddp"] + gloo
    recs_a, row["a_seconds"] = launch("run A", {"job": "train", "argv": argv_a, "out": out_a,
                                                "capture": True}, nproc=2)
    steps = list(range(1, DDP_STEPS + 1))
    check_train_ranks("run A", recs_a, steps)
    check(all(r["wrapped"] == "DistributedDataParallel" and r["world"] == 2 for r in recs_a),
          "ddp run A: the ranks did not train through DDP in a group of 2")
    check(len({r["digest_after_reset"] for r in recs_a}) == 1,
          "ddp run A: the ranks' parameters differ after the IL reset")
    ckpt_dir = os.path.join(out_a, "ddp_Reset_True_steps_2_smooth_1", "checkpoints")
    ckpt_4 = os.path.join(ckpt_dir, f"ckpt_{DDP_SAVE}.pth.tar")
    want_writes = [ckpt_4, os.path.join(ckpt_dir, f"ckpt_{DDP_STEPS}.pth.tar")]
    check(recs_a[0]["writes"] == want_writes and recs_a[1]["writes"] == [],
          f"ddp run A: rank 0 wrote {recs_a[0]['writes']}, rank 1 {recs_a[1]['writes']}")
    check(recs_a[0]["found"] == recs_a[1]["found"] == want_writes[1],
          "ddp run A: the ranks found different last checkpoints")
    ctxs = [recs_a[0]["steps"][str(s)]["ctx"] for s in steps]
    row["a"] = {"ctx": ctxs, "losses": [recs_a[0]["steps"][str(s)]["loss"] for s in steps],
                "step_ms": [[r["steps"][str(s)]["ms"] for s in steps] for r in recs_a],
                "local_len": [[r["steps"][str(s)]["local_len"] for s in steps] for r in recs_a],
                "launches": [r["launches"] for r in recs_a], "grad_bytes": recs_a[0]["grad_bytes"],
                "train_s": [r["train_s"] for r in recs_a]}
    log(f"ddp (a) run A: 2 ranks on cuda:0 over Gloo, {DDP_STEPS} steps of 128 rows a rank "
        f"through cli_entry --multihost in {row['a_seconds']:.1f} s; each rank every step "
        f"launched {TRAIN_LAUNCHES} (0 K3, 0 plain routes); contexts {ctxs} equal on both "
        f"ranks, the bucket of the longer of the ranks' longest captions "
        f"{row['a']['local_len']}; losses {[round(x, 5) for x in row['a']['losses']]} equal "
        f"on both ranks; parameter digests equal after the reset at step {DDP_SAVE} and at "
        f"the end; rank 0 alone wrote {[os.path.basename(w) for w in want_writes]}")
    log(f"ddp (a) per-rank step ms (fenced, host clock; {smi}): "
        + "; ".join(f"rank {r}: " + ", ".join(f"{x:.1f}" for x in ms)
                    for r, ms in enumerate(row["a"]["step_ms"]))
        + f"; gradient bytes all-reduced a step {row['a']['grad_bytes']} (4 x "
        f"{row['a']['grad_bytes'] // 4} trainable parameters). {row['note']}")

    out_b = os.path.join(root, "b")
    argv_b = ["--config", config, "--output_path", out_b, "--exp_name", "ddp", "--ckpt_path",
              ckpt_4] + gloo
    recs_b, row["b_seconds"] = launch("run B", {"job": "train", "argv": argv_b, "out": out_b},
                                      nproc=2)
    rest = steps[DDP_SAVE:]
    check_train_ranks("run B", recs_b, rest)
    resumed = [recs_b[0]["steps"][str(s)]["loss"] for s in rest]
    bitwise = (resumed == row["a"]["losses"][DDP_SAVE:]
               and recs_b[0]["digest_end"] == recs_a[0]["digest_end"])
    row["resume"] = {"losses": resumed, "bit_for_bit": bitwise, "writes": recs_b[0]["writes"]}
    log(f"ddp (a) run B: 2 new ranks resumed from ckpt_{DDP_SAVE} in {row['b_seconds']:.1f} s: "
        f"losses of steps {rest} {resumed} against run A's {row['a']['losses'][DDP_SAVE:]}, "
        f"final parameters equal to run A's: bit for bit {bitwise}")
    check(bitwise, "ddp run B: the two-rank resume did not repeat run A bit for bit")

    # (b) run A's first step against one process's step on the same 256 rows
    halves = [torch.load(os.path.join(out_a, f"batch{r}.pt"), weights_only=True) for r in (0, 1)]
    batch = {k: torch.cat([h[k] for h in halves]).to(dev) for k in halves[0]}
    grads = torch.load(os.path.join(out_a, "grads.pt"), weights_only=True)
    one = Solver(Config(ddp_config(train) | {"data": {"train": dict(train, batch_size=BATCH)}}),
                 output_path=os.path.join(root, "one"), exp_name="one", device=dev)
    temperature = float(CC3M_T_DECAY["org_t"])
    metrics = one.train_step(one.state, batch, temperature)
    loss_one = metrics["loss"].item()
    loss_ddp = row["a"]["losses"][0]
    cos = {}
    for n, p in one.params.items():
        check((p.grad is None) == (grads[n] is None),
              f"ddp (b): {n} has a gradient on one side only")
        if p.grad is not None and n not in UNREAD_NAMES:
            cos[n] = torch.nn.functional.cosine_similarity(
                p.grad.float().flatten(), grads[n].to(dev).float().flatten(), dim=0).item()
    worst = min(cos, key=cos.get)
    rel = abs(loss_ddp - loss_one) / abs(loss_one)
    row["vs_one_process"] = {"loss_ddp": loss_ddp, "loss_one": loss_one, "loss_rel": rel,
                             "min_grad_cos": cos[worst], "min_grad_cos_param": worst,
                             "ctx": batch["tokens"].shape[1]}
    log(f"ddp (b) step 1 of run A (2 ranks x 128 rows) against one process's step on the same "
        f"256 rows and weights: loss {loss_ddp:.6f} vs {loss_one:.6f} (relative {rel:.2e}, "
        f"bound {DDP_LOSS_RTOL}); gradient min cosine {cos[worst]:.6f} ({worst}; bound "
        f"{GRAD_MIN_COS}, the bf16 bound)")
    check(rel <= DDP_LOSS_RTOL and cos[worst] >= GRAD_MIN_COS,
          "ddp (b): the two-rank step disagrees with the one-process step")
    del one, batch, grads, halves, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a world of one under NCCL against the Solver with no group, bs 256
    config1 = os.path.join(root, "world1.yaml")
    cfg1 = ddp_config(train, DDP_WORLD1_STEPS)
    cfg1["saver"]["save_freq"] = 0  # no checkpoint: only the steps are compared
    with open(config1, "w") as f:
        yaml.safe_dump(cfg1, f)
    common = ["--config", config1, "--exp_name", "w1", "--batch_size", str(BATCH), "--device",
              str(dev)]
    recs_n, row["nccl_seconds"] = launch(
        "world 1 NCCL", {"job": "train", "out": os.path.join(root, "nccl"),
                         "argv": common + ["--output_path", os.path.join(root, "nccl"),
                                           "--multihost"]}, nproc=1)
    recs_p, row["plain_seconds"] = launch(
        "no group", {"job": "train", "out": os.path.join(root, "plain"),
                     "argv": common + ["--output_path", os.path.join(root, "plain")]})
    w1 = list(range(1, DDP_WORLD1_STEPS + 1))
    check_train_ranks("world 1 NCCL", recs_n, w1)
    check_train_ranks("no group", recs_p, w1)
    check(recs_n[0]["wrapped"] == "DistributedDataParallel" and recs_p[0]["wrapped"] == "CLIPFDT",
          f"ddp (c): wrapped {recs_n[0]['wrapped']} / {recs_p[0]['wrapped']}")
    ln = [recs_n[0]["steps"][str(s)]["loss"] for s in w1]
    lp = [recs_p[0]["steps"][str(s)]["loss"] for s in w1]
    row["world1"] = {"losses_nccl": ln, "losses_no_group": lp, "bit_for_bit": ln == lp,
                     "max_abs_diff": max(abs(a - b) for a, b in zip(ln, lp)),
                     "ctx": [recs_n[0]["steps"][str(s)]["ctx"] for s in w1],
                     "step_ms_nccl": [recs_n[0]["steps"][str(s)]["ms"] for s in w1],
                     "step_ms_no_group": [recs_p[0]["steps"][str(s)]["ms"] for s in w1],
                     "device": recs_n[0]["device"]}
    w = row["world1"]
    log(f"ddp (c) a world of 1 under NCCL (torch.distributed.run --nproc_per_node 1, "
        f"cli_entry --multihost, {w['device']}) against the Solver with no group, "
        f"{DDP_WORLD1_STEPS} steps at bs {BATCH}, contexts {w['ctx']}: losses {ln} vs {lp}, "
        f"bit for bit {w['bit_for_bit']} (largest difference {w['max_abs_diff']:.3e}); step ms "
        f"(fenced; {smi}) with the group "
        + ", ".join(f"{x:.1f}" for x in w["step_ms_nccl"]) + ", without "
        + ", ".join(f"{x:.1f}" for x in w["step_ms_no_group"]))
    check(w["bit_for_bit"], "ddp (c): the world-1 NCCL steps differ from the Solver's without "
                            "a group")

    # (d) --distributed eval on two ranks over ckpt_8, against phase 13's records
    eroot = ev_info["root"]
    head = ["--model_config", ev_info["config"], "--pretrained", run_a["ckpts"][1],
            "--batch_size", str(BATCH), "--sd_temperature", ev_info["temperature"],
            "--output", os.path.join(root, "eval_out", "{dataset}_{task}.json"),
            "--distributed", "--dist_backend", "gloo", "--device", str(dev)]
    runs = {"zeroshot": ["eval", "--dataset", "wds/zs", "--dataset_root", f"{eroot}/zs",
                         "--task", "zeroshot_classification", "--template_set", "80"] + head,
            "retrieval": ["eval", "--dataset", f"retrieval_json:{eroot}/ret.json",
                          "--dataset_root", f"{eroot}/ret", "--recall_k", "1", "5", "10"] + head}
    recs_e, row["eval_seconds"] = launch("eval", {"job": "eval", "runs": runs,
                                                  "out": os.path.join(root, "eval")}, nproc=2)
    row["eval"] = {}
    for label, want in (("zeroshot", report["eval"]["zeroshot"]),
                        ("retrieval", report["eval"]["retrieval"])):
        got = [r["runs"][label] for r in recs_e]
        n = got[0]["launches"]["codebook_pool_fwd"]
        for g in got:
            check(g["metrics"] == want, f"ddp (d) {label}: metrics {g['metrics']} differ from "
                                        f"phase 13's {want}")
            check(g["plain_routes"] == 0 and n > 0 and g["launches"] == {
                name: 0 for name in g["launches"]} | {"tiny_attention_fwd": 12 * n,
                                                      "codebook_pool_fwd": n},
                  f"ddp (d) {label}: launches {g['launches']}")
        check(got[0]["dumps"] == 1 and got[1]["dumps"] == 0 and got[1]["printed"] == ""
              and json.loads(got[0]["printed"])["metrics"] == want,
              f"ddp (d) {label}: rank 0 must alone print and write the record")
        row["eval"][label] = {"seconds": [g["seconds"] for g in got], "encoder_batches": n,
                              "metrics": got[0]["metrics"]}
        log(f"ddp (d) --distributed {label} on 2 ranks over Gloo: "
            + ", ".join(f"rank {r} {g['seconds']:.2f} s" for r, g in enumerate(got))
            + f" ({smi}); {n} encoder batches, each rank launching 12 K2-fwd and 1 K1-fwd on "
            f"its half of each; metrics equal to phase 13's one-process record; rank 0 alone "
            f"printed and wrote it")
    row["seconds"] = time.perf_counter() - t_phase
    report["ddp"] = row
    log(f"ddp: phase 15 in {row['seconds']:.1f} s (launches: run A {row['a_seconds']:.1f} s, "
        f"run B {row['b_seconds']:.1f} s, world 1 {row['nccl_seconds']:.1f} s, no group "
        f"{row['plain_seconds']:.1f} s, eval {row['eval_seconds']:.1f} s); {smi}")
    return recs_a[0]["launches"]


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
    from iterated_learning_for_vlm_tpu_torch.ops import flash_attention as fl
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
          attention_case(dev, f"text B={BATCH} S=32 H=8 causal", BATCH, 32, 8, True),
          attention_case(dev, f"text B={BATCH} S=77 H=8 causal as bias", BATCH, 77, 8, True,
                         "bias"),
          attention_case(dev, f"text B={BATCH} S=16 H=8 causal (eval prompts)", BATCH, 16, 8,
                         True)]
    k1 = [pool_case(dev, f"image B={BATCH} T=49", BATCH, 49, False),
          pool_case(dev, f"text B={BATCH} T=32 pads", BATCH, 32, True),
          pool_case(dev, f"text B={BATCH} T=77 pads", BATCH, 77, True),
          pool_case(dev, f"B/16 image B={BATCH} T=196", BATCH, 196, False),
          pool_case(dev, f"text B={BATCH} T=16 pads (eval prompts)", BATCH, 16, True)]
    report["kernel_checks"] = {"tiny_attention_fwd": k2, "codebook_pool_fwd": k1}

    # 3b. backward kernels against their plain versions, main-path shapes
    k2b = [attention_bwd_case(dev, f"vision B={BATCH} S=50 H=12", BATCH, 50, 12, False),
           attention_bwd_case(dev, f"text B={BATCH} S=77 H=8 causal", BATCH, 77, 8, True),
           attention_bwd_case(dev, f"text B={BATCH} S=32 H=8 causal", BATCH, 32, 8, True),
           attention_bwd_case(dev, f"text B={BATCH} S=77 H=8 causal as bias", BATCH, 77, 8,
                              True, "bias")]
    k1b = (pool_bwd_cases(dev, f"image B={BATCH} T=49", BATCH, 49, False)
           + pool_bwd_cases(dev, f"text B={BATCH} T=32 pads", BATCH, 32, True)
           + pool_bwd_cases(dev, f"text B={BATCH} T=77 pads", BATCH, 77, True)
           + pool_bwd_cases(dev, f"B/16 image B={BATCH} T=196", BATCH, 196, False))
    report["kernel_checks"].update({"tiny_attention_bwd": k2b, "codebook_pool_bwd": k1b})

    # 3c. flash attention against its plain versions, the tower shapes
    k3 = [flash_case(dev, f"vision B={BATCH} S=50 H=12", BATCH, 50, 12, False),
          flash_case(dev, f"text B={BATCH} S=77 H=8 causal", BATCH, 77, 8, True),
          flash_case(dev, f"text B={BATCH} S=32 H=8 causal", BATCH, 32, 8, True),
          flash_case(dev, f"ViT-B/16 vision B={BATCH} S=197 H=12", BATCH, 197, 12, False),
          flash_case(dev, f"text B={BATCH} S=77 H=8 causal bias", BATCH, 77, 8, True, "bias")]
    k3f, k3b = [r[0] for r in k3], [r[1] for r in k3]
    report["kernel_checks"].update({"flash_attention_fwd": k3f, "flash_attention_bwd": k3b,
                                    "flash_attention_fwd_bwd": [r[2] for r in k3]})

    # 3d. K4 against its plain versions at Swin-MoE-B's stages, then its
    # launches in a Swin-MoE train step
    k4 = [window_case(dev, name, *shape) for name, shape in K4_STAGES]
    k4f, k4b = [r[0] for r in k4], [r[1] for r in k4]
    report["kernel_checks"].update({"window_attention_fwd": k4f, "window_attention_bwd": k4b})
    # and its cosine form at Swin V2-B's stages
    k4c = [window_case(dev, name, *shape, True) for name, shape in K4_STAGES]
    report["kernel_checks"].update({"window_attention_cos_fwd": [r[0] for r in k4c],
                                    "window_attention_cos_bwd": [r[1] for r in k4c]})
    gc.collect()
    torch.cuda.empty_cache()
    swin_launches = swin_phase(dev, report)

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
    reset_routes()
    t0 = time.perf_counter()
    outs = serve(enc)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check_routes("serve")
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

    # 4b. captions through the port's own tokenizer (no tokenizer passed in)
    enc.encode_texts(CAPTIONS[:1])  # first call: loads the tokenizer's vocabulary
    torch.cuda.synchronize()
    fa.tiny_attention_fwd.launches = cb.codebook_pool_fwd.launches = 0
    reset_routes()
    emb = enc.encode_texts(CAPTIONS)
    torch.cuda.synchronize()
    check_routes("captions")
    caption_launches = {"tiny_attention_fwd": fa.tiny_attention_fwd.launches,
                        "codebook_pool_fwd": cb.codebook_pool_fwd.launches}
    cat = enc.tokenizer(CAPTIONS[:1], context_length=77)[0][0, :len(CAT_TOKENS)].tolist()
    cos = float(cosines(emb, enc_plain.encode_texts(CAPTIONS)).min())
    norm_err = float(np.abs(np.linalg.norm(emb, axis=-1) - 1).max())
    log(f"captions: {len(CAPTIONS)} through TorchEncoder.encode_texts with the port's "
        f"tokenizer ({type(enc.tokenizer).__module__}); launches {caption_launches}; "
        f"'{CAPTIONS[0]}' -> {cat}; |norm-1| max {norm_err:.2e}, min cosine vs plain path "
        f"{cos:.6f} (bound {EMBED_MIN_COS})")
    check(type(enc.tokenizer).__module__ == "iterated_learning_for_vlm_tpu_torch.data.tokenizer",
          "encode_texts did not take the port's tokenizer")
    check(cat == CAT_TOKENS, f"the tokenizer gave {cat} for '{CAPTIONS[0]}', expected {CAT_TOKENS}")
    check(emb.shape == (len(CAPTIONS), 512) and bool(np.isfinite(emb).all())
          and norm_err <= NORM_ATOL, "caption embeddings are malformed")
    check(cos >= EMBED_MIN_COS, "caption embeddings disagree with the plain path")
    check(caption_launches == {"tiny_attention_fwd": 12, "codebook_pool_fwd": 1},
          f"captions launched {caption_launches}, expected 12 and 1")
    check("jax" not in sys.modules, "encoding captions imported jax")
    report["captions"] = {"launches": caption_launches, "cat_tokens": cat,
                          "min_cos_vs_plain": cos, "max_norm_err": norm_err}

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
               "codebook_pool_bwd_dsd": cb.codebook_pool_bwd_dsd,
               "flash_attention_fwd": fl.flash_attention_fwd,
               "flash_attention_bwd": fl.flash_attention_bwd}
    batch32 = train_batch(dev, rng, 32)
    batch77 = train_batch(dev, rng, 77)
    train_launches, report["train_step"], _, (state_p, step_p) = train_phase(
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

    # 9-10. the baseline CLIP, after the CLIP-FDT models are freed
    del model, plain, state_k, step_k, state_p, step_p, batch32, batch77, prof
    torch.cuda.empty_cache()
    clip_serve_launches, clip_train_launches = clip_phases(dev, rng, counted, report)

    # 11. the port's Solver, after the CLIP models are freed
    torch.cuda.empty_cache()
    solver_launches = solver_phase(dev, counted, report)

    # 12. the data pipeline, after phase 11's models are freed; its checkpoints
    # stay on disk for 13. the eval suite
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ilvlm_pipeline_") as tmp:
        pipeline_launches, run_a = pipeline_phase(dev, counted, report, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        eval_launches, ev_info = eval_phase(dev, counted, report, run_a, tmp)
        # 14. caption tasks, clip_fdt_vitb16, attention maps, the visualizer
        phase14_launches = phase14(dev, counted, report, run_a, ev_info, tmp, smi)
        # 15. data parallel: ranks in child processes, over phase 12's shards
        # and checkpoints and phase 13's eval sets
        phase15_launches = phase15(dev, report, run_a, ev_info, tmp, smi)

    report["seconds_total"] = time.perf_counter() - t_start
    out_dir = REPO / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    checks = {"codebook_pool_fwd": k1, "tiny_attention_fwd": k2, "tiny_attention_bwd": k2b,
              "codebook_pool_bwd_dq": [r for r in k1b if r["entry"] == "codebook_pool_bwd_dq"],
              "codebook_pool_bwd_dsd": [r for r in k1b if r["entry"] == "codebook_pool_bwd_dsd"],
              "flash_attention_fwd": k3f, "flash_attention_bwd": k3b,
              "window_attention_fwd": k4f, "window_attention_bwd": k4b}
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    # K4 after phase 3d: no other phase of this process runs a Swin tower
    k4_after = {"window_attention_fwd": wa.window_attention_fwd.launches,
                "window_attention_bwd": wa.window_attention_bwd.launches}
    check(not any(k4_after.values()), f"K4 launched {k4_after} outside the Swin-MoE phase")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rows = checks[name]
        if name in SWIN_LAUNCHES:  # the Swin-MoE train step's launches (phase 3d)
            kernels.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": swin_launches[name],
                            "max_abs_err": max(r["max_abs_err"] for r in rows),
                            **{key: rows[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by", "library_ms")},
                            "shape": rows[0]["case"], "launches_other_phases": k4_after[name]})
            continue
        # each kernel's launches in the train step of the path that runs it:
        # CLIP-FDT (phase 6) for K1 and K2, the CLIP flash route (phase 9) for K3
        flash = name.startswith("flash")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": (clip_train_launches if flash else train_launches)[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        **{key: rows[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by", "library_ms")},
                        "shape": rows[0]["case"], "launches_solver": solver_launches[name],
                        "launches_pipeline": pipeline_launches[name],
                        "launches_eval": eval_launches[name],
                        "launches_phase14": phase14_launches[name],
                        "launches_phase15_rank0": phase15_launches[name]})
        serving = clip_serve_launches if flash else launches
        if serving.get(name):
            kernels[-1]["launches_serving"] = serving[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_job(sys.argv[2]) if sys.argv[1:2] == ["--rank-job"] else main())
