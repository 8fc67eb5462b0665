"""Training cells of CLIP-FDT Swin V2: the port's ``Solver.train()`` on ``clip_fdt_swinB_v2``.

The same run as ``loops/train.py``'s, with its batch source (:class:`Feed`),
its pool of device-made batches (``make_pool``) and its comparison
(``gaps``), which this loop imports and does not change. What differs:

- the draw and the replay come from ``reference/fdt_swinv2.py`` (the Swin V2
  tower, the codebook heads over its last-stage tokens), and the pool is
  made from the configuration as ``reference/clip.py`` reads it
  (``clip_view``);
- the cosine K4's launch counts (``window_attention_cos``) are read where
  the Feed reads the other wrappers' around its traced slice
  (:func:`counting_cos_k4`, ``loops/train_moe.py``'s ``counting_k4`` on the
  cosine wrappers) and join its counts;
- on the CPU, where only the harness's self-tests run it, the cell is cut to
  a size the CPU trains in seconds (:func:`cpu_cell`).
"""
from __future__ import annotations

import copy
import gc
import itertools
import math
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

import harness
from loops import train as base
from reference import fdt_swinv2 as ref

CPU_IMAGE = {"input_resolution": 96, "patch_size": 4, "window_size": 6,
             "depths": [2, 2, 2, 2]}
CPU_TEXT = {"width": 64, "layers": 2, "heads": 1, "embed_dim": 64}
CPU_FDT = {"sd_num": 256, "sd_dim": 64, "raw_img_ft_dim": 1024, "raw_txt_ft_dim": 64}


def cpu_cell(cell):
    """The cell at a size the CPU trains in seconds: a 96 px tower of window
    6 with two blocks a stage (the published channels and heads, so the last
    stage's 3 x 3 tokens are 1024 wide), a two-layer text tower of width 64,
    a 256 x 64 codebook, 4 pairs a step at context 16. The dtype stays the
    configuration's. The caller's cell is left as it is."""
    cell = copy.copy(cell)
    config = cell.config = copy.deepcopy(cell.config)
    kw = config["model"]["kwargs"]
    kw["image_encode"].update(CPU_IMAGE)
    kw["text_encode"].update(CPU_TEXT)
    kw["fdt"].update(CPU_FDT)
    traffic = cell.traffic = copy.deepcopy(cell.traffic)
    traffic.update(batch_size=4, warmup_steps=5, trace_steps=3)
    traffic["pool"].update(batches=4, context=16)
    traffic["pool"]["caption_tokens"].update(mean=8, std=3, max=16)
    return cell


def cos_k4_launches() -> Dict[str, int]:
    """The cosine K4's launch counts."""
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    return {"window_attention_cos_fwd": wa.window_attention_cos_fwd.launches,
            "window_attention_cos_bwd": wa.window_attention_cos_bwd.launches}


def counting_cos_k4(feed, batches):
    """``feed.stream``'s batches, with the cosine K4's launches over the traced
    slice in ``feed.k4_counted``, read at the points ``counting_k4`` reads
    K4's: as the slice's first batch is handed out (the window is then
    closed) and as the batch after its last is."""
    start, handed = None, 0
    for batch in batches:
        if feed.trace_steps and start is None and "steps" in feed.window:
            start = cos_k4_launches()
        elif start is not None:
            handed += 1
            if handed == feed.trace_steps:
                end = cos_k4_launches()
                feed.k4_counted = {k: end[k] - start[k] for k in start}
        yield batch


def train_program(cell, seed: int, seconds: float, trace: bool, device, process_start: float):
    """``loops/train.py``'s ``train_program`` for this configuration."""
    from iterated_learning_for_vlm_tpu_torch.train import solver as solver_mod
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    config, traffic = cell.config, cell.traffic
    pool = base.make_pool(ref.clip_view(config), traffic, seed, device)
    params0 = ref.init_params(config, seed, device)
    b1 = config["optimizer"]["kwargs"]["betas"][0]
    feed = base.Feed(traffic, seconds, trace, process_start, device, params0, b1)
    feed.k4_counted = None

    class BenchSolver(solver_mod.Solver):
        def _batches(self, epoch: int, skip: int = 0):
            return counting_cos_k4(feed, feed.stream(self, itertools.cycle(pool)))

    with tempfile.TemporaryDirectory() as out:
        solver = BenchSolver(Config(base.solver_config(config, traffic)),
                             output_path=out, exp_name="bench", seed=seed, device=device)
        harness.load_params(solver.model, params0)
        del params0
        step, on_step = solver.train_step, solver.il.on_step

        def train_step(state, batch, temperature):
            metrics = step(state, batch, temperature)
            feed.losses.append(metrics["loss"])
            return metrics

        solver.train_step = train_step
        if trace:
            solver.train_step = base.spanned("train_step", train_step)
            solver.il.on_step = base.spanned("il.on_step", on_step)
            feed._next = base.spanned("batch_source.next", feed._next)
        solver.train()
    if feed.profile is not None and feed.k4_counted is not None:
        feed.profile = (feed.profile[0], {**feed.profile[1], **feed.k4_counted})
    losses = torch.stack(feed.losses).float().cpu()
    feed.readings = {"loss": losses[:feed.check_steps].tolist(),
                     "grad_norm": dict(zip(feed.names,
                                           feed.readings["grad_norm"].cpu().tolist())),
                     "change": feed.readings["change"]}
    feed.all_losses = losses
    del solver, step, on_step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return feed, pool


def reference_readings(config: dict, seed: int, batches: List[dict], device,
                       precision: str = "fp32", fault: Optional[str] = None) -> dict:
    ref.exact_fp32()
    params0 = ref.init_params(config, seed, device)
    out = ref.train_steps(config, params0, batches, precision, fault)
    del params0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def calibrate(cell, seed: int, variants, device, process_start: float, seconds: float):
    """The compared numbers of the program's check steps and of the
    reference's variants in its place: ``fp8`` (the control) or a fault of
    ``reference/fdt_swinv2.py``'s ``FAULTS``, one row per variant."""
    if device.type == "cpu":
        cell = cpu_cell(cell)
    feed, _ = train_program(cell, seed, 0.0, False, device, process_start)
    want = reference_readings(cell.config, seed, feed.check_batches, device)
    rows = []
    for variant in variants:
        if variant == "program":
            got = feed.readings
        else:
            got = reference_readings(cell.config, seed, feed.check_batches, device,
                                     "fp8" if variant == "fp8" else "fp32",
                                     None if variant == "fp8" else variant)
        rows.append({"variant": variant, **base.gaps(got, want), "loss": got["loss"],
                     "ref_loss": want["loss"], "worst": base.worst_leaves(got, want)})
    return rows


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    if device.type == "cpu":
        cell = cpu_cell(cell)
    feed, pool = train_program(cell, seed, seconds, trace, device, process_start)
    batches = feed.check_batches
    del pool
    want = reference_readings(cell.config, seed, batches, device)
    found = base.gaps(feed.readings, want)
    checks = {k: {"value": found[k], "limit": v} for k, v in cell.limits.items()}
    window = feed.window
    pairs = window["steps"] * cell.traffic["batch_size"]
    end_to_end = {"setup_s": window["setup_s"],
                  "train_pairs_per_s": pairs / window["seconds"],
                  "train_step_ms_p95": (float(np.percentile(window["step_ms"], 95))
                                        if window["step_ms"] else math.nan)}
    outcome = {"attempted": len(feed.all_losses),
               "failed": int((~torch.isfinite(feed.all_losses)).sum()),
               "checks": checks, "end_to_end": end_to_end, "window": window,
               "memory_peak_bytes": window["memory_peak_bytes"],
               "config": cell.config, "traffic": cell.traffic, "trace": None,
               "counters": {}}
    if feed.profile is not None:
        outcome["trace"], outcome["counters"] = feed.profile
    return outcome
