"""Training cells: the port's ``Solver.train()`` over the traffic's batch source.

One ``Solver`` is built from the configuration's recipe blocks with the
traffic's overrides (saves and in-training eval off, one epoch), its
parameters set to the benchmark's draw from ``--seed``
(``reference.clip.init_params``). A subclass replaces only the Solver's
batch source (``Solver._batches``) with :class:`Feed`, which feeds in turn
``pool.batches`` batches of ``batch_size`` rows (images and captions) made
on the device from the seed.

The one ``train()`` call runs, in order: the set-up steps (the first
``check_steps`` on distinct rows, read for the correctness check), the
measured window (``--seconds``, ended by ``torch.cuda.synchronize()``), and
with ``--trace 1`` ``trace_steps`` more under ``torch.profiler``. The stream
then ends and so does the epoch. After the Solver is freed, the plain
reference (``reference/clip.py``) replays the check steps from the same
draw and batches, and the gaps between the two are compared with the
cell's limits.
"""
from __future__ import annotations

import copy
import gc
import itertools
import math
import statistics
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import harness
from reference import clip as ref

PAD = float("-inf")


# -- the batch sources -----------------------------------------------------------
def caption_lengths(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """Tokens per caption, SOT and EOT included: a rounded normal, clipped."""
    draw = torch.randn(n, generator=gen, device=device) * spec["std"] + spec["mean"]
    return draw.round().clamp(spec["min"], spec["max"]).long()


def make_pool(config: dict, traffic: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool.batches`` batches on the device from ``seed``: normalised-pixel
    images [B, R, R, 3], token ids [B, ctx] (SOT, body, EOT, zero pads) and
    the pad mask (0 real, -inf pad), as the data pipeline delivers them."""
    spec = traffic["pool"]
    txt = ref.sizes(config)["text"]
    res = ref.sizes(config)["image"]["resolution"]
    b, ctx, vocab = traffic["batch_size"], spec["context"], txt["vocab_size"]
    sot, eot = vocab - 2, vocab - 1
    gen = torch.Generator(device=device).manual_seed(int(seed) * 1000003 + 17)
    pos = torch.arange(ctx, device=device)
    out = []
    for _ in range(spec["batches"]):
        image = torch.randn(b, res, res, 3, generator=gen, device=device)
        length = caption_lengths(spec["caption_tokens"], b, gen, device)[:, None]
        body = torch.randint(1, sot, (b, ctx), generator=gen, device=device)
        tokens = torch.where(pos < length - 1, body, 0)
        tokens[:, 0] = sot
        tokens = torch.where(pos == length - 1, eot, tokens).to(torch.int32)
        pad_mask = torch.where(pos < length, 0.0, PAD).float()
        out.append({"image": image, "tokens": tokens, "pad_mask": pad_mask})
    return out


class Feed:
    """The Solver's batch source, and the harness's clock around it."""

    def __init__(self, traffic: dict, seconds: float, trace: bool, process_start: float,
                 device: torch.device, params0: Dict[str, torch.Tensor], b1: float):
        self.warmup = int(traffic["warmup_steps"])
        self.check_steps = int(traffic["check_steps"])
        if self.warmup <= self.check_steps:
            raise ValueError("warmup_steps must exceed check_steps")
        self.seconds = seconds
        self.trace_steps = int(traffic["trace_steps"]) if trace else 0
        self.process_start = process_start
        self.device = device
        self.cuda = device.type == "cuda"
        self.params0 = params0
        self.b1 = b1
        self.check_batches: List[dict] = []
        self.losses: List[torch.Tensor] = []
        self.waits: List[float] = []
        self.names = sorted(params0)
        self.readings: dict = {}
        self.window: dict = {}
        self.profile = None

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def stamp(self):
        """A point on the device's timeline (a host time on the CPU)."""
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def gaps_ms(self, stamps) -> List[float]:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]

    def _after_first_step(self, solver):
        """The first gradient's norms as AdamW got it: its first moment over 1 - b1."""
        mu = solver.state.opt_state["mu"]
        norms = torch.stack([mu[n].norm() for n in self.names])
        self.readings["grad_norm"] = norms / (1 - self.b1)

    def _after_check_steps(self, solver):
        params = dict(solver.model.named_parameters())
        self.readings["change"] = {n: (params[n].detach() - self.params0[n]).cpu()
                                   for n in self.names}
        self.params0 = None

    def _next(self, it):
        start = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            raise RuntimeError("the batch source ran dry before the run ended")
        return batch, time.perf_counter() - start

    def stream(self, solver, inner):
        it = iter(inner)
        if self.trace_steps:
            harness.warm_profiler(self.device)
        for k in range(self.warmup):  # set-up: step k + 1 runs on the batch yielded here
            if k == 1:
                self._after_first_step(solver)
            if k == self.check_steps:
                self._after_check_steps(solver)
            batch, _ = self._next(it)
            if k < self.check_steps:
                self.check_batches.append({key: v.clone() for key, v in batch.items()})
            yield batch
        self.sync()
        t0 = time.perf_counter()
        self.window["setup_s"] = t0 - self.process_start
        stamps, contexts = [self.stamp()], []
        while time.perf_counter() - t0 < self.seconds:
            batch, wait = self._next(it)
            self.waits.append(wait)
            contexts.append(batch["tokens"].shape[1])
            yield batch
            stamps.append(self.stamp())
        self.sync()
        self.window.update(seconds=time.perf_counter() - t0, steps=len(stamps) - 1,
                           step_ms=self.gaps_ms(stamps), data_wait_s=self.waits,
                           contexts=contexts)
        self.window["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                            if self.cuda else 0)
        if not self.trace_steps:
            return
        # the metrics' slice: device activity alone, which keeps the host's
        # pace; then a slice with the host's ops too, for naming idle gaps
        counters = launch_counters()
        t1 = time.perf_counter()
        contexts = []
        with harness.profiler(self.cuda, host=False) as prof:
            for _ in range(self.trace_steps):
                batch, _ = self._next(it)
                contexts.append(batch["tokens"].shape[1])
                yield batch
            self.sync()
            window_s = time.perf_counter() - t1
        counted = {k: v - counters[k] for k, v in launch_counters().items()}
        summary = harness.summarize_trace(harness.chrome_trace(prof), window_s,
                                          self.trace_steps)
        with harness.profiler(self.cuda, host=True) as named:
            for _ in range(self.trace_steps):
                batch, _ = self._next(it)
                yield batch
            self.sync()
        summary.update(contexts=contexts, idle_gaps=harness.idle_gaps(harness.chrome_trace(named)))
        self.profile = (summary, counted)


def launch_counters() -> Dict[str, int]:
    """The kernel wrappers' own launch counts."""
    from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb
    from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

    return {"tiny_attention_fwd": fa.tiny_attention_fwd.launches,
            "tiny_attention_bwd": fa.tiny_attention_bwd.launches,
            "codebook_pool_fwd": cb.codebook_pool_fwd.launches,
            "codebook_pool_bwd_dq": cb.codebook_pool_bwd_dq.launches,
            "codebook_pool_bwd_dsd": cb.codebook_pool_bwd_dsd.launches}


# -- the Solver -------------------------------------------------------------------
def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else copy.deepcopy(v)
    return out


RECIPE_BLOCKS = ("model", "grad_clip", "t_decay", "optimizer", "lr_scheduler", "data",
                 "saver", "reset")


def solver_config(config: dict, traffic: dict) -> dict:
    blocks = {k: config[k] for k in RECIPE_BLOCKS if k in config}
    blocks = merge(blocks, traffic["solver"])
    blocks["data"]["train"]["batch_size"] = traffic["batch_size"]
    return blocks


def train_program(cell, seed: int, seconds: float, trace: bool, device, process_start: float):
    """Build the Solver, run ``train()`` through the Feed, and return the Feed
    (window, readings, profile) and the batch pool. The Solver is freed."""
    from iterated_learning_for_vlm_tpu_torch.train import solver as solver_mod
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    config, traffic = cell.config, cell.traffic
    pool = make_pool(config, traffic, seed, device)
    params0 = ref.init_params(config, seed, device)
    b1 = config["optimizer"]["kwargs"]["betas"][0]
    feed = Feed(traffic, seconds, trace, process_start, device, params0, b1)

    class BenchSolver(solver_mod.Solver):
        def _batches(self, epoch: int, skip: int = 0):
            return feed.stream(self, itertools.cycle(pool))

    with tempfile.TemporaryDirectory() as out:
        solver = BenchSolver(Config(solver_config(config, traffic)),
                             output_path=out, exp_name="bench", seed=seed, device=device)
        harness.load_params(solver.model, params0)
        del params0
        step, on_step = solver.train_step, solver.il.on_step

        def train_step(state, batch, temperature):
            metrics = step(state, batch, temperature)
            feed.losses.append(metrics["loss"])
            return metrics

        solver.train_step = train_step
        if trace:  # spans around the calls into each layer, for the idle gaps' names
            solver.train_step = spanned("train_step", train_step)
            solver.il.on_step = spanned("il.on_step", on_step)
            feed._next = spanned("batch_source.next", feed._next)
        solver.train()
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


def spanned(name, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


# -- the comparison -------------------------------------------------------------------
def moved_elements(want: dict) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements the reference's first gradient moves: those at
    or above a thousandth of the median leaf's root-mean-square gradient.
    The rest (a key's bias under softmax, the embedding rows of ids no
    caption holds) move under Adam by round-off alone, or not at all."""
    rms = [want["grad_norm"][n] / want["grad"][n].numel() ** 0.5 for n in want["grad"]]
    floor = 1e-3 * statistics.median(rms)
    return {n: g.abs() >= floor for n, g in want["grad"].items()}


def change_norms(readings: dict, moved: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(readings["change"][n][m].norm()) for n, m in moved.items() if m.any()}


def gaps(got: dict, want: dict) -> Dict[str, float]:
    """``loss_gap``: the largest gap of a check step's loss, ``loss_gap_first``
    the first step's; ``grad_gap`` and ``change_gap``: by the worst leaf, the
    gap between the two norms of the first step's gradient and of the change
    after the check steps, over the reference's norm of that leaf or of the
    median leaf, whichever is larger. The change counts only the elements
    :func:`moved_elements` keeps. A cell compares the numbers its limits name."""
    losses = [abs(a - b) for a, b in zip(got["loss"], want["loss"])]
    moved = moved_elements(want)
    return {"loss_gap": max(losses), "loss_gap_first": losses[0],
            "grad_gap": _worst(got["grad_norm"], want["grad_norm"])[0][3],
            "change_gap": _worst(change_norms(got, moved), change_norms(want, moved))[0][3]}


def _worst(got: Dict[str, float], want: Dict[str, float]) -> List[list]:
    """Leaves by their gap, worst first: [name, got, want, gap]."""
    med = statistics.median(want.values())
    rows = [[n, got[n], want[n], abs(got[n] - want[n]) / max(want[n], med)] for n in want]
    return sorted(rows, key=lambda r: -r[3])


def worst_leaves(got: dict, want: dict, count: int = 3) -> dict:
    """The leaves with the largest gaps, for finding why a gap is large."""
    moved = moved_elements(want)
    return {"grad": _worst(got["grad_norm"], want["grad_norm"])[:count],
            "change": _worst(change_norms(got, moved), change_norms(want, moved))[:count]}


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
    """The compared numbers of the program's check steps (no window) and of
    the reference's variants in its place: ``fp8`` (the control) or a fault
    planted in the reference (``half_batch``), one row per variant, with the
    worst leaves."""
    feed, _ = train_program(cell, seed, 0.0, False, device, process_start)
    want = reference_readings(cell.config, seed, feed.check_batches, device)
    rows = []
    for variant in variants:
        if variant == "program":
            got = feed.readings
        elif variant == "fp8":
            got = reference_readings(cell.config, seed, feed.check_batches, device, "fp8")
        else:
            got = reference_readings(cell.config, seed, feed.check_batches, device,
                                     fault=variant)
        rows.append({"variant": variant, **gaps(got, want), "loss": got["loss"],
                     "ref_loss": want["loss"], "worst": worst_leaves(got, want)})
    return rows


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    feed, pool = train_program(cell, seed, seconds, trace, device, process_start)
    batches = feed.check_batches
    del pool
    want = reference_readings(cell.config, seed, batches, device)
    found = gaps(feed.readings, want)
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
