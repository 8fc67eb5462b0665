"""Data-parallel training cells: the port's ``Solver.train()`` on every card of a host.

From the process ``run.py`` starts (rank 0, on the first device) this loop
starts ranks 1 .. W-1 (``W`` = the cell's chips) as processes of this same
file, rank r on device r. They join one process group
(``parallel/mesh.py:init_data_parallel``: NCCL on the card, Gloo on the
CPU), and each rank runs the configuration's recipe through the port's
``Solver`` at the traffic's ``batch_size``: the Solver wraps the model in
``DistributedDataParallel`` and takes the InfoNCE over all ranks' rows.
Each rank feeds its own pool (``loops/train.py``'s ``make_pool`` from
``seed + rank``) through ``loops/train.py``'s :class:`Feed`, with one change
(:class:`DDPFeed`): the window's steps are timed on rank 0 between
barriers, and rank 0 decides before each step whether the window goes on
and tells the other ranks, so every rank runs the same steps. With
``--trace 1`` rank 0 profiles its slices; the others run the same steps.

``train_pairs_per_s`` counts every rank's pairs. After the window, rank 0
(its Solver freed, the group closed) remakes the other ranks' check batches
from their seeds and replays the check steps in the plain reference
(``reference/clip.py``) over the gathered ``W * batch_size`` rows, in rank
order; the replay computes the embeddings in chunks of ``batch_size`` rows,
takes the InfoNCE's gradient with respect to them over all rows, and then
back-propagates each chunk's part (the gradient is that of the whole batch;
only the sums' order differs). The gaps are ``loops/train.py``'s.

On the CPU, where only the harness's self-tests run it, the loop runs two
Gloo ranks of 4 pairs a step (:func:`cpu_cell`); the configuration is taken
as the caller gives it.
"""
from __future__ import annotations

import argparse
import copy
import gc
import itertools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
if __name__ == "__main__":  # a rank > 0, started by rank 0
    sys.path[:0] = [str(ROOT), str(BENCH_DIR)]

import harness  # noqa: E402
from loops import train as base  # noqa: E402
from reference import clip as ref  # noqa: E402

GROUP_TIMEOUT = timedelta(seconds=120)  # a dead rank fails the others' next collective
JOIN_TIMEOUT = 300  # seconds rank 0 waits for the others after its own run


def cpu_cell(cell):
    """The cell as two ranks of 4 pairs a step at context 16, a pool of 4
    batches and a short warm-up; the caller's cell is left as it is."""
    cell = copy.copy(cell)
    cell.entry = dict(cell.entry, chips=min(2, int(cell.entry["chips"])))
    traffic = cell.traffic = copy.deepcopy(cell.traffic)
    traffic.update(batch_size=4, warmup_steps=5, trace_steps=3)
    traffic["pool"].update(batches=4, context=16)
    traffic["pool"]["caption_tokens"].update(mean=8, std=3, max=16)
    return cell


def rank_seed(seed: int, rank: int) -> int:
    return int(seed) + rank


def rank_device(device: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank) if device.type == "cuda" else device


class DDPFeed(base.Feed):
    """:class:`loops.train.Feed` for one rank of a group: the same set-up
    steps, then a window that rank 0 times and ends for every rank, then the
    traced slices (profiled on rank 0 alone)."""

    def __init__(self, *args, rank: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.rank = rank

    def _go(self, go: bool) -> bool:
        from iterated_learning_for_vlm_tpu_torch.parallel import mesh

        flag = torch.tensor([1 if go else 0], dtype=torch.int32)
        group = mesh.cpu_group()
        torch.distributed.broadcast(flag, src=0, group=group)
        return bool(flag.item())

    def stream(self, solver, inner):
        from iterated_learning_for_vlm_tpu_torch.parallel import mesh

        it = iter(inner)
        main = self.rank == 0
        if self.trace_steps and main:
            harness.warm_profiler(self.device)
        for k in range(self.warmup):
            if k == 1 and main:
                self._after_first_step(solver)
            if k == self.check_steps and main:
                self._after_check_steps(solver)
            batch, _ = self._next(it)
            if k < self.check_steps and main:
                self.check_batches.append({key: v.clone() for key, v in batch.items()})
            yield batch
        self.sync()
        mesh.barrier()
        t0 = time.perf_counter()
        self.window["setup_s"] = t0 - self.process_start
        stamps, contexts = [self.stamp()], []
        while self._go(time.perf_counter() - t0 < self.seconds):
            batch, wait = self._next(it)
            self.waits.append(wait)
            contexts.append(batch["tokens"].shape[1])
            yield batch
            stamps.append(self.stamp())
        self.sync()
        mesh.barrier()
        self.window.update(seconds=time.perf_counter() - t0, steps=len(stamps) - 1,
                           step_ms=self.gaps_ms(stamps), data_wait_s=self.waits,
                           contexts=contexts)
        self.window["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(self.device)
                                            if self.cuda else 0)
        if not self.trace_steps:
            return
        if not main:
            for _ in range(2 * self.trace_steps):
                batch, _ = self._next(it)
                yield batch
            self.sync()
            return
        counters = base.launch_counters()
        t1 = time.perf_counter()
        contexts = []
        with harness.profiler(self.cuda, host=False) as prof:
            for _ in range(self.trace_steps):
                batch, _ = self._next(it)
                contexts.append(batch["tokens"].shape[1])
                yield batch
            self.sync()
            window_s = time.perf_counter() - t1
        counted = {k: v - counters[k] for k, v in base.launch_counters().items()}
        summary = harness.summarize_trace(harness.chrome_trace(prof), window_s,
                                          self.trace_steps)
        with harness.profiler(self.cuda, host=True) as named:
            for _ in range(self.trace_steps):
                batch, _ = self._next(it)
                yield batch
            self.sync()
        summary.update(contexts=contexts, idle_gaps=harness.idle_gaps(harness.chrome_trace(named)))
        self.profile = (summary, counted)


def train_rank(config: dict, traffic: dict, rank: int, world: int, port: int, seed: int,
               seconds: float, trace: bool, device: torch.device, process_start: float):
    """One rank's Solver run in the group; returns its Feed (rank 0 reads it)."""
    from iterated_learning_for_vlm_tpu_torch.parallel import mesh
    from iterated_learning_for_vlm_tpu_torch.train import solver as solver_mod
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    mesh.init_data_parallel("nccl" if dev.type == "cuda" else "gloo",
                            coordinator=f"127.0.0.1:{port}", num_processes=world,
                            process_id=rank, timeout=GROUP_TIMEOUT)
    try:
        pool = base.make_pool(config, traffic, rank_seed(seed, rank), dev)
        params0 = ref.init_params(config, seed, dev)
        b1 = config["optimizer"]["kwargs"]["betas"][0]
        feed = DDPFeed(traffic, seconds, trace, process_start, dev, params0, b1, rank=rank)

        class BenchSolver(solver_mod.Solver):
            def _batches(self, epoch: int, skip: int = 0):
                return feed.stream(self, itertools.cycle(pool))

        with tempfile.TemporaryDirectory() as out:
            solver = BenchSolver(Config(base.solver_config(config, traffic)),
                                 output_path=out, exp_name="bench", seed=seed, device=dev)
            harness.load_params(solver.model, params0)
            del params0
            step, on_step = solver.train_step, solver.il.on_step

            def train_step(state, batch, temperature):
                metrics = step(state, batch, temperature)
                feed.losses.append(metrics["loss"])
                return metrics

            solver.train_step = train_step
            if trace and rank == 0:
                solver.train_step = base.spanned("train_step", train_step)
                solver.il.on_step = base.spanned("il.on_step", on_step)
                feed._next = base.spanned("batch_source.next", feed._next)
            solver.train()
        mesh.barrier()
    finally:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return feed
    losses = torch.stack(feed.losses).float().cpu()
    feed.readings = {"loss": losses[:feed.check_steps].tolist(),
                     "grad_norm": dict(zip(feed.names,
                                           feed.readings["grad_norm"].cpu().tolist())),
                     "change": feed.readings["change"]}
    feed.all_losses = losses
    del solver, step, on_step, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return feed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_program(cell, seed: int, seconds: float, trace: bool, device, process_start: float):
    """Start the other ranks, run rank 0 here, wait for them; returns rank 0's
    Feed with ``check_batches`` gathered over the ranks (rank order)."""
    world = int(cell.entry["chips"])
    port = free_port()
    if device.type == "cuda":  # build the kernels once, before the ranks start
        from iterated_learning_for_vlm_tpu_torch.ops import _build

        _build.load_library()
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "cell.json"
        spec.write_text(json.dumps({"config": cell.config, "traffic": cell.traffic}))
        procs, logs = [], []
        for rank in range(1, world):
            log = open(Path(tmp) / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--spec", str(spec),
                 "--rank", str(rank), "--world", str(world), "--port", str(port),
                 "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(trace)),
                 "--device", device.type],
                cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
        try:
            feed = train_rank(cell.config, cell.traffic, 0, world, port, seed, seconds, trace,
                              device, process_start)
        finally:
            failed = []
            for rank, (proc, log) in enumerate(zip(procs, logs), start=1):
                try:
                    proc.wait(timeout=JOIN_TIMEOUT)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                log.close()
                if proc.returncode != 0:
                    failed.append(rank)
                    tail = (Path(tmp) / f"rank{rank}.log").read_text()[-4000:]
                    print(f"rank {rank} exited with {proc.returncode}:\n{tail}", file=sys.stderr)
        if failed:
            raise RuntimeError(f"ranks {failed} failed")
    feed.check_batches = gathered_check_batches(cell, seed, feed.check_batches, device, world)
    return feed


def gathered_check_batches(cell, seed: int, own: List[dict], device, world: int) -> List[dict]:
    """Each check step's batch over every rank, rows in rank order: rank 0's
    own, the others' remade from their seeds (the pools are made from the
    seed alone, and a rank's check batches are its pool's first ones)."""
    parts = [own]
    for rank in range(1, world):
        pool = base.make_pool(cell.config, cell.traffic, rank_seed(seed, rank), device)
        parts.append([pool[k] for k in range(len(own))])
        del pool
    return [{key: torch.cat([p[k][key] for p in parts]) for key in own[k]}
            for k in range(len(own))]


# -- the reference over the gathered rows -------------------------------------------
def train_steps_chunked(config: dict, params0: Dict[str, torch.Tensor], batches: List[dict],
                        chunk: int, precision: str = "fp32",
                        fault: Optional[str] = None) -> dict:
    """``reference/clip.py``'s ``train_steps`` over batches too large to
    differentiate at once: per step, the embeddings of every ``chunk`` rows
    without a graph, the InfoNCE and its gradient with respect to them and
    the logit scale, then each chunk's embeddings again with a graph,
    back-propagated from its rows of that gradient. Each chunk is one rank's
    rows. ``fault``: ``half_batch`` (the loss over the first half of the
    rows), ``adamw_noop`` (no parameter moves), ``no_gather`` (each rank's
    InfoNCE over its own rows alone, the gradients averaged over the ranks:
    the embeddings are not gathered) or ``no_exchange`` (rank 0's InfoNCE
    over its own rows and its gradient alone: nothing crosses the ranks)."""
    gc_cfg = config.get("grad_clip") or {}
    opt = config["optimizer"]["kwargs"]
    b1, b2 = opt["betas"]
    eps, base_wd = opt["eps"], opt["weight_decay"]
    net = ref.Net(config, precision)
    P = {n: t.detach().clone().requires_grad_(not ref.frozen(n)) for n, t in params0.items()}
    train = [n for n in P if not ref.frozen(n)]
    mu = {n: torch.zeros_like(P[n]) for n in train}
    nu = {n: torch.zeros_like(P[n]) for n in train}
    losses, grad = [], {}

    def clamp_scale():
        if gc_cfg.get("type") == "logit_scale_param_value":
            P["logit_scale"].clamp_(gc_cfg["value"], gc_cfg["max_value"])

    def embed(batch, rows, temperature):
        return (net.image_embedding(P, batch["image"][rows], temperature),
                net.text_embedding(P, batch["tokens"][rows], batch["pad_mask"][rows],
                                   temperature))

    for step, batch in enumerate(batches, start=1):
        temperature = ref.fdt_temperature(config, step) if net.fdt else 1.0
        n_rows = batch["image"].shape[0]
        chunks = [slice(i, min(i + chunk, n_rows)) for i in range(0, n_rows, chunk)]
        with torch.no_grad():
            parts = [embed(batch, rows, temperature) for rows in chunks]
        img = torch.cat([p[0] for p in parts]).requires_grad_()
        txt = torch.cat([p[1] for p in parts]).requires_grad_()
        del parts
        scale = torch.clamp_max(P["logit_scale"][0].exp(), ref.LOGIT_SCALE_MAX)
        if fault == "no_gather":
            loss = torch.stack([ref.info_nce(img[rows], txt[rows], scale, net.mm)
                                for rows in chunks]).mean()
        else:
            rows = {"half_batch": slice(0, n_rows // 2),
                    "no_exchange": chunks[0]}.get(fault, slice(None))
            loss = ref.info_nce(img[rows], txt[rows], scale, net.mm)
        d_img, d_txt, d_scale = torch.autograd.grad(loss, [img, txt, P["logit_scale"]])
        for p in P.values():
            p.grad = None
        P["logit_scale"].grad = d_scale
        for rows in chunks:
            e_img, e_txt = embed(batch, rows, temperature)
            torch.autograd.backward([e_img, e_txt], [d_img[rows], d_txt[rows]])
            del e_img, e_txt
        grads = [P[n].grad for n in train]
        losses.append(float(loss.detach()))
        lr = ref.learning_rate(config, step)
        with torch.no_grad():
            clamp_scale()
            for n, g in zip(train, grads):
                g = torch.zeros_like(P[n]) if g is None else g
                if step == 1:
                    grad[n] = g.cpu()
                if fault == "adamw_noop":
                    continue
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (mu[n] / (1 - b1 ** step)) / ((nu[n] / (1 - b2 ** step)).sqrt() + eps)
                P[n].sub_(lr * (update + ref.weight_decay(n, base_wd) * P[n]))
            clamp_scale()
        for p in P.values():
            p.grad = None
        del loss, grads, img, txt
    for n in P:
        grad.setdefault(n, torch.zeros_like(P[n], device="cpu"))
    return {"loss": losses, "grad": grad,
            "grad_norm": {n: float(g.norm()) for n, g in grad.items()},
            "change": {n: (P[n].detach() - params0[n]).cpu() for n in P}}


def reference_readings(cell, seed: int, batches: List[dict], device, precision: str = "fp32",
                       fault: Optional[str] = None) -> dict:
    ref.exact_fp32()
    params0 = ref.init_params(cell.config, seed, device)
    out = train_steps_chunked(cell.config, params0, batches, cell.traffic["batch_size"],
                              precision, fault)
    del params0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def calibrate(cell, seed: int, variants, device, process_start: float, seconds: float):
    """The compared numbers of the program's check steps (no window) and of
    the reference's variants in its place: ``fp8`` (the control), or a fault
    of :func:`train_steps_chunked`; one row per variant."""
    if device.type == "cpu":
        cell = cpu_cell(cell)
    feed = train_program(cell, seed, 0.0, False, device, process_start)
    want = reference_readings(cell, seed, feed.check_batches, device)
    rows = []
    for variant in variants:
        if variant == "program":
            got = feed.readings
        else:
            got = reference_readings(cell, seed, feed.check_batches, device,
                                     "fp8" if variant == "fp8" else "fp32",
                                     None if variant == "fp8" else variant)
        rows.append({"variant": variant, **base.gaps(got, want), "loss": got["loss"],
                     "ref_loss": want["loss"], "worst": base.worst_leaves(got, want)})
    return rows


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    if device.type == "cpu":
        cell = cpu_cell(cell)
    world = int(cell.entry["chips"])
    feed = train_program(cell, seed, seconds, trace, device, process_start)
    want = reference_readings(cell, seed, feed.check_batches, device)
    found = base.gaps(feed.readings, want)
    checks = {k: {"value": found[k], "limit": v} for k, v in cell.limits.items()}
    window = feed.window
    pairs = window["steps"] * cell.traffic["batch_size"] * world
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank > 0 of a data-parallel cell")
    p.add_argument("--spec", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    train_rank(spec["config"], spec["traffic"], args.rank, args.world, args.port, args.seed,
               args.seconds, bool(args.trace), torch.device(args.device), time.perf_counter())
    return 0


if __name__ == "__main__":
    sys.exit(main())
