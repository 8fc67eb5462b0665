"""The rank side of ``test_torch_port_dist.py``: what each process of a Gloo
group on the CPU runs. It imports the port only (no JAX), so a rank starts in
a few seconds; it holds no tests.

:func:`serve` joins the group from torchrun's environment variables (set
here as torchrun sets them) and runs the jobs the test process sends over a
pipe, one at a time, each rank the same job: ``(name, kwargs)`` in,
``("ok", result)`` or ``("error", traceback)`` out; ``None`` ends it.
"""
import collections
import contextlib
import hashlib
import io
import json
import logging
import os
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from iterated_learning_for_vlm_tpu_torch.data import pipeline as pipe
from iterated_learning_for_vlm_tpu_torch.eval import cli as pcli
from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
from iterated_learning_for_vlm_tpu_torch.parallel import mesh
from iterated_learning_for_vlm_tpu_torch.train import checkpoint as ckpt
from iterated_learning_for_vlm_tpu_torch.train.loss import AllGather, clip_info_nce_sharded
from iterated_learning_for_vlm_tpu_torch.train.solver import Solver, fdt_temperature
from iterated_learning_for_vlm_tpu_torch.utils.config import Config


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """The variables ``python -m torch.distributed.run`` gives rank ``rank``."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def serve(rank: int, world: int, port: int, conn, timeout_s: float) -> None:
    os.environ.update(torchrun_env(rank, world, port))
    torch.set_num_threads(2)
    mesh.init_data_parallel("gloo", timeout=timedelta(seconds=timeout_s))
    try:
        while True:
            job = conn.recv()
            if job is None:
                return
            name, kwargs = job
            try:
                conn.send(("ok", globals()[name](**kwargs)))
            except BaseException:  # noqa: BLE001 — reported to the test, which fails
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def rows(x: np.ndarray) -> torch.Tensor:
    """This rank's contiguous rows of a global array."""
    rank, world = mesh.data_rank_world()
    b = len(x) // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * b:(rank + 1) * b]))


def digest(params) -> str:
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# -- jobs ----------------------------------------------------------------------------------
def sharded_loss(image, text, scale, reference_scale):
    img = rows(image).requires_grad_()
    txt = rows(text).requires_grad_()
    loss, metrics = clip_info_nce_sharded(img, txt, torch.tensor(scale),
                                          reference_scale=reference_scale)
    loss.backward()
    return {"local_loss": loss.item(), **{k: v.item() for k, v in metrics.items()},
            "grad_image": img.grad.numpy(), "grad_text": txt.grad.numpy()}


def all_gather_grad(x, weights):
    """Rank r's loss is sum(w_r * gathered**3): every rank's loss reads every
    rank's rows."""
    mine = rows(x).requires_grad_()
    gathered = AllGather.apply(mine)
    w = torch.from_numpy(weights[mesh.data_rank_world()[0]])
    (w * gathered ** 3).sum().backward()
    return {"gathered": gathered.detach().numpy(), "grad": mine.grad.numpy()}


def ddp_step(config, batch, out):
    """One step of the Solver's train step, through DDP, on this rank's rows."""
    s = Solver(Config(config), output_path=out, exp_name="ddp", device="cpu")
    temperature = fdt_temperature(1, config.get("t_decay"), 100.0) if s.is_fdt else 0.0
    metrics = s.train_step(s.state, {k: rows(v) for k, v in batch.items()}, temperature)
    return {"loss": metrics["loss"].item(), "acc1": metrics["acc1"].item(),
            "wrapped": type(s.train_model).__name__,
            "params": {n: p.detach().numpy().copy() for n, p in s.params.items()},
            "grads": {n: None if p.grad is None else p.grad.numpy().copy()
                      for n, p in s.params.items()}}


def ddp_steps(config, batches, out, graphed):
    """The Solver's step under DDP on this rank's rows of each of
    ``batches``, one step a batch. ``graphed``: through the graph key's path
    (eager, capture, replays), with the CPU stand-in of a graph
    (``torch_port_graph_stub.StubGraph``) and the group's collectives taken
    as a graph holds NCCL's; else every step eagerly, as over Gloo. Rank 0
    writes each step's pre-step checkpoint to ``out/pre<k>.pth``. Spies
    count each step's ``all_reduce`` calls and their elements, and the
    entries of ``DistributedDataParallel.forward``."""
    from torch.nn.parallel import DistributedDataParallel

    from iterated_learning_for_vlm_tpu_torch.ops import graphs
    from iterated_learning_for_vlm_tpu_torch.train import step as step_mod
    from torch_port_graph_stub import StubGraph

    reduces, entries = [], []
    all_reduce, forward = dist.all_reduce, DistributedDataParallel.forward
    saved = graphs.Graph, step_mod.graphs_hold_collectives

    def counted_all_reduce(tensor, *a, **k):
        reduces[-1].append(tensor.numel())
        return all_reduce(tensor, *a, **k)

    def counted_forward(self, *a, **k):
        entries.append(1)
        return forward(self, *a, **k)

    dist.all_reduce, DistributedDataParallel.forward = counted_all_reduce, counted_forward
    if graphed:
        graphs.Graph, step_mod.graphs_hold_collectives = StubGraph, lambda group=None: True
    try:
        s = Solver(Config(config), output_path=out, exp_name="ddp", device="cpu")
        rec = {"loss": [], "acc1": [], "grads": []}
        for k, batch in enumerate(batches, start=1):
            if mesh.is_main():
                torch.save(ckpt.checkpoint_dict(s.model, s.state, s.state.step),
                           os.path.join(out, f"pre{k}.pth"))
            reduces.append([])
            temperature = fdt_temperature(k, config.get("t_decay"), 100.0) if s.is_fdt else 0.0
            metrics = s.train_step(s.state, {key: rows(v) for key, v in batch.items()},
                                   temperature)
            rec["loss"].append(metrics["loss"].item())
            rec["acc1"].append(metrics["acc1"].item())
            rec["grads"].append({n: None if p.grad is None else p.grad.numpy().copy()
                                 for n, p in s.params.items()})
    finally:
        dist.all_reduce, DistributedDataParallel.forward = all_reduce, forward
        graphs.Graph, step_mod.graphs_hold_collectives = saved
    graphs_ = s.train_step.graphs
    rec.update(params={n: p.detach().numpy().copy() for n, p in s.params.items()},
               modes=(graphs_.eager, graphs_.captures, graphs_.replays),
               reduces=reduces, forward_entries=len(entries),
               wrapped=type(s.train_model).__name__)
    return rec


def solver_train(config, out, ckpt_path=None, digest_after=()):
    """``Solver.train()`` with spies: each step's context, this rank's longest
    caption and the loss; parameter digests after the IL step(s)
    ``digest_after`` and at the end; what this rank wrote."""
    rec = {"ctx": {}, "local_len": {}, "loss": {}, "digest": {}, "writes": []}
    s = Solver(Config(config), output_path=out, exp_name="dist", device="cpu",
               ckpt_path=ckpt_path)
    step_fn, on_step = s.train_step, s.il.on_step

    def spy_step(state, batch, temperature):
        step = state.step + 1
        rec["ctx"][step] = batch["tokens"].shape[1]
        rec["local_len"][step] = int((batch["pad_mask"] == 0).sum(1).max())
        metrics = step_fn(state, batch, temperature)
        rec["loss"][step] = metrics["loss"].item()
        return metrics

    def spy_il(state, step):
        state = on_step(state, step)
        if step in digest_after:
            rec["digest"][step] = digest(s.params)
        return state

    write = ckpt._write

    def spy_write(payload, targets):
        rec["writes"].extend(targets)
        return write(payload, targets)

    s.train_step, s.il.on_step, ckpt._write = spy_step, spy_il, spy_write
    try:
        s.train()
    finally:
        ckpt._write = write
    rec["digest"]["end"] = digest(s.params)
    rec["resumed_at"], rec["last_step"] = s._last_iter, s.state.step
    rec["metrics_enabled"] = s.metrics_writer.enabled
    rec["log_files"] = [h.baseFilename for h in logging.getLogger("ilvlm_torch").handlers
                        if isinstance(h, logging.FileHandler)]
    rec["found"] = ckpt.find_last_checkpoint(s.save_path)
    rec["sync_buckets"] = list(s._sync_buckets)
    return rec


def synced_stream(batches, use_lengths):
    """``synced_bucket_batches`` over this rank's batches (numpy), with the
    lengths taken on the host side or read from the batches."""
    mine = batches[mesh.data_rank_world()[0]]
    lengths = None
    it = iter(mine)
    if use_lengths:
        lengths = collections.deque()
        it = pipe.caption_lengths(it, lengths)
    out = list(pipe.synced_bucket_batches(it, (32, 77), lengths))
    single = [pipe.bucket_global_batch(b, (32, 77)) for b in mine]
    return {"shapes": [o["tokens"].shape for o in out],
            "first": [int(o["tokens"][0, 0]) for o in out],
            "single_shapes": [o["tokens"].shape for o in single]}


def encode(config, checkpoint, images, tokens, pad_mask, batch_size):
    from iterated_learning_for_vlm_tpu_torch.eval.model_loader import load_eval_encoder

    enc = load_eval_encoder(config, checkpoint, batch_size=batch_size, num_workers=1,
                            device="cpu", data_parallel=True)
    assert isinstance(enc, TorchEncoder)
    return {"batch_size": enc.batch_size, "images": enc.encode_images(images),
            "texts": enc.encode_texts_tokens(tokens, pad_mask)}


def eval_cli(argv):
    """The eval CLI in the group: its result, its stdout, how many records it
    wrote, and every encoder output."""
    log, dumps = [], []
    originals = {k: getattr(TorchEncoder, k) for k in ("encode_images", "encode_texts")}
    for kind, orig in originals.items():
        def rec(self, *a, _orig=orig, _kind=kind, **k):
            out = _orig(self, *a, **k)
            log.append((_kind, np.array(out)))
            return out
        setattr(TorchEncoder, kind, rec)
    dump = json.dump

    def counted_dump(*a, **k):
        dumps.append(1)
        return dump(*a, **k)

    json.dump = counted_dump
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            result = pcli.main(argv)
    finally:
        json.dump = dump
        for kind, orig in originals.items():
            setattr(TorchEncoder, kind, orig)
    return {"result": result, "stdout": stdout.getvalue(), "log": log, "dumps": len(dumps)}


def failing_run(rank, world, port, config, out, fail_rank):
    """Not a job: the whole life of one rank of a two-rank ``Solver.train()``
    whose loader raises on rank ``fail_rank`` at its third batch, as a
    launcher runs it. Any error prints ``RANK_FAILED`` and ends the process
    with code 1 (its sockets close, as a dead rank's do). The group's timeout
    is long, so an end within a test's time limit is not the timeout's."""
    os.environ.update(torchrun_env(rank, world, port))
    torch.set_num_threads(1)
    try:
        mesh.init_data_parallel("gloo", timeout=timedelta(seconds=600))
        s = Solver(Config(config), output_path=out, exp_name="fail", device="cpu")
        if rank == fail_rank:
            loader = s.train_data.loader_fn

            def failing(epoch):
                for i, batch in enumerate(loader(epoch)):
                    if i == 2:
                        raise RuntimeError("decode exploded")
                    yield batch

            s.train_data.loader_fn = failing
        s.train()
    except BaseException:  # noqa: BLE001 — the process ends with the error printed
        traceback.print_exc()
        print("RANK_FAILED", flush=True)
        sys.stderr.flush()
        os._exit(1)
