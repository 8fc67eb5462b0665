"""The port's data parallelism on the CPU, over Gloo: ``parallel/mesh.py``,
the sharded InfoNCE and its ``AllGather``, the Solver under DDP with synced
context buckets, the data-parallel encoder and eval CLI, and the launchers.

The ranks are real processes. A module-wide group of two (``Cluster``,
started from torchrun's environment variables) runs the rank side,
``test_torch_port_dist_ranks.py``, job by job; the test process holds the
results against JAX (the sharded loss under ``shard_map`` on 2 of the
conftest's CPU devices, the bucket choice) or against the port's
one-process path, which the other ``test_torch_port_*`` files hold against
JAX. Each group binds a fresh free port on 127.0.0.1, every wait on a
process has a time limit, and a dead rank fails the other's next collective
after ``GROUP_TIMEOUT`` seconds.

Tolerances (fp32): the sharded loss and its gradients 1e-6 of JAX's; the
DDP step's loss 1e-6, its gradients 1e-5 of each tensor's largest and its
parameters 1e-5 of one process's step on the whole batch (the ranks' halves
sum the same products in other orders; elements whose gradient is rounding
noise 2 lr, see the test); the ranks among themselves, bit for bit; the
encoder 1e-6 of one process's.
"""
import json
import multiprocessing
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from iterated_learning_for_vlm_tpu.data import pipeline as jpipe
from iterated_learning_for_vlm_tpu.train.loss import clip_info_nce_sharded as j_sharded
from iterated_learning_for_vlm_tpu_torch import cli_entry
from iterated_learning_for_vlm_tpu_torch.data import pipeline as pipe
from iterated_learning_for_vlm_tpu_torch.data.synthetic import SyntheticClipData
from iterated_learning_for_vlm_tpu_torch.eval import cli as pcli
from iterated_learning_for_vlm_tpu_torch.eval.model_loader import load_eval_encoder
from iterated_learning_for_vlm_tpu_torch.parallel import mesh
from iterated_learning_for_vlm_tpu_torch.tools.make_train_shards import write_shards
from iterated_learning_for_vlm_tpu_torch.train.checkpoint import restore_checkpoint
from iterated_learning_for_vlm_tpu_torch.train.solver import Solver, fdt_temperature
from iterated_learning_for_vlm_tpu_torch.utils.config import Config, load_config
import test_torch_port_dist_ranks as ranks
from test_torch_port_eval import (CLI_CASES, _argv, assert_decisions, ckpts, cli_data,  # noqa: F401
                                  record_encoders)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"clip_fdt": REPO / "configs" / "clip_fdt_tiny_cpu_cluster.yaml",
           "clip": REPO / "configs" / "clip_tiny_cpu_cluster.yaml"}
WORLD = 2
GROUP_TIMEOUT = 60  # s: a collective waits this long for a dead or stuck rank
JOB_TIMEOUT = 120  # s: a job on every rank, the group's timeout included
ATOL = 1e-6
# the DDP step's averaged gradients against one process's, relative to each
# tensor's largest: fp32 sums of the same terms in other orders (measured
# <= 8e-7 with 2 threads a rank)
GRAD_RTOL = 1e-5
# a gradient this small is rounding noise of the step's sums (fp32 sums of
# terms up to ~10): AdamW's normalised update no longer follows it
NOISE_GRAD = 1e-6


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Cluster:
    """``WORLD`` rank processes in one Gloo group, each running
    ``ranks.serve``; :meth:`run` sends every rank the same job."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self.conns, self.procs = [], []
        for rank in range(WORLD):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=ranks.serve, args=(rank, WORLD, port, theirs,
                                                         GROUP_TIMEOUT), daemon=True)
            proc.start()
            theirs.close()
            self.conns.append(ours)
            self.procs.append(proc)

    def run(self, job: str, **kwargs) -> list:
        for conn in self.conns:
            conn.send((job, kwargs))
        out = []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(JOB_TIMEOUT):
                self.close()
                pytest.fail(f"rank {rank}: {job} did not end within {JOB_TIMEOUT} s")
            status, value = conn.recv()
            if status != "ok":
                pytest.fail(f"rank {rank}: {job} raised\n{value}")
            out.append(value)
        return out

    def close(self):
        for conn in self.conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for proc in self.procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster()
    yield c
    c.close()


def _config(name, **overrides):
    cfg = load_config(str(CONFIGS[name])).to_dict()
    for key, value in overrides.items():
        cfg[key] = value
    return cfg


# -- 1-2. the sharded InfoNCE and AllGather against JAX and the global loss ---------------
def _embeds(b, d, seed, ties):
    rng = np.random.default_rng(seed)
    img, txt = (rng.standard_normal((WORLD * b, d)).astype(np.float32) for _ in range(2))
    if ties:  # pairs of equal rows: every logit ties with its twin's
        img[1::2], txt[1::2] = img[0::2], txt[0::2]
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    return img, txt


@pytest.mark.parametrize("reference_scale,ties", [(1.0, False), (2.0, False), (1.0, True)])
def test_sharded_loss_matches_jax(cluster, reference_scale, ties):
    """At W = 2, b = 8, D = 16: the loss and accuracies (means over the
    ranks) and the embeddings' gradients equal JAX's ``shard_map`` form
    within 1e-6. A rank's backward of its own loss gives W times JAX's
    gradient of the global mean: DDP's mean over the ranks takes it back."""
    img, txt = _embeds(8, 16, 3 + int(ties), ties)
    scale = 10.0
    jmesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def f(i, t):
        loss, m = j_sharded(i, t, scale, axis_name="data", reference_scale=reference_scale)
        return loss, m["acc1"], m["acc5"]

    specs = dict(mesh=jmesh, in_specs=(P("data"), P("data")))
    loss, acc1, acc5 = jax.jit(shard_map(f, out_specs=(P(), P(), P()), **specs))(
        jnp.asarray(img), jnp.asarray(txt))
    grads = jax.jit(jax.grad(shard_map(lambda a, b: f(a, b)[0], out_specs=P(), **specs),
                             argnums=(0, 1)))(jnp.asarray(img), jnp.asarray(txt))
    got = cluster.run("sharded_loss", image=img, text=txt, scale=scale,
                      reference_scale=reference_scale)
    for r in got:
        assert r["loss"] == pytest.approx(float(loss), abs=ATOL)
        assert r["acc1"] == pytest.approx(float(acc1), abs=ATOL)
        assert r["acc5"] == pytest.approx(float(acc5), abs=ATOL)
    assert got[0]["local_loss"] != got[1]["local_loss"]
    for key, want in zip(("grad_image", "grad_text"), grads):
        np.testing.assert_allclose(np.concatenate([r[key] for r in got]) / WORLD,
                                   np.asarray(want), atol=ATOL, rtol=0)
    if ties:  # the twins' ranks count against the label: JAX's rule
        assert float(acc1) <= 50.0


@pytest.mark.parametrize("b,d", [(1, 3), (4, 16)])
def test_all_gather_backward_is_the_global_gradient(cluster, b, d):
    """Each rank's loss reads every rank's rows through ``AllGather``; the
    gradient each rank gets on its rows equals the one-process gradient of
    the sum of the ranks' losses within 1e-6, and the forward is the
    concatenation in rank order."""
    rng = np.random.default_rng(b * 100 + d)
    x = rng.standard_normal((WORLD * b, d)).astype(np.float32)
    weights = rng.standard_normal((WORLD, WORLD * b, d)).astype(np.float32)
    got = cluster.run("all_gather_grad", x=x, weights=weights)
    xt = torch.from_numpy(x).requires_grad_()
    sum(((torch.from_numpy(w) * xt ** 3).sum() for w in weights)).backward()
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["gathered"], x)
        np.testing.assert_allclose(r["grad"], xt.grad[rank * b:(rank + 1) * b].numpy(),
                                   atol=ATOL, rtol=0)


# -- 3. the DDP step against the one-process step ------------------------------------------
@pytest.mark.parametrize("name", ["clip_fdt", "clip"])
def test_ddp_step_matches_one_process(cluster, name, tmp_path):
    """Two ranks each take half of a fixed global batch of 8 through the
    Solver's step under DDP; one process takes all 8. The loss within 1e-6;
    every averaged gradient within ``GRAD_RTOL`` of its tensor's largest (``None``
    where one process's is: the frozen ``conv1`` and the leaves the FDT
    forward never reads); the ranks bit for bit. Every parameter after the step is within 1e-5 where
    both gradients are at least ``NOISE_GRAD``; below it, within 2 lr:
    AdamW's first step moves an element by lr g / (|g| + eps), so a gradient
    at rounding level (the key block of ``in_proj_bias`` is analytically 0)
    moves it by up to lr either way (the bound of the repo's port-vs-JAX
    step tests)."""
    cfg = _config(name)
    batch = SyntheticClipData(batch_size=8, image_size=32, context_length=16).batch(0)
    got = cluster.run("ddp_step", config=cfg, batch=batch, out=str(tmp_path / "ddp"))
    one = Solver(Config(_config(name)), output_path=str(tmp_path / "one"), exp_name="one",
                 batch_size=8, device="cpu")
    temperature = fdt_temperature(1, cfg.get("t_decay"), 100.0) if one.is_fdt else 0.0
    metrics = one.train_step(one.state, {k: torch.from_numpy(v) for k, v in batch.items()},
                             temperature)
    assert [r["wrapped"] for r in got] == ["DistributedDataParallel"] * WORLD
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["loss"] == pytest.approx(metrics["loss"].item(), abs=ATOL)
    assert got[0]["acc1"] == pytest.approx(metrics["acc1"].item(), abs=ATOL)
    lr = metrics["lr"]
    worst = {"grad": 0.0, "param": 0.0, "param_at_noise": 0.0}
    at_noise = 0
    for n, p in one.params.items():
        for key in ("params", "grads"):
            if got[0][key][n] is not None:
                np.testing.assert_array_equal(got[1][key][n], got[0][key][n], err_msg=n)
        g, g_one = got[0]["grads"][n], p.grad
        assert (g is None) == (g_one is None), n
        if g is None:
            g = g_one = np.zeros(p.shape, np.float32)
        else:
            g_one = g_one.numpy()
            err = float(np.abs(g - g_one).max() / max(float(np.abs(g_one).max()), 1e-30))
            worst["grad"] = max(worst["grad"], err)
        diff = np.abs(got[0]["params"][n] - p.detach().numpy())
        noise = (np.minimum(np.abs(g), np.abs(g_one)) < NOISE_GRAD) & ((g != 0) | (g_one != 0))
        at_noise += int(noise.sum())
        worst["param"] = max(worst["param"], float(diff[~noise].max(initial=0.0)))
        worst["param_at_noise"] = max(worst["param_at_noise"], float(diff[noise].max(initial=0.0)))
    print(f"{name}: largest differences from one process: gradients {worst['grad']:.3e} of "
          f"their tensor's largest; parameters {worst['param']:.3e}, and "
          f"{worst['param_at_noise']:.3e} at the {at_noise} elements whose gradient is nonzero "
          f"and under {NOISE_GRAD} (lr {lr:.3e})")
    assert worst["grad"] <= GRAD_RTOL
    assert worst["param"] <= 1e-5
    assert worst["param_at_noise"] <= 2 * lr


@pytest.mark.parametrize("name", ["clip_fdt", "clip"])
def test_ddp_step_replays_the_eager_step(cluster, name, tmp_path):
    """Three DDP steps through the graph key's path (eager, capture, replay;
    on the CPU a stand-in of the graph, with the group's collectives taken
    as a graph holds NCCL's) equal three eager DDP steps bit for bit: every
    loss, accuracy and gradient, and the parameters after them, on each
    rank; the ranks bit for bit. Each step reduces the gradients once: it
    never enters ``DistributedDataParallel.forward`` (whose reducer would
    average them again), and issues four ``all_reduce`` calls (the
    metrics', the two gathers' backward, and one bucket of every gradient
    element), plus, at the first step, the ranks' agreement on which
    parameters get one. Against one process's step on the whole batch from
    each step's pre-step state (rank 0's checkpoint; free-running, the
    FDT loss drifts ~1e-5 from one process's by the second step, as AdamW
    follows gradients at rounding level): each loss within 1e-6 and each
    step's gradients within ``GRAD_RTOL`` of their tensor's largest, as one
    step is held above."""
    cfg = _config(name)
    data = SyntheticClipData(batch_size=8, image_size=32, context_length=16)
    batches = [data.batch(k) for k in range(3)]
    graphed = cluster.run("ddp_steps", config=cfg, batches=batches,
                          out=str(tmp_path / "graphed"), graphed=True)
    eager = cluster.run("ddp_steps", config=cfg, batches=batches,
                        out=str(tmp_path / "eager"), graphed=False)
    assert [r["modes"] for r in graphed] == [(1, 1, 1)] * WORLD
    assert [r["modes"] for r in eager] == [(3, 0, 0)] * WORLD
    for g, e in zip(graphed, eager):
        assert g["wrapped"] == "DistributedDataParallel"
        assert (g["loss"], g["acc1"]) == (e["loss"], e["acc1"])
        for k in range(3):
            for n, grad in e["grads"][k].items():
                if grad is None:
                    assert g["grads"][k][n] is None, n
                else:
                    np.testing.assert_array_equal(g["grads"][k][n], grad, err_msg=n)
        for n, p in e["params"].items():
            np.testing.assert_array_equal(g["params"][n], p, err_msg=n)
            np.testing.assert_array_equal(graphed[1]["params"][n], p, err_msg=n)
        assert g["forward_entries"] == 0
        n_grad = sum(x.size for x in e["grads"][0].values() if x is not None)
        for k, sizes in enumerate(g["reduces"]):
            assert sizes[0] == 3 and sizes[1] == sizes[2], sizes
            assert sizes[3:] == ([len(g["params"])] if k == 0 else []) + [n_grad], sizes
    one = Solver(Config(_config(name)), output_path=str(tmp_path / "one"), exp_name="one",
                 batch_size=8, device="cpu")
    worst = 0.0
    for k, batch in enumerate(batches, start=1):
        restore_checkpoint(str(tmp_path / "graphed" / f"pre{k}.pth"), one.model, one.state)
        temperature = fdt_temperature(k, cfg.get("t_decay"), 100.0) if one.is_fdt else 0.0
        metrics = one.train_step(one.state, {key: torch.from_numpy(v) for key, v in batch.items()},
                                 temperature)
        assert graphed[0]["loss"][k - 1] == pytest.approx(metrics["loss"].item(), abs=ATOL), k
        for n, p in one.params.items():
            g = graphed[0]["grads"][k - 1][n]
            assert (g is None) == (p.grad is None), n
            if g is not None:
                g_one = p.grad.numpy()
                err = float(np.abs(g - g_one).max() / max(float(np.abs(g_one).max()), 1e-30))
                worst = max(worst, err)
    print(f"{name}: the gradients of the three steps within {worst:.3e} of one process's "
          "from the same pre-step state")
    assert worst <= GRAD_RTOL


# -- 4. Solver.train() on two ranks: synced buckets, an IL reset, rank-0 writes, resume ------
def long_every_seventh(k, caption):
    """Every seventh caption three times over (past the 8-token bucket); the
    rest cut to four words (6 tokens), so the ranks' batches often disagree
    on their own bucket."""
    return " ".join([caption] * 3) if k % 7 == 0 else " ".join(caption.split()[:4])


@pytest.fixture(scope="module")
def dist_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_shards")
    write_shards(str(root), 4, 16, image_size=32, num_classes=16, caption_fn=long_every_seventh)
    return str(root / "{00000..00003}.tar")


def test_two_rank_solver_trains_and_resumes(cluster, dist_shards, tmp_path):
    """CLIP-FDT from shards on two ranks with ``context_buckets_sync`` and the
    IL reset at step 8: every step's context is the same on both ranks and is
    JAX's bucket of the longer of the ranks' longest captions; the ranks'
    parameters are bit for bit equal after the reset and at the end; only
    rank 0 writes the log file, ``metrics.jsonl``, ``config.json`` and the
    checkpoints; a two-rank resume from ``ckpt_6`` repeats steps 7-12 and
    the final parameters bit for bit."""
    train = {"data_path": dist_shards, "batch_size": 4, "num_samples": 64, "workers": 2,
             "transforms": "MOCOV2_single", "context_buckets": [8, 16],
             "context_buckets_sync": True, "epoch": 2}
    cfg = _config("clip_fdt", data={"train": train},
                  saver={"print_freq": 1, "val_freq": 0, "save_freq": 6})
    out = str(tmp_path / "run")
    a = cluster.run("solver_train", config=cfg, out=out, digest_after=(8,))
    steps = list(range(1, 13))
    assert [sorted(r["ctx"]) for r in a] == [steps, steps]
    assert a[0]["sync_buckets"] == [8, 16]
    disagree = 0
    for s in steps:
        lens = [r["local_len"][s] for r in a]
        want = jpipe._bucket_for_len(max(lens), 16, (8, 16)) or 16
        assert a[0]["ctx"][s] == a[1]["ctx"][s] == want, s
        own = [jpipe._bucket_for_len(n, 16, (8, 16)) or 16 for n in lens]
        disagree += own[0] != own[1]
    assert disagree, "no step where the ranks' own buckets differ: the agreement is untested"
    assert {a[0]["ctx"][s] for s in steps} == {8, 16}
    assert a[0]["loss"] == a[1]["loss"]
    assert a[0]["digest"] == a[1]["digest"] and set(a[0]["digest"]) == {8, "end"}
    root = Path(out) / "dist_Reset_True_steps_4_smooth_2"
    ckpt_dir = root / "checkpoints"
    assert a[0]["writes"] == [str(ckpt_dir / "ckpt_6.pth.tar"), str(ckpt_dir / "ckpt_12.pth.tar")]
    assert a[1]["writes"] == []
    assert a[0]["log_files"] == [str(root / "log.txt")] and a[1]["log_files"] == []
    assert a[0]["metrics_enabled"] and not a[1]["metrics_enabled"]
    assert a[0]["found"] == a[1]["found"] == str(ckpt_dir / "ckpt_12.pth.tar")
    assert sorted(os.listdir(root)) == ["checkpoints", "config.json", "log.txt", "metrics.jsonl",
                                        "results"]
    with open(root / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == steps  # one writer, once a step

    b = cluster.run("solver_train", config=cfg, out=str(tmp_path / "resume"),
                    ckpt_path=str(ckpt_dir / "ckpt_6.pth.tar"), digest_after=(8,))
    for r in b:
        assert (r["resumed_at"], r["last_step"]) == (6, 12) and sorted(r["loss"]) == steps[6:]
        assert r["loss"] == {s: a[0]["loss"][s] for s in steps[6:]}
        assert r["ctx"] == {s: a[0]["ctx"][s] for s in steps[6:]}
        assert r["digest"] == a[0]["digest"]


# -- 5. the synced bucket stream against JAX's; a loader failure ends both ranks ----------
def _mk(true_len, tag):
    pad = np.full((4, 77), -np.inf, np.float32)
    pad[:, :true_len] = 0.0
    return {"tokens": np.full((4, 77), tag, np.int32), "pad_mask": pad}


def test_synced_bucket_batches_lookahead_matches_jax():
    """With no process group: every batch, in order, cut as JAX's
    ``synced_bucket_batches`` cuts it (``test_context_bucketing.py``'s
    stream), with the lengths read from the batches or taken on the host
    side; no buckets pass the stream through."""
    import collections

    lens = [12, 40, 5]
    batches = [_mk(n, i) for i, n in enumerate(lens)]
    want = list(jpipe.synced_bucket_batches(
        iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]), (32, 77)))
    lengths = collections.deque()
    for got in (list(pipe.synced_bucket_batches(iter(batches), (32, 77))),
                list(pipe.synced_bucket_batches(pipe.caption_lengths(iter(batches), lengths),
                                                (32, 77), lengths)),
                [pipe.bucket_global_batch(b, (32, 77)) for b in batches]):
        assert [g["tokens"].shape for g in got] == [w["tokens"].shape for w in want] == [
            (4, 32), (4, 77), (4, 32)]
        assert [int(g["tokens"][0, 0]) for g in got] == [0, 1, 2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["pad_mask"], np.asarray(w["pad_mask"]))
    assert not lengths
    assert list(pipe.synced_bucket_batches(iter(batches), ())) == batches


@pytest.mark.parametrize("use_lengths", [True, False])
def test_synced_buckets_agree_across_ranks(cluster, use_lengths):
    """Two ranks whose batches disagree on their own bucket cut every batch to
    the bucket of the longer caption of both (JAX's ``_bucket_for_len`` of
    the global max), in order, one batch ahead and one at a time."""
    lens = [[12, 40, 5, 20], [30, 10, 50, 3]]
    batches = [[_mk(n, i) for i, n in enumerate(row)] for row in lens]
    got = cluster.run("synced_stream", batches=batches, use_lengths=use_lengths)
    want = [(4, jpipe._bucket_for_len(max(pair), 77, (32, 77)) or 77) for pair in zip(*lens)]
    assert want == [(4, 32), (4, 77), (4, 77), (4, 32)]
    for r in got:
        assert r["shapes"] == r["single_shapes"] == want
        assert r["first"] == [0, 1, 2, 3]


def test_loader_failure_ends_both_ranks(dist_shards, tmp_path):
    """Rank 1's loader raises at its third batch: rank 1 fails with that
    error, and rank 0, waiting in the next collective, fails too, long
    before the group's timeout, when rank 1's process ends."""
    port = free_port()
    cfg = _config("clip_fdt", data={"train": {
        "data_path": dist_shards, "batch_size": 4, "num_samples": 64, "workers": 1,
        "transforms": "MOCOV2_single", "context_buckets": [8, 16],
        "context_buckets_sync": True, "epoch": 2}}, reset={"enable": False})
    code = ("import sys, json; sys.path[:0] = {path!r}; import test_torch_port_dist_ranks as r; "
            "r.failing_run({rank}, {world}, {port}, json.loads({cfg!r}), {out!r}, fail_rank=1)")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(path=[str(REPO / "tests"), str(REPO)], rank=rank,
                                           world=WORLD, port=port, cfg=json.dumps(cfg),
                                           out=str(tmp_path))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=GROUP_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert [p.returncode for p in procs] == [1, 1], outs
    assert "decode exploded" in outs[1] and "decode exploded" not in outs[0]
    assert "RANK_FAILED" in outs[0] and "RANK_FAILED" in outs[1]


# -- 6. the data-parallel encoder and the --distributed eval CLI ----------------------------
def test_data_parallel_encoder_matches_one_process(cluster, ckpts):
    """A batch of 3 rounds up to 4 over two ranks; each rank encodes its two
    rows and gathers the others': images and texts within 1e-6 of one
    process's encoder at batch 3, on every rank."""
    rng = np.random.default_rng(5)
    images = rng.standard_normal((7, 32, 32, 3)).astype(np.float32)
    texts = SyntheticClipData(batch_size=7, image_size=32, context_length=16).batch(1)
    tokens, pad = texts["tokens"], texts["pad_mask"]
    config, ckpt = str(CONFIGS["clip_fdt"]), ckpts["fdt"][1]
    one = load_eval_encoder(config, ckpt, batch_size=3, num_workers=1, device="cpu")
    want = one.encode_images(images), one.encode_texts_tokens(tokens, pad)
    got = cluster.run("encode", config=config, checkpoint=ckpt, images=images, tokens=tokens,
                      pad_mask=pad, batch_size=3)
    for r in got:
        assert r["batch_size"] == 4
        np.testing.assert_allclose(r["images"], want[0], atol=ATOL, rtol=0)
        np.testing.assert_allclose(r["texts"], want[1], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(r["images"], got[0]["images"])


@pytest.mark.parametrize("case", ["dummy", "wds", "retrieval"])
def test_distributed_cli_matches_one_process(cluster, case, cli_data, ckpts, monkeypatch,
                                             tmp_path):
    """``--distributed`` on two ranks against the one-process CLI on the same
    checkpoint and data (zero-shot classification and retrieval): every
    encoder output within 1e-6, the scores of every decision within
    ``test_torch_port_eval.py``'s tolerance and apart by more than twice it,
    hence the same record on both ranks; rank 0 alone prints and writes it."""
    args, scores, tol = CLI_CASES[case]
    ckpt = ckpts["fdt"][1]
    logs = record_encoders(monkeypatch)
    want = pcli.main(_argv(args, cli_data, ckpt, tmp_path / "one") + ["--device", "cpu"])
    argv = _argv(args, cli_data, ckpt, tmp_path / "dist") + ["--device", "cpu", "--distributed"]
    got = cluster.run("eval_cli", argv=argv)
    for r in got:
        assert r["result"] == want
        assert [k for k, _ in r["log"]] == [k for k, _ in logs["port"]]
        for (_, w), (_, g) in zip(logs["port"], r["log"]):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        for w, g in zip(scores(logs["port"]), scores(r["log"])):
            assert_decisions(w, g, tol)
    assert json.loads(got[0]["stdout"]) == want and got[1]["stdout"] == ""
    assert got[0]["dumps"] == 1 and got[1]["dumps"] == 0
    [name] = os.listdir(tmp_path / "dist")
    assert json.loads((tmp_path / "dist" / name).read_text()) == want


# -- 7. the launchers -----------------------------------------------------------------------
def test_coordinator_needs_process_flags(capsys):
    """``--coordinator`` without ``--num_processes`` and ``--process_id`` is
    JAX's parser error (``scripts/train.py:44``)."""
    for extra in ([], ["--num_processes", "2"], ["--process_id", "0"]):
        with pytest.raises(SystemExit) as err:
            cli_entry.train_main(["--config", "x.yaml", "--output_path", "o", "--multihost",
                                  "--coordinator", "127.0.0.1:1"] + extra)
        assert err.value.code == 2
        assert "--coordinator requires --num_processes and --process_id" in capsys.readouterr().err


def test_nccl_refuses_more_local_ranks_than_cards(monkeypatch):
    """Two local ranks under NCCL on fewer than two cards raise before any
    group exists and name ``--dist_backend gloo``; no fallback."""
    for key, value in ranks.torchrun_env(0, 2, free_port()).items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dist_backend gloo"):
        mesh.init_data_parallel("nccl")
    assert not mesh.initialized()
    assert mesh.default_backend("cpu") == "gloo" and mesh.default_backend() == "nccl"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.local_device()


@pytest.mark.parametrize("launch", ["torchrun", "coordinator"])
def test_launcher_trains_two_ranks(launch, tmp_path):
    """The training launcher as a user runs it, two CPU ranks, through
    ``python -m torch.distributed.run ... --multihost`` or the ``--coordinator``
    flags: both end, rank 0 alone writes ``log.txt``, which reports a world
    of 2 and the same losses both ranks logged to stderr."""
    out = tmp_path / "out"
    base = ["-m", "iterated_learning_for_vlm_tpu_torch.cli_entry", "--config",
            str(CONFIGS["clip"]), "--output_path", str(out), "--device", "cpu", "--multihost"]
    env = {k: v for k, v in os.environ.items() if k not in ranks.torchrun_env(0, 1, 0)}
    if launch == "torchrun":
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(WORLD)] + base]
    else:
        port = free_port()
        cmds = [[sys.executable] + base + ["--coordinator", f"127.0.0.1:{port}",
                                           "--num_processes", str(WORLD), "--process_id", str(r)]
                for r in range(WORLD)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=JOB_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert [p.returncode for p in procs] == [0] * len(procs), logs
    root = out / "run_Reset_False_steps_0_smooth_0"
    text = (root / "log.txt").read_text()
    assert "world 2" in text
    mine = re.findall(r"Iter \[\d+/6\] loss \S+", text)
    assert len(mine) == 6
    stderr = "".join(logs)
    for line in mine:  # rank 1 logged each step's loss too, to stderr only
        assert stderr.count(line) == WORLD, line


@pytest.mark.parametrize("data", ["synthetic", "shards"])
def test_group_of_one_is_the_one_process_path(data, dist_shards, tmp_path):
    """A Gloo group of one process (the production launch on one card): the
    Solver trains through DDP and the sharded loss, and from shards with
    ``context_buckets_sync`` through the bucket agreement, bit for bit as
    with no group."""
    overrides = {}
    if data == "shards":
        overrides["data"] = {"train": {
            "data_path": dist_shards, "batch_size": 4, "num_samples": 48, "workers": 1,
            "transforms": "MOCOV2_single", "context_buckets": [8, 16],
            "context_buckets_sync": True, "epoch": 1}}
        overrides["lr_scheduler"] = {"type": "Cosine", "kwargs": {
            "base_lr": 0.0005, "warmup_lr": 0.005, "min_lr": 0.0, "warmup_steps": 2,
            "max_iter": 12}}

    def run(out):
        s = Solver(Config(_config("clip_fdt", **overrides)), output_path=str(out),
                   exp_name="w1", device="cpu")
        losses = []
        step = s.train_step

        def spy(state, batch, temperature):
            metrics = step(state, batch, temperature)
            losses.append((batch["tokens"].shape[1], metrics["loss"].item()))
            return metrics

        s.train_step = spy
        s.train()
        return (type(s.train_model).__name__, list(s._sync_buckets), losses,
                {n: p.detach().clone() for n, p in s.params.items()})

    plain = run(tmp_path / "plain")
    env = ranks.torchrun_env(0, 1, free_port())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert mesh.init_data_parallel("gloo") == (0, 1)
        grouped = run(tmp_path / "group")
    finally:
        import torch.distributed as dist

        if mesh.initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert (plain[0], grouped[0]) == ("CLIPFDT", "DistributedDataParallel")
    assert (plain[1], grouped[1]) == (([], [8, 16]) if data == "shards" else ([], []))
    assert grouped[2] == plain[2] and len(plain[2]) == 12
    if data == "shards":
        assert {ctx for ctx, _ in plain[2]} == {8, 16}
    for n, p in plain[3].items():
        assert torch.equal(grouped[3][n], p), n


def test_eval_launcher_runs_two_ranks(tmp_path):
    """``python -m torch.distributed.run ... -m ...eval.cli ... --distributed``:
    the CLI joins the launcher's group itself, both ranks end, and rank 0
    alone prints the record, equal to the one-process CLI's."""
    argv = ["eval", "--model_config", str(CONFIGS["clip"]), "--dataset", "dummy", "--device",
            "cpu", "--batch_size", "4", "--num_workers", "1", "--quiet"]
    want = pcli.main(argv + ["--output", str(tmp_path / "one" / "r.json")])
    env = {k: v for k, v in os.environ.items() if k not in ranks.torchrun_env(0, 1, 0)}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(WORLD), "-m", "iterated_learning_for_vlm_tpu_torch.eval.cli"] + argv
        + ["--distributed", "--output", str(tmp_path / "dist" / "r.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=JOB_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    records = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert records == [want]
    assert json.loads((tmp_path / "dist" / "r.json").read_text()) == want
