"""The Swin-MoE and four-card cells on the CPU: names, counts, checks and readers.

On the CPU each new loop cuts its cell itself (``cpu_cell``): the Swin-MoE
cell to a 96 px tower of window 6 with two blocks a stage and experts in
every block (eight MoE layers, so the load-balancing term weighs in the loss
as at full size), run here in float32; the four-card cell to two Gloo ranks,
here of the tiny CLIP-FDT.
"""
import copy
import time
from types import SimpleNamespace

import pytest
import torch

import flops
import flops_swin
import harness
from conftest import BENCH_DIR, tiny_config
from reference import swin_moe as ref

SWIN = "clip_swinmoe_b.train.moe.ctx32"
DDP = "fdt_b32.train.ddp4"
SEED = 2 ** 31 + 7
NEW_READERS = ["k4_roofline.train", "mfu_swinmoe.train", "moe_slot_fill.train",
               "moe_host_ms.train"]


def tiny_swin_cell():
    cell = harness.resolve(SWIN)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"]["kwargs"]["dtype"] = "float32"
    return cell


def tiny_ddp_cell():
    cell = harness.resolve(DDP)
    cell.config = tiny_config("fdt_b32")
    return cell


def test_new_cells_resolve():
    swin, ddp = harness.resolve(SWIN), harness.resolve(DDP)
    assert swin.traffic["loop"] == "train_moe" and ddp.traffic["loop"] == "train_ddp"
    assert swin.entry["chips"] == 1 and ddp.entry["chips"] == 4
    assert set(swin.limits) == set(ddp.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert set(NEW_READERS) <= set(swin.readers)
    assert not set(NEW_READERS) & set(ddp.readers)
    assert {"mfu.train", "k2_roofline.train", "k1_roofline.train"} <= set(ddp.readers)
    assert not {"mfu.train", "k2_roofline.train"} & set(swin.readers)
    assert "k2_roofline_text.train" in swin.readers
    assert swin.config["model"]["type"] == "clip_swinMoE_B"


def test_swin_flops_by_hand():
    """One image through a 2-stage tower at 16 px (patch 4: 4 x 4 tokens,
    window 2), 8 channels, one MoE block of 2 experts; written out product by
    product."""
    cfg = {"model": {"kwargs": {"image_encode": {
        "input_resolution": 16, "window_size": 2, "depths": [2, 2], "num_heads": [1, 2],
        "num_experts": 2, "moe_blocks": [[1], []], "embed_dim": 4},
        "text_encode": {"width": 8, "layers": 1, "embed_dim": 4}}}}
    ref_stage0 = ref.STAGE0_CHANNELS
    d0, d1 = ref_stage0, 2 * ref_stage0
    t0, t1 = 16, 4
    patch = 2 * 16 * 48 * d0
    block0 = 2 * t0 * d0 * 3 * d0 + 2 * 2 * t0 * 4 * d0 + 2 * t0 * d0 * d0 + 2 * 2 * t0 * d0 * 4 * d0
    gate = 2 * t0 * d0 * 2
    merge = 2 * 4 * 4 * d0 * 2 * d0
    block1 = 2 * t1 * d1 * 3 * d1 + 2 * 2 * t1 * 4 * d1 + 2 * t1 * d1 * d1 + 2 * 2 * t1 * d1 * 4 * d1
    proj = 2 * d1 * 4
    image, got_patch = flops_swin.image_fwd_flops(cfg, 1)
    assert got_patch == patch
    assert image == patch + 2 * block0 + gate + merge + 2 * block1 + proj
    text = flops._tower_fwd(1, 3, 8, 1, True) + 2 * 8 * 4 + 2 * 2 * 4 * 1
    assert flops_swin.train_step_flops(cfg, 1, 3) == 2 * patch + 3 * (image - patch + text)


def test_full_size_swin_flops():
    """Swin-MoE-B at 192 px: 23.56 GFLOP an image forward, 19.95 TFLOP a step
    of 256 pairs at ctx 32; 24 window-attention calls, N = 144 but 36 at stage 3."""
    cfg = harness.resolve(SWIN).config
    assert abs(flops_swin.image_fwd_flops(cfg, 1)[0] / 1e9 - 23.555) < 0.001
    assert abs(flops_swin.train_step_flops(cfg, 256, 32) / 1e12 - 19.949) < 0.001
    calls = flops_swin.k4_calls(cfg, 256)
    assert len(calls) == 24 and calls[1] == (4096, 144, 4, 16) and calls[-1] == (256, 36, 32, 1)
    assert sum(c[3] > 1 for c in calls) == 2  # the shifted blocks of stages 0 and 1


def test_k4_bounds_by_hand():
    """Stage 0's shifted call: 609.3 MB over 3.35 TB/s (bytes bound it) forward;
    the backward reads and writes 2.5x that."""
    w, n, h, nb = 4096, 144, 4, 16
    fwd_bytes = 2 * (w * n * 384 + w * n * 128) + 4 * nb * h * n * n
    assert fwd_bytes == 609288192
    assert flops_swin.k4_fwd_bound_s(w, n, h, nb) == fwd_bytes / flops.HBM_BPS
    bwd_bytes = 2 * (2 * w * n * 384 + w * n * 128) + 4 * (nb * h * n * n + h * n * n)
    assert flops_swin.k4_bwd_bound_s(w, n, h, nb) == bwd_bytes / flops.HBM_BPS
    # an unmasked stage-3 call is bound by bytes as well
    w, n, h = 256, 36, 32
    ops = 2 * 5 * w * h * n * n * 32
    assert flops_swin.k4_bwd_bound_s(w, n, h, 1) >= ops / flops.BF16_FLOPS


@pytest.fixture(scope="module")
def fault_rows():
    cell = tiny_swin_cell()
    rows = cell.loop.calibrate(cell, 11, ["program", "fp8", *ref.FAULTS], torch.device("cpu"),
                               time.perf_counter(), 0.5)
    return cell.limits, {r["variant"]: r for r in rows}


def test_swin_program_is_correct(fault_rows):
    limits, rows = fault_rows
    assert all(rows["program"][k] <= v for k, v in limits.items()), rows["program"]
    assert rows["program"]["routing_mismatch"] == 0.0


@pytest.mark.parametrize("variant", ["fp8", *ref.FAULTS])
def test_swin_check_fails_each_planted_fault(fault_rows, variant):
    limits, rows = fault_rows
    assert any(rows[variant][k] > v for k, v in limits.items()), rows[variant]


def test_swin_traced_run_reads_its_metrics(cpu):
    """A traced tiny run: correct; the span, counter and FLOP readers read a
    positive number; K4's roofline reads None (no card, no kernel)."""
    from iterated_learning_for_vlm_tpu_torch.utils import profiling

    cell = tiny_swin_cell()
    profiling.clear()
    outcome = cell.loop.run(cell, seed=SEED, seconds=0.3, trace=True, device=cpu,
                            process_start=time.perf_counter())
    assert all(c["value"] <= c["limit"] for c in outcome["checks"].values()), outcome["checks"]
    run = SimpleNamespace(cell=cell, **outcome)
    routed, kept, slots, largest = outcome["counters"]["moe"]
    assert routed == outcome["attempted"] * 4 * 2 * (576 + 144 + 36 + 9) and kept <= slots
    for name in ("mfu_swinmoe.train", "moe_slot_fill.train", "moe_host_ms.train"):
        value = cell.readers[name].read(run)
        assert value is not None and value > 0, name
    assert cell.readers["k4_roofline.train"].read(run) is None
    profiling.clear()


def test_new_readers_read_none_without_spans_or_counters(monkeypatch):
    """A program without K4, the MoE counters or the ``moe.*`` spans (the
    parent of the change that added them) gives every new reader nothing."""
    from iterated_learning_for_vlm_tpu_torch.utils import profiling

    cell = harness.resolve(SWIN)
    trace = {"kernels": [("tiny_attention_fwd_kernel", 0.0, 5.0)], "contexts": [32],
             "busy_s": 1.0, "window_s": 1.0, "steps": 1}
    run = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, trace=trace,
                          counters={"tiny_attention_fwd": 3}, window={})
    monkeypatch.setattr(profiling, "spans", lambda: [
        {"name": "train.step", "id": 1, "parent": None, "start_ns": 0, "end_ns": 10}])
    for name in NEW_READERS:
        assert harness.load_module(BENCH_DIR / "metrics" / f"{name}.py", name).read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert harness.load_module(BENCH_DIR / "metrics" / "moe_host_ms.train.py",
                               "moe_host").read(run) is None


def test_ddp_cell_runs_its_ranks_on_the_cpu(cpu):
    """Two Gloo ranks of the tiny CLIP-FDT: every rank runs the same steps,
    the pairs count both ranks' rows, and the reference over the gathered
    rows (in chunks of one rank's batch) agrees with the program."""
    cell = tiny_ddp_cell()
    outcome = cell.loop.run(cell, seed=SEED, seconds=0.5, trace=False, device=cpu,
                            process_start=time.perf_counter())
    checks = outcome["checks"]
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert checks["loss_gap"]["value"] < 1e-4 and checks["grad_gap"]["value"] < 1e-3
    window = outcome["window"]
    assert outcome["end_to_end"]["train_pairs_per_s"] == pytest.approx(
        window["steps"] * 4 * 2 / window["seconds"])


def test_loops_cut_their_cells_on_the_cpu():
    """The CPU cuts leave the caller's cell as it is."""
    swin, ddp = harness.resolve(SWIN), harness.resolve(DDP)
    cut = swin.loop.cpu_cell(swin)
    img = cut.config["model"]["kwargs"]["image_encode"]
    assert img["input_resolution"] == 96 and img["window_size"] == 6
    assert cut.traffic["batch_size"] == 4
    assert swin.config["model"]["kwargs"]["image_encode"]["input_resolution"] == 192
    assert swin.traffic["batch_size"] == 256
    cut = ddp.loop.cpu_cell(ddp)
    assert cut.entry["chips"] == 2 and cut.traffic["batch_size"] == 4
    assert ddp.entry["chips"] == 4 and ddp.traffic["batch_size"] == 256


def test_ddp_check_fails_the_exchange_faults(cpu):
    """The reference with the ranks' exchange left out (no gather of the
    embeddings; no exchange at all) fails the four-card cell's limits; the
    program passes them."""
    cell = tiny_ddp_cell()
    rows = cell.loop.calibrate(cell, SEED, ["program", "no_gather", "no_exchange"], cpu,
                               time.perf_counter(), 0.0)
    rows = {r["variant"]: r for r in rows}
    assert all(rows["program"][k] <= v for k, v in cell.limits.items()), rows["program"]
    for variant in ("no_gather", "no_exchange"):
        assert any(rows[variant][k] > v for k, v in cell.limits.items()), rows[variant]


def test_counting_k4_reads_the_traced_slice():
    """K4's launches between the slice's first batch and the batch after its
    last: the window closes as the slice's first batch is handed out."""
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    loop = harness.resolve(SWIN).loop
    feed = SimpleNamespace(trace_steps=3, window={})

    def stream():
        for k in range(9):
            if k == 4:
                feed.window["steps"] = 2
            yield k

    fwd = wa.window_attention_fwd.launches
    for k in loop.counting_k4(feed, stream()):
        if k >= 4:  # a step launches K4 once per batch from here on
            wa.window_attention_fwd.launches += 1
    wa.window_attention_fwd.launches = fwd
    assert feed.k4_counted == {"window_attention_fwd": 3, "window_attention_bwd": 0}


def test_k2_text_roofline_by_hand():
    """The text tower's K2 bound over the K2 kernels' time, scaled to the
    launches counted; None without a trace or a K2 launch."""
    cell = harness.resolve(SWIN)
    reader = cell.readers["k2_roofline_text.train"]
    trace = {"kernels": [("tiny_attention_fwd_kernel", 0.0, 300.0),
                         ("tiny_attention_bwd_kernel", 0.0, 700.0),
                         ("window_attention_fwd_kernel", 0.0, 900.0)],
             "contexts": [32, 16], "steps": 2}
    run = SimpleNamespace(config=cell.config, traffic=cell.traffic, trace=trace,
                          counters={"tiny_attention_fwd": 24, "tiny_attention_bwd": 24})
    bound = sum(12 * (flops.k2_fwd_bound_s(256, c, 8, True) + flops.k2_bwd_bound_s(256, c, 8, True))
                for c in (32, 16))
    assert reader.read(run) == pytest.approx(100.0 * bound / 1e-3)
    assert reader.read(SimpleNamespace(**{**vars(run), "counters": {}})) is None
    assert reader.read(SimpleNamespace(**{**vars(run), "trace": None})) is None
