"""The Swin V2 CLIP-FDT cell and the ctx-77 CLIP-FDT cell on the CPU: names, counts,
checks and readers.

On the CPU the Swin V2 loop cuts its cell itself (``cpu_cell``): a 96 px tower
of window 6 with two blocks a stage at the published channels and heads, a
two-layer text tower and a 256 x 64 codebook, run here in float32.
"""
import copy
import time
from types import SimpleNamespace

import pytest
import torch

import flops
import flops_swinv2
import harness
from conftest import BENCH_DIR
from reference import fdt_swinv2 as ref

V2 = "fdt_swinv2_b.train.swinv2.ctx32"
CTX77 = "fdt_b32.train.ctx77"
SEED = 2 ** 31 + 11
NEW_READERS = ["k4cos_roofline.train", "k1_roofline_swinv2.train", "mfu_fdt_swinv2.train"]
# faults the tiny cell's check must catch; ``no_scale_clamp`` reads the
# attention's ln 100 clamp, which no head's logit scale (ln 10 at the draw)
# reaches in three steps, so it changes nothing (asserted below)
CAUGHT = [f for f in ref.FAULTS if f != "no_scale_clamp"]


def tiny_v2_cell():
    cell = harness.resolve(V2)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"]["kwargs"]["dtype"] = "float32"
    return cell


def test_new_cells_resolve():
    v2, ctx77 = harness.resolve(V2), harness.resolve(CTX77)
    assert v2.traffic["loop"] == "train_swinv2" and ctx77.traffic["loop"] == "train"
    assert v2.entry["chips"] == ctx77.entry["chips"] == 1
    assert set(v2.limits) == set(ctx77.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert set(NEW_READERS) <= set(v2.readers) and not set(NEW_READERS) & set(ctx77.readers)
    shared = {"data_wait_ms.train", "launches_per_step.train", "idle_share.train",
              "host_step_ms.train", "step_replay_share.train"}
    assert shared | {"k2_roofline_text.train"} == set(v2.readers) - set(NEW_READERS)
    assert shared | {"mfu.train", "k1_roofline.train", "k2_roofline.train"} == set(ctx77.readers)
    assert {m["name"] for m in v2.end_to_end} == {m["name"] for m in ctx77.end_to_end} == {
        "setup_s", "train_pairs_per_s", "train_step_ms_p95"}
    assert v2.config["model"]["type"] == "clip_fdt_swinB_v2"
    pool = ctx77.traffic["pool"]
    assert pool["context"] == 77 and pool["caption_tokens"] == {"mean": 24, "std": 12, "min": 4,
                                                               "max": 77}


def test_config_keeps_the_published_widths():
    """Swin V2-B at 192 px (window 12, heads of 32) and fdt_b32's recipe, its
    IL reset past every window; 154.3 M parameters."""
    cfg, fdt = harness.resolve(V2).config, harness.resolve(CTX77).config
    sizes = ref.swin_sizes(cfg)
    assert (sizes["resolution"], sizes["patch"], sizes["window"]) == (192, 4, 12)
    assert sizes["depths"] == (2, 2, 18, 2) and sizes["heads"] == (4, 8, 16, 32)
    assert [s["dim"] // s["heads"] for s in ref.stages(cfg)] == [32] * 4
    for block in ("grad_clip", "t_decay", "optimizer", "lr_scheduler", "reset"):
        assert cfg[block] == fdt[block], block
    assert cfg["reset"]["enable"] and cfg["reset"]["reset_steps"] == 6000
    assert cfg["model"]["kwargs"]["fdt"] == dict(fdt["model"]["kwargs"]["fdt"],
                                                 raw_img_ft_dim=1024)
    count = sum(torch.Size(shape).numel() for _, shape, *_ in ref.param_specs(cfg))
    assert round(count / 1e6, 1) == 154.3


def test_swinv2_flops_by_hand():
    """One image through a 2-stage tower at 16 px (patch 4: 4 x 4 tokens,
    window 2, then one 2 x 2 window), one head a stage, a codebook of 8 x 4,
    text of width 8 at context 3; written out product by product."""
    cfg = {"model": {"kwargs": {
        "image_encode": {"input_resolution": 16, "window_size": 2, "depths": [2, 1],
                         "num_heads": [1, 2], "embed_dim": 4},
        "text_encode": {"width": 8, "layers": 1, "embed_dim": 4},
        "fdt": {"sd_num": 8, "sd_dim": 4, "raw_img_ft_dim": 256, "raw_txt_ft_dim": 8}}}}
    d0, d1 = ref.STAGE0_CHANNELS, 2 * ref.STAGE0_CHANNELS
    t0, t1 = 16, 4
    patch = 2 * 16 * 48 * d0
    cpb0 = 2 * 9 * (2 * 512 + 512 * 1)
    cpb1 = 2 * 9 * (2 * 512 + 512 * 2)
    block0 = (2 * t0 * d0 * 3 * d0 + 2 * 2 * t0 * 4 * d0 + 2 * t0 * d0 * d0 + cpb0
              + 2 * 2 * t0 * d0 * 4 * d0)
    merge = 2 * 4 * 4 * d0 * 2 * d0
    block1 = (2 * t1 * d1 * 3 * d1 + 2 * 2 * t1 * 4 * d1 + 2 * t1 * d1 * d1 + cpb1
              + 2 * 2 * t1 * d1 * 4 * d1)
    image, got_patch = flops_swinv2.image_fwd_flops(cfg, 1)
    assert got_patch == patch and image == patch + 2 * block0 + merge + block1
    assert flops_swinv2.image_tokens(cfg) == 4
    text = flops._tower_fwd(1, 3, 8, 1, True)
    heads = (2 * 4 * 256 * 4 + 2 * 4 * 4 * 4 + 2 * 4 * 4 * 8 + 2 * 8 * 4
             + 2 * 3 * 8 * 4 + 2 * 3 * 4 * 4 + 2 * 3 * 4 * 8 + 2 * 8 * 4)
    logits = 2 * 2 * 4 * 1
    assert flops_swinv2.train_step_flops(cfg, 1, 3) == 2 * patch + 3 * (
        image - patch + text + heads + logits)
    assert flops_swinv2.k1_calls(cfg, 3) == [(4, 4, False), (3, 4, True)]


def test_full_size_swinv2_flops():
    """Swin V2-B at 192 px: 23.71 GFLOP an image forward, 20.21 TFLOP a step of
    256 pairs at ctx 32; 24 window-attention calls, N = 144 but 36 at stage 3."""
    cfg = harness.resolve(V2).config
    assert abs(flops_swinv2.image_fwd_flops(cfg, 1)[0] / 1e9 - 23.710) < 0.001
    assert abs(flops_swinv2.train_step_flops(cfg, 256, 32) / 1e12 - 20.209) < 0.001
    calls = flops_swinv2.k4cos_calls(cfg, 256)
    assert len(calls) == 24 and calls[1] == (4096, 144, 4, 16) and calls[-1] == (256, 36, 32, 1)
    assert flops_swinv2.k1_calls(cfg, 32) == [(36, 512, False), (32, 512, True)]


def test_k4cos_bounds_by_hand():
    """Stage 0's shifted call, bound by bytes: K4's bytes and the four head
    scales forward; the backward also writes their gradient."""
    w, n, h, nb = 4096, 144, 4, 16
    fwd_bytes = 2 * (w * n * 384 + w * n * 128) + 4 * (nb * h * n * n + h)
    assert flops_swinv2.k4cos_fwd_bound_s(w, n, h, nb) == fwd_bytes / flops.HBM_BPS
    bwd_bytes = 2 * (2 * w * n * 384 + w * n * 128) + 4 * (nb * h * n * n + h * n * n + 2 * h)
    assert flops_swinv2.k4cos_bwd_bound_s(w, n, h, nb) == bwd_bytes / flops.HBM_BPS


@pytest.fixture(scope="module")
def fault_rows():
    cell = tiny_v2_cell()
    rows = cell.loop.calibrate(cell, 11, ["program", "fp8", *ref.FAULTS], torch.device("cpu"),
                               time.perf_counter(), 0.5)
    return cell.limits, {r["variant"]: r for r in rows}


def test_swinv2_program_is_correct(fault_rows):
    limits, rows = fault_rows
    assert all(rows["program"][k] <= v for k, v in limits.items()), rows["program"]


@pytest.mark.parametrize("variant", ["fp8", *CAUGHT])
def test_swinv2_check_fails_each_planted_fault(fault_rows, variant):
    limits, rows = fault_rows
    assert any(rows[variant][k] > v for k, v in limits.items()), rows[variant]


def test_swinv2_scale_clamp_fault_changes_nothing_at_the_draw(fault_rows):
    _, rows = fault_rows
    assert all(rows["no_scale_clamp"][k] == 0.0 for k in ("loss_gap", "grad_gap", "change_gap"))


def test_swinv2_traced_run_reads_its_metrics(cpu):
    """A traced tiny run: correct, the cosine K4's counts read, the step's FLOP
    reader reads a positive number; the two device-trace readers read None
    (no card, no kernel)."""
    from iterated_learning_for_vlm_tpu_torch.utils import profiling

    cell = tiny_v2_cell()
    profiling.clear()
    outcome = cell.loop.run(cell, seed=SEED, seconds=0.3, trace=True, device=cpu,
                            process_start=time.perf_counter())
    assert all(c["value"] <= c["limit"] for c in outcome["checks"].values()), outcome["checks"]
    # counted over the traced slice; the CPU's plain route launches nothing
    assert outcome["counters"]["window_attention_cos_fwd"] == 0
    run = SimpleNamespace(cell=cell, **outcome)
    assert cell.readers["mfu_fdt_swinv2.train"].read(run) > 0
    assert cell.readers["k4cos_roofline.train"].read(run) is None
    assert cell.readers["k1_roofline_swinv2.train"].read(run) is None
    profiling.clear()


def test_device_readers_by_hand():
    """The cosine K4's and K1's bounds over their kernels' time, scaled to the
    launches counted; None without a trace or a launch. The dot-product K4's
    kernels are not the cosine reader's."""
    cell = harness.resolve(V2)
    trace = {"kernels": [("window_attention_cos_fwd_kernel<9>", 0.0, 300.0),
                         ("window_attention_cos_bwd_kernel<9>", 0.0, 700.0),
                         ("window_attention_fwd_kernel<9>", 0.0, 900.0),
                         ("codebook_pool_fwd_kernel", 0.0, 400.0),
                         ("codebook_pool_route_kernel", 0.0, 100.0)],
             "contexts": [32, 16], "steps": 2}
    counters = {"window_attention_cos_fwd": 48, "window_attention_cos_bwd": 48,
                "codebook_pool_fwd": 4, "codebook_pool_bwd_dq": 4, "codebook_pool_bwd_dsd": 4}
    run = SimpleNamespace(config=cell.config, traffic=cell.traffic, trace=trace,
                          counters=counters)
    calls = flops_swinv2.k4cos_calls(cell.config, 256)
    k4 = sum(flops_swinv2.k4cos_fwd_bound_s(*c) + flops_swinv2.k4cos_bwd_bound_s(*c)
             for c in calls)
    assert cell.readers["k4cos_roofline.train"].read(run) == pytest.approx(
        100.0 * 2 * k4 / 1e-3)
    k1 = sum(fn(256, t, 4096, 512, masked) for ctx in (32, 16)
             for t, _, masked in ((36, 512, False), (ctx, 512, True))
             for fn in (flops.k1_fwd_bound_s, flops.k1_dq_bound_s, flops.k1_dsd_bound_s))
    assert cell.readers["k1_roofline_swinv2.train"].read(run) == pytest.approx(
        100.0 * k1 / 5e-4)
    for name in ("k4cos_roofline.train", "k1_roofline_swinv2.train"):
        assert cell.readers[name].read(SimpleNamespace(**{**vars(run), "counters": {}})) is None
        assert cell.readers[name].read(SimpleNamespace(**{**vars(run), "trace": None})) is None


def test_new_readers_read_none_without_what_they_read():
    """A program whose run gives no window step, no trace and no counter (the
    parent, which cannot build the model) gives every new reader nothing."""
    cell = harness.resolve(V2)
    run = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, trace=None,
                          counters={}, window={})
    for name in NEW_READERS:
        assert harness.load_module(BENCH_DIR / "metrics" / f"{name}.py", name).read(run) is None


def test_loop_cuts_its_cell_on_the_cpu():
    """The CPU cut leaves the caller's cell as it is."""
    cell = harness.resolve(V2)
    cut = cell.loop.cpu_cell(cell)
    img = cut.config["model"]["kwargs"]["image_encode"]
    assert img["input_resolution"] == 96 and img["window_size"] == 6
    assert ref.stages(cut.config)[-1]["dim"] == cut.config["model"]["kwargs"]["fdt"][
        "raw_img_ft_dim"]
    assert cut.traffic["batch_size"] == 4
    assert cell.config["model"]["kwargs"]["image_encode"]["input_resolution"] == 192
    assert cell.traffic["batch_size"] == 256
