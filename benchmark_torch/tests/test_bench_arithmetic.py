"""The yardstick's arithmetic against counts made by hand."""
import pytest

import flops
from conftest import tiny_config


def test_k2_bounds_by_hand():
    # PERF.md's K2-fwd at S=50 H=12, B=256: 78.64 MB over 3.35 TB/s
    b, s, h = 256, 50, 12
    nbytes = 2 * (b * s * 3 * 768 + 3 * 768 + b * s * 768)
    assert flops.k2_fwd_bound_s(b, s, h, False) == pytest.approx(nbytes / 3.35e12)
    assert flops.k2_fwd_bound_s(b, s, h, False) * 1e3 == pytest.approx(0.0235, abs=5e-5)
    # a long sequence is bound by its operations: 2 products, S*S pairs, 64 wide
    ops = 2.0 * 2 * 1 * 1 * 4096 * 4096 * 64
    assert flops.k2_fwd_bound_s(1, 4096, 1, False) == pytest.approx(ops / 989e12)
    assert flops.attention_ops(2, 4, 1, True, 5) == 2.0 * 5 * 2 * 10 * 64  # 10 causal pairs
    bwd = 2 * (2 * 3 * 3 * 64 + 3 * 64 + 2 * 3 * 64 + 2 * 3 * 3 * 64)
    assert flops.k2_bwd_bound_s(2, 3, 1, False) == pytest.approx(bwd / 3.35e12)


def test_k1_bounds_by_hand():
    b, t, n, d = 256, 49, 4096, 512
    fwd_bytes = 2 * (b * t * d + n * d) + 8 * b * n
    fwd_ops = 2.0 * b * t * n * d
    assert flops.k1_fwd_bound_s(b, t, n, d, False) == pytest.approx(
        max(fwd_bytes / 3.35e12, fwd_ops / 989e12))
    masked = flops.k1_fwd_bound_s(b, 32, n, d, True) * 3.35e12
    assert masked == pytest.approx(max(2 * (b * 32 * d + n * d) + 4 * b * 32 + 8 * b * n,
                                       2.0 * b * 32 * n * d / 989e12 * 3.35e12))
    dq = 2 * n * d + 4 * b * t + 8 * b * n + 2 * b * t * d
    assert flops.k1_dq_bound_s(b, t, n, d, True) == pytest.approx(dq / 3.35e12)
    dsd = 2 * b * t * d + 8 * b * n + 2 * n * d
    assert flops.k1_dsd_bound_s(b, t, n, d, False) == pytest.approx(dsd / 3.35e12)


def _tower(b, s, w, layers, pairs):
    return b * layers * (2 * s * w * 3 * w + 4 * pairs * w + 2 * s * w * w + 16 * s * w * w)


def test_train_step_flops_by_hand():
    b, ctx = 8, 16
    cfg = tiny_config("clip_b32")
    # image: 32 px in 16-px patches -> 4 patches + the class token, width 64, 2 layers
    fwd = _tower(b, 5, 64, 2, 25) + _tower(b, ctx, 64, 2, ctx * (ctx + 1) // 2)
    fwd += 2 * b * 64 * 64 * 2 + 2 * 2 * b * 64 * b  # two projections, two logit matrices
    conv = 2 * b * 4 * (3 * 16 * 16) * 64
    assert flops.train_step_flops(cfg, b, ctx) == pytest.approx(conv + 3 * fwd)
    fdt = tiny_config("fdt_b32")
    n = 128
    fwd = _tower(b, 5, 64, 2, 25) + _tower(b, ctx, 64, 2, ctx * (ctx + 1) // 2)
    for tokens in (4, ctx):
        fwd += 2 * b * tokens * (64 * 64 + 64 * 64 + 64 * n) + 2 * b * n * 64
    fwd += 2 * 2 * b * 64 * b
    assert flops.train_step_flops(fdt, b, ctx) == pytest.approx(conv + 3 * fwd)


def test_full_size_step_flops():
    """~35 GFLOP a CLIP-FDT B/32 pair at ctx 32."""
    from harness import BENCH_DIR, load_json

    cfg = load_json(BENCH_DIR / "configs" / "fdt_b32.json")
    per_pair = flops.train_step_flops(cfg, 256, 32) / 256
    assert 33e9 < per_pair < 37e9
