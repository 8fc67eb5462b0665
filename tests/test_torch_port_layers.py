"""PyTorch port vs the JAX package: layers, sparsemax and kernel functions.

Each test feeds the same numpy inputs (``default_rng`` seeds) and the same
weights to a flax module or JAX function and to its counterpart in
``iterated_learning_for_vlm_tpu_torch``, both in fp32 on the CPU, where the
JAX Pallas kernels run in interpret mode (``ops/_common.py``) and the port's
kernel wrappers take their plain PyTorch versions.

Tolerance: atol 1e-5 unless stated. Both sides compute in fp32; they differ
only in summation order (XLA:CPU vs ATen), worth a few fp32 ulps on the O(1)
values compared here.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.models import layers as jl
from iterated_learning_for_vlm_tpu.models.sparsemax import sparsemax as j_sparsemax
from iterated_learning_for_vlm_tpu.models.sparsemax import sparsemax_bisect as j_bisect
from iterated_learning_for_vlm_tpu.ops import codebook_attention as jcb
from iterated_learning_for_vlm_tpu.ops import fused_attention as jfa
from iterated_learning_for_vlm_tpu_torch.models import fdt as tfdt
from iterated_learning_for_vlm_tpu_torch.models import layers as tl
from iterated_learning_for_vlm_tpu_torch.models.sparsemax import sparsemax, sparsemax_bisect
from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as tcb
from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as tfa
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import (
    _BLOCK_MAP, _flatten, _to_torch_layout,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _noisy_params(module, rng, *args, **kw):
    """flax init, then noise on every leaf so zero-initialised biases and
    unit LayerNorm scales are exercised too."""
    params = module.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)


def _block_state(params, prefix=()):
    """One flax residual block's params (or a sub-tree of one, under
    ``prefix``) -> port state_dict names, via the weight bridge's table."""
    out = {}
    for path, value in _flatten(params).items():
        name = _BLOCK_MAP[prefix + path]
        if prefix:
            name = name[len(".".join(prefix)) + 1:]
        out[name] = _t(_to_torch_layout(path, value))
    return out


def test_quick_gelu():
    x = np.random.default_rng(0).standard_normal((4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(tl.quick_gelu(_t(x)).numpy(),
                               np.asarray(jl.quick_gelu(jnp.asarray(x))), atol=ATOL)


def test_layernorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32) * 2 + 0.5
    mod = jl.LayerNorm()
    p = _noisy_params(mod, rng, jnp.asarray(x))
    port = tl.LayerNorm(48)
    port.load_state_dict({"weight": _t(p["norm"]["scale"]), "bias": _t(p["norm"]["bias"])})
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               np.asarray(mod.apply({"params": p}, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("add_bias", [True, False])
def test_packed_in_proj(add_bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mod = jl.PackedInProj(96)
    p = _noisy_params(mod, rng, jnp.asarray(x))
    want, want_bias = mod.apply({"params": p}, jnp.asarray(x), add_bias=add_bias)
    got, got_bias = tl.packed_in_proj(_t(x), _t(p["kernel"]).T, _t(p["bias"]),
                                      torch.float32, add_bias=add_bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got_bias.numpy(), np.asarray(want_bias))


@pytest.mark.parametrize("seq,causal,fused", [
    (17, False, False), (17, False, True), (12, True, False), (12, True, True),
])
def test_multihead_attention(seq, causal, fused):
    """Plain and fused paths against the flax module (the fused flax path
    runs the Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, seq, 64)).astype(np.float32)
    bias = jnp.triu(jnp.full((seq, seq), -jnp.inf), k=1) if causal else None
    mod = jl.MultiheadAttention(num_heads=2, fused_attn=fused)
    p = _noisy_params(mod, rng, jnp.asarray(x), bias=bias)
    want, _ = mod.apply({"params": p}, jnp.asarray(x), bias=bias)
    port = tl.MultiheadAttention(64, 2, fused_attn=fused)
    port.load_state_dict(_block_state(p, prefix=("attn",)))
    np.testing.assert_allclose(port(_t(x), causal=causal).detach().numpy(),
                               np.asarray(want), atol=ATOL)


def test_mlp():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mod = jl.MLP(width=32, fc_std=0.1, proj_std=0.1)
    p = _noisy_params(mod, rng, jnp.asarray(x))
    port = tl.MLP(32, 0.1, 0.1)
    port.load_state_dict(_block_state(p, prefix=("mlp",)))
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               np.asarray(mod.apply({"params": p}, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_residual_block(causal):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    mod = jl.ResidualAttentionBlock(width=64, heads=2, attn_std=0.1, proj_std=0.1,
                                    fc_std=0.1, causal=causal, fused_attn=True)
    p = _noisy_params(mod, rng, jnp.asarray(x))
    want, _ = mod.apply({"params": p}, jnp.asarray(x))
    port = tl.ResidualAttentionBlock(64, 2, 0.1, 0.1, 0.1, causal=causal, fused_attn=True)
    port.load_state_dict(_block_state(p))
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), np.asarray(want), atol=ATOL)


def test_transformer_stack():
    """The scanned flax stack (params [L, ...]) against the ModuleList."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    mod = jl.Transformer(width=64, layers=2, heads=2, fused_attn=True)
    p = _noisy_params(mod, rng, jnp.asarray(x))
    port = tl.Transformer(64, 2, 2, fused_attn=True, fused_attn_group=4, unroll=True)
    state = {}
    for i in range(2):
        layer = jax.tree.map(lambda a, i=i: a[i], p["resblocks"])
        state.update({f"resblocks.{i}.{k}": v for k, v in _block_state(layer).items()})
    port.load_state_dict(state)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               np.asarray(mod.apply({"params": p}, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("seq,causal,fused", [(13, False, False), (12, True, True)])
def test_multihead_attention_flash_route(seq, causal, fused):
    """``use_flash`` against the flax module's flash route (the JAX K3 kernel
    in interpret mode, jitted), with the causal mask as its bias; with
    ``fused_attn`` also set, flash still wins on both sides, as in JAX."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, seq, 128)).astype(np.float32)
    bias = jnp.triu(jnp.full((seq, seq), -jnp.inf), k=1) if causal else None
    mod = jl.MultiheadAttention(num_heads=2, use_flash=True, fused_attn=fused)
    p = _noisy_params(mod, rng, jnp.asarray(x), bias=bias)
    want, _ = jax.jit(mod.apply)({"params": p}, jnp.asarray(x), bias=bias)
    port = tl.MultiheadAttention(128, 2, use_flash=True, fused_attn=fused)
    port.load_state_dict(_block_state(p, prefix=("attn",)))
    np.testing.assert_allclose(port(_t(x), causal=causal).detach().numpy(),
                               np.asarray(want), atol=ATOL)


# flash, fused, s, head width, dtype, device -> route; every case on a CUDA
# device unless it says "cpu", where the kernels' plain versions take anything
ROUTE_CASES = [
    (False, True, 50, 64, torch.bfloat16, "cuda", "fused"),
    (True, False, 197, 64, torch.bfloat16, "cuda", "flash"),
    (True, True, 1024, 64, torch.bfloat16, "cuda", "flash"),
    (False, True, 50, 64, torch.float32, "cuda", "plain"),
    (False, True, 50, 32, torch.bfloat16, "cuda", "plain"),
    (False, True, 50, 48, torch.bfloat16, "cuda", "plain"),
    (False, True, 129, 64, torch.bfloat16, "cuda", "plain"),
    (True, False, 50, 64, torch.float32, "cuda", "plain"),
    (True, False, 50, 32, torch.bfloat16, "cuda", "plain"),
    (True, False, 1025, 64, torch.bfloat16, "cuda", "plain"),
    (False, True, 50, 32, torch.float32, "cpu", "fused"),
    (True, False, 1025, 48, torch.float32, "cpu", "flash"),
    (False, True, 129, 64, torch.float32, "cpu", "plain"),
    (False, False, 50, 64, torch.bfloat16, "cuda", "plain"),
]


@pytest.mark.parametrize("flash,fused,s,hd,dtype,device,route", ROUTE_CASES)
def test_attention_route(flash, fused, s, hd, dtype, device, route):
    """The route is decided from the input, before any launch: a kernel only
    where it can take the input (the JAX S <= 128 rule for K2 everywhere);
    every knob that asked for a kernel and got the plain path is counted."""
    before = tl.attention_route.plain_routes
    assert tl.attention_route(flash, fused, s, hd, dtype, torch.device(device)) == route
    asked = flash or fused
    assert tl.attention_route.plain_routes - before == int(asked and route == "plain")


@pytest.mark.parametrize("dtype,sd_dim,device,takes", [
    (torch.bfloat16, 512, "meta", True), (torch.bfloat16, 1024, "meta", True),
    (torch.bfloat16, 64, "meta", True), (torch.float32, 512, "meta", False),
    (torch.bfloat16, 96, "meta", False), (torch.bfloat16, 1088, "meta", False),
    (torch.float32, 96, "cpu", True),
])
def test_codebook_route(dtype, sd_dim, device, takes):
    """K1 takes bf16 q with ``sd_dim`` a multiple of 64 and at most 1024, at
    any T (here 196, the ViT-B/16 patch count); a device tensor (``meta``
    stands in for CUDA here) it cannot take routes to the plain branch and is
    counted; a CPU tensor takes the plain versions."""
    q = torch.empty(2, 196, sd_dim, dtype=dtype, device=device)
    before = tfdt.codebook_route.plain_routes
    assert tfdt.codebook_route(q, sd_dim) is takes
    assert tfdt.codebook_route.plain_routes - before == int(not takes)


# -- sparsemax -------------------------------------------------------------
@pytest.mark.parametrize("scale", [0.3, 3.0])
def test_sparsemax_sort_and_bisect(scale):
    """atol 1e-6: the outputs are probabilities <= 1, and the 40-step
    bisection pins tau to ~1e-12 before the exact renormalisation."""
    z = np.random.default_rng(7).standard_normal((5, 96)).astype(np.float32) * scale
    np.testing.assert_allclose(sparsemax(_t(z)).numpy(),
                               np.asarray(j_sparsemax(jnp.asarray(z))), atol=1e-6)
    np.testing.assert_allclose(sparsemax_bisect(_t(z)).numpy(),
                               np.asarray(j_bisect(jnp.asarray(z))), atol=1e-6)


# -- K2: fused tiny attention ---------------------------------------------
@pytest.mark.parametrize("b,s,h,hd,causal,with_bias", [
    (3, 17, 2, 32, False, False),
    (3, 17, 2, 32, False, True),
    (4, 12, 2, 32, True, False),
    (4, 12, 2, 32, True, True),
    (2, 50, 12, 64, False, True),   # vision tower shape
    (2, 77, 8, 64, True, True),     # text tower, full context
    (2, 32, 8, 64, True, True),     # text tower, ctx-32 bucket
])
def test_fused_tiny_attention_matches_jax(b, s, h, hd, causal, with_bias):
    rng = np.random.default_rng(8)
    d = h * hd
    qkv = rng.standard_normal((b, s, 3 * d)).astype(np.float32)
    bias3 = rng.standard_normal(3 * d).astype(np.float32) if with_bias else None
    mask = np.triu(np.full((s, s), -np.inf, np.float32), k=1) if causal else None
    want = jfa.fused_tiny_attention(
        jnp.asarray(qkv), h, bias=None if mask is None else jnp.asarray(mask),
        head_group=2, batch_block=2, sample_group=2,
        qkv_bias=None if bias3 is None else jnp.asarray(bias3))
    tb3 = None if bias3 is None else _t(bias3)
    got = tfa.fused_tiny_attention(_t(qkv), h, causal=causal, head_group=2, qkv_bias=tb3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if causal:  # the JAX form: the causal mask as a bias tensor (plain version)
        got = tfa.fused_tiny_attention(_t(qkv), h, torch.from_numpy(mask), qkv_bias=tb3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _bf16_spread(got, want):
    """Share of elements that differ from the JAX kernel's at all, and the
    largest difference in bf16 ulps of the tensor's largest value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float((got != want).mean()), float(np.abs(got - want).max() / ulp)


# the constant [S, S] logits bias of the JAX entry point: S = 13 (JAX pads
# to 16), 50 (vision), 77 (text); with and without the absorbed in_proj
# bias; fp32 and bf16; and the causal flag composed with a bias, held to the
# JAX call with the causal mask folded into the bias
K2_BIAS_CASES = [(s, with_b3, dt, False) for s in (13, 50, 77) for with_b3 in (False, True)
                 for dt in ("float32", "bfloat16")] + [(13, True, "float32", True),
                                                       (77, False, "bfloat16", True)]


def k2_bias_inputs(s, causal, seed, b=2, h=2, hd=64):
    """qkv, the in_proj bias, a random finite [S, S] bias (every row keeps
    finite keys) and an output gradient; the bias JAX gets (with the causal
    mask folded in when ``causal``)."""
    rng = np.random.default_rng(seed)
    d = h * hd
    qkv = rng.standard_normal((b, s, 3 * d)).astype(np.float32)
    bias3 = (0.5 * rng.standard_normal(3 * d)).astype(np.float32)
    bias = (1.5 * rng.standard_normal((s, s))).astype(np.float32)
    dout = rng.standard_normal((b, s, d)).astype(np.float32)
    jbias = bias + np.triu(np.full((s, s), -np.inf, np.float32), k=1) if causal else bias
    return qkv, bias3, bias, dout, jbias


@pytest.mark.parametrize("s,with_b3,dtype,causal", K2_BIAS_CASES)
def test_fused_tiny_attention_bias_matches_jax(s, with_b3, dtype, causal):
    """``fused_tiny_attention(qkv, h, bias)`` through ``TinyAttention`` (the
    plain versions on the CPU) against the JAX kernel in interpret mode. fp32
    within ATOL; bf16: both round p to bf16 at the same place from fp32
    logits summed in another order, so at most 0.1% of the outputs may cross
    a bf16 rounding boundary, by at most one ulp at the tensor's scale."""
    h = 2
    qkv, bias3, bias, _, jbias = k2_bias_inputs(s, causal, seed=60 + s)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.fused_tiny_attention(
        jnp.asarray(qkv, jdt), h, bias=jnp.asarray(jbias), head_group=2, batch_block=2,
        qkv_bias=jnp.asarray(bias3, jdt) if with_b3 else None)
    tb3 = torch.from_numpy(bias3).to(tdt) if with_b3 else None
    got = tfa.fused_tiny_attention(torch.from_numpy(qkv).to(tdt), h, torch.from_numpy(bias),
                                   head_group=2, qkv_bias=tb3, causal=causal)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    else:
        share, ulps = _bf16_spread(got.float().numpy(), np.asarray(want, np.float32))
        assert share <= 1e-3 and ulps <= 1.0, (share, ulps)


def test_fused_tiny_attention_all_masked_row():
    """A bias that masks every key of a row: the plain version gives that
    row zeros (the kernels' answer; JAX's clamped mask gives a mean over its
    padded key slots instead, ROADMAP Queue 3), and the other rows keep the
    JAX values."""
    s, h = 13, 2
    qkv, bias3, bias, _, _ = k2_bias_inputs(s, False, seed=5)
    bias[4] = -np.inf
    tbias = torch.from_numpy(bias)
    got = tfa.fused_tiny_attention(_t(qkv), h, tbias, qkv_bias=_t(bias3)).numpy()
    assert np.all(got[:, 4] == 0)
    want = np.asarray(jfa.fused_tiny_attention(jnp.asarray(qkv), h, bias=jnp.asarray(bias),
                                               head_group=2, qkv_bias=jnp.asarray(bias3)))
    keep = np.arange(s) != 4
    np.testing.assert_allclose(got[:, keep], want[:, keep], atol=ATOL)
    dout = torch.ones(2, s, h * 64)
    dqkv = tfa.tiny_attention_bwd(_t(qkv), h, False, _t(bias3), dout, tbias)
    assert torch.isfinite(dqkv).all() and torch.all(dqkv[:, 4, :h * 64] == 0)


def test_attention_reference_matches_xla_reference():
    rng = np.random.default_rng(9)
    qkv = rng.standard_normal((2, 13, 3 * 64)).astype(np.float32)
    bias = np.triu(np.full((13, 13), -np.inf, np.float32), k=1)
    want = jfa.xla_attention_reference(jnp.asarray(qkv), 4, jnp.asarray(bias))
    got = tfa.attention_reference(_t(qkv), 4, torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(hd=32), "head_dim"),
    (dict(s=129), "S <="),
    (dict(bias_len=10), "qkv_bias"),
    (dict(offset=1), "16-byte aligned"),
    (dict(bias_shape=(16, 15)), "bias must"),
    (dict(bias_shape=(16, 16), bias_dtype=torch.bfloat16), "bias must"),
])
def test_attention_kernel_argument_checks(kwargs, match):
    """The checks the wrapper runs before a CUDA launch (tensors here stay
    on the CPU; the checks read only shape, dtype and layout)."""
    h, hd, s = 2, kwargs.get("hd", 64), kwargs.get("s", 16)
    qkv = torch.zeros(2, s, 3 * h * hd, dtype=kwargs.get("dtype", torch.bfloat16))
    if "offset" in kwargs:  # a contiguous view that starts 2 bytes past an aligned address
        qkv = torch.zeros(qkv.numel() + 1, dtype=qkv.dtype)[1:].view(qkv.shape)
    bias = torch.zeros(kwargs["bias_len"], dtype=torch.bfloat16) if "bias_len" in kwargs else None
    logits_bias = None
    if "bias_shape" in kwargs:
        logits_bias = torch.zeros(kwargs["bias_shape"], dtype=kwargs.get("bias_dtype",
                                                                         torch.float32))
    with pytest.raises(ValueError, match=match):
        tfa._check_cuda_args(qkv, h, bias, bias=logits_bias)


# -- K1: codebook pooling -------------------------------------------------
def _pool_inputs(seed, b=4, t=9, d=32, n=96, with_keep=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, d)).astype(np.float32)
    sd = rng.standard_normal((n, d)).astype(np.float32)
    keep = (rng.random((b, t)) > 0.3).astype(np.float32) if with_keep else None
    if with_keep:
        keep[:, 0] = 1.0
    return q, sd, keep


def _jax_pool(q, sd, keep, temp, nn=512):
    pooled, amax = jcb._pooled_fwd(jnp.asarray(q), jnp.asarray(sd),
                                   None if keep is None else jnp.asarray(keep), temp,
                                   bb=2, nn=nn)
    return np.asarray(pooled), np.asarray(amax)


def _assert_amax(got, want, q, sd, keep, temp, min_share=0.95):
    """amax must agree wherever the top-2 gap over t is wider than 1e-5 (a
    closer pair may resolve either way under another summation order); at
    least ``min_share`` of the entries must be compared."""
    inner = np.einsum("btd,nd->btn", q.astype(np.float64), sd.astype(np.float64))
    inner = inner * q.shape[-1] ** -0.5
    if keep is not None:
        inner = inner * keep[..., None]
    inner = np.sort(inner / temp, axis=1)
    gap = inner[:, -1] - inner[:, -2]
    exact_tie = gap == 0  # pads tie at exactly 0: the smallest t must win
    decided = (gap > 1e-5) | exact_tie
    assert decided.mean() >= min_share
    np.testing.assert_array_equal(got[decided], want[decided])


@pytest.mark.parametrize("with_keep,temp,n,nn", [
    (True, 7.0, 96, 512),
    (False, 3.0, 96, 512),
    (True, 0.25, 100, 64),   # ragged last codebook tile on the JAX side
])
def test_pooled_codebook_logits_matches_jax(with_keep, temp, n, nn):
    q, sd, keep = _pool_inputs(10, n=n, with_keep=with_keep)
    want_p, want_a = _jax_pool(q, sd, keep, temp, nn=nn)
    got_p, got_a = tcb.codebook_pool_fwd(_t(q), _t(sd), None if keep is None else _t(keep), temp)
    assert got_a.dtype == torch.int32
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=ATOL)
    _assert_amax(got_a.numpy(), want_a, q, sd, keep, temp)
    np.testing.assert_allclose(
        tcb.pooled_codebook_logits(_t(q), _t(sd), None if keep is None else _t(keep),
                                   temp).numpy(), want_p, atol=ATOL)


def test_pooled_all_negative_row_pads_decide_amax():
    """Every real score of row 0 is negative, so its max is a pad's 0 and
    the first pad position must be the argmax (0-valued pads, not -inf)."""
    rng = np.random.default_rng(11)
    b, t, d, n = 3, 8, 32, 64
    sd = np.abs(rng.standard_normal((n, d))).astype(np.float32) + 0.1
    q = rng.standard_normal((b, t, d)).astype(np.float32)
    q[0] = -np.abs(q[0]) - 0.1
    keep = np.ones((b, t), np.float32)
    keep[0, [3, 5, 6]] = 0.0
    keep[1, 7] = 0.0
    want_p, want_a = _jax_pool(q, sd, keep, 2.0)
    got_p, got_a = tcb.codebook_pool_fwd(_t(q), _t(sd), _t(keep), 2.0)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=ATOL)
    np.testing.assert_array_equal(got_p.numpy()[0], 0.0)
    np.testing.assert_array_equal(got_a.numpy()[0], 3)
    np.testing.assert_array_equal(got_a.numpy()[0], want_a[0])
    _assert_amax(got_a.numpy(), want_a, q, sd, keep, 2.0)


@pytest.mark.parametrize("t,with_keep,temp", [(144, True, 0.5), (196, False, 2.0)])
def test_pooled_codebook_logits_matches_jax_long_t(t, with_keep, temp):
    """T past 128: a 384-px ViT-B/32 (144 patches) and the B/16 tower (196);
    the JAX kernel's block holds the whole T, the port's plain version too."""
    q, sd, keep = _pool_inputs(40 + t, t=t, with_keep=with_keep)
    want_p, want_a = _jax_pool(q, sd, keep, temp, nn=64)
    got_p, got_a = tcb.codebook_pool_fwd(_t(q), _t(sd), None if keep is None else _t(keep), temp)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=ATOL)
    _assert_amax(got_a.numpy(), want_a, q, sd, keep, temp)


@pytest.mark.parametrize("with_keep", [True, False])
def test_fused_codebook_attention_matches_jax(with_keep):
    q, sd, keep = _pool_inputs(12, with_keep=with_keep)
    want_att, want_ft = jcb.fused_codebook_attention(
        jnp.asarray(q), jnp.asarray(sd),
        keep_mask=None if keep is None else jnp.asarray(keep > 0), temperature=0.5)
    got_att, got_ft = tcb.fused_codebook_attention(
        _t(q), _t(sd), keep_mask=None if keep is None else torch.from_numpy(keep > 0),
        temperature=0.5)
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), atol=ATOL)
    np.testing.assert_allclose(got_ft.numpy(), np.asarray(want_ft), atol=ATOL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(d=1088), "D <= 1024"),
    (dict(d=48), "multiple of 64"),
    (dict(keep_dtype=torch.bool), "keep"),
])
def test_codebook_kernel_argument_checks(kwargs, match):
    b, t, d = 2, kwargs.get("t", 9), kwargs.get("d", 64)
    dt = kwargs.get("dtype", torch.bfloat16)
    q, sd = torch.zeros(b, t, d, dtype=dt), torch.zeros(32, d, dtype=dt)
    keep = torch.ones(b, t, dtype=kwargs["keep_dtype"]) if "keep_dtype" in kwargs else None
    with pytest.raises(ValueError, match=match):
        tcb._check_cuda_args(q, sd, keep)


@pytest.mark.parametrize("t", [1, 129, 196, 1024, 4096])
def test_codebook_kernel_accepts_any_t(t):
    """The K1 kernels take any T (the forward walks T in 64-row steps with a
    running max; dq's route and gather kernels keep no T-sized state on chip)."""
    q, sd = torch.zeros(2, t, 64, dtype=torch.bfloat16), torch.zeros(32, 64, dtype=torch.bfloat16)
    tcb._check_cuda_args(q, sd, torch.ones(2, t))
    tcb._check_bwd_args(q, sd, None, torch.zeros(2, 32, dtype=torch.int32), torch.zeros(2, 32),
                        "codebook_pool_bwd_dq")


_JAX_ROOTS = ("jax", "flax", "iterated_learning_for_vlm_tpu")


def _imported_roots(path: Path) -> set:
    """Top-level names of every module a source imports, at module level or
    inside a function, by ``import``, ``from ... import`` (absolute), or
    ``importlib.import_module`` / ``__import__`` with a literal name."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_port_imports_no_jax():
    """The port runs where jax is not installed. No source of the port or
    ``chip_smoke.py`` imports jax, flax or the JAX package anywhere; and a
    fresh interpreter that imports its models, ops, encoder and training
    modules, the Solver and its launcher, the data pipeline and the host
    utilities, the caption tasks, the HF adapter and the visualizer and
    feature-dump tools, runs the native augment, and encodes captions through
    ``TorchEncoder.encode_texts`` with no tokenizer given (the port's own,
    found on first use), has loaded none of them, nor ``regex``, nor ``yaml``
    (only ``load_config`` reads YAML)."""
    sources = sorted((REPO / "iterated_learning_for_vlm_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 20
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p) & set(_JAX_ROOTS))
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}, bad
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import iterated_learning_for_vlm_tpu_torch.ops.codebook_attention\n"
        "import iterated_learning_for_vlm_tpu_torch.ops.flash_attention\n"
        "import iterated_learning_for_vlm_tpu_torch.ops.fused_attention\n"
        "import iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint\n"
        "import iterated_learning_for_vlm_tpu_torch.train.il\n"
        "import iterated_learning_for_vlm_tpu_torch.train.schedule\n"
        "import iterated_learning_for_vlm_tpu_torch.train.step\n"
        "import iterated_learning_for_vlm_tpu_torch.train.solver\n"
        "import iterated_learning_for_vlm_tpu_torch.cli_entry\n"
        "import iterated_learning_for_vlm_tpu_torch.utils\n"
        "import iterated_learning_for_vlm_tpu_torch.utils.debug\n"
        "import iterated_learning_for_vlm_tpu_torch.utils.misc\n"
        "import iterated_learning_for_vlm_tpu_torch.utils.profiling\n"
        "import iterated_learning_for_vlm_tpu_torch.data.auto_augment\n"
        "import iterated_learning_for_vlm_tpu_torch.data.pipeline\n"
        "import iterated_learning_for_vlm_tpu_torch.data.samplers\n"
        "import iterated_learning_for_vlm_tpu_torch.tools.make_train_shards\n"
        "import iterated_learning_for_vlm_tpu_torch.data.coco\n"
        "import iterated_learning_for_vlm_tpu_torch.eval.caption_selection\n"
        "import iterated_learning_for_vlm_tpu_torch.eval.captioning\n"
        "import iterated_learning_for_vlm_tpu_torch.eval.hf_adapter\n"
        "import iterated_learning_for_vlm_tpu_torch.tools.inference\n"
        "import iterated_learning_for_vlm_tpu_torch.tools.run_codebook_viz\n"
        "import iterated_learning_for_vlm_tpu_torch.tools.visualization\n"
        "from iterated_learning_for_vlm_tpu_torch.data import augment, native\n"
        "assert native.available()\n"
        "x = np.zeros((40, 50, 3), np.uint8)\n"
        "assert augment.mocov2_single(x, np.random.default_rng(0), size=32).shape == (32, 32, 3)\n"
        "from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder\n"
        "from iterated_learning_for_vlm_tpu_torch.models import model_entry\n"
        "cfg = {'type': 'clip_fdt_vitb32', 'kwargs': {\n"
        "    'image_encode': {'input_resolution': 32, 'patch_size': 16, 'width': 64,\n"
        "                     'layers': 1, 'heads': 1, 'embed_dim': 32},\n"
        "    'text_encode': {'context_length': 16, 'width': 64, 'heads': 1, 'layers': 1,\n"
        "                    'embed_dim': 32},\n"
        "    'fdt': {'sd_num': 32, 'sd_dim': 32, 'raw_img_ft_dim': 64, 'raw_txt_ft_dim': 64,\n"
        "            'sparsemax_method': 'bisect'}}}\n"
        "enc = TorchEncoder(model_entry(cfg, device='cpu'), batch_size=2)\n"
        "emb = enc.encode_texts(['a photo of a cat', 'x\\u00b2 + \\u00bd, caf\\u00e9'])\n"
        "assert emb.shape == (2, 32) and np.isfinite(emb).all(), emb.shape\n"
        "assert enc.tokenizer.vocab_size == 49409\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_JAX_ROOTS + ('regex', 'yaml')!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=False)
    assert res.returncode == 0, res.stderr
