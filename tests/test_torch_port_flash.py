"""PyTorch port vs the JAX package: flash attention (kernels K3-fwd, K3-bwd).

The same numpy inputs (``default_rng`` seeds) go through the JAX
``flash_attention`` (its Pallas kernels in interpret mode, jitted) and the
port's ``flash_attention`` on the CPU, where the wrappers take the plain
versions inside the same ``FlashAttention`` autograd Function the card runs.
The port's ``causal`` flag is held to the JAX call with the causal bias.

Tolerances: fp32 forward atol 1e-5 and gradients atol 1e-4, those of
``tests/test_flash_attention.py`` (fp32 on both sides; only the summation
order differs). The bf16 cases hold the plain versions to the JAX kernel's
own rounding, as stated there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.ops import flash_attention as jfl
from iterated_learning_for_vlm_tpu_torch.ops import flash_attention as tfl
from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as tfa

torch.backends.cuda.matmul.allow_tf32 = False
FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _inputs(seed, b, s, h, d=64, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) * sc
                   for sc in (scale, scale, 1.0, 1.0))
    return q, k, v, do, rng


def _bias(kind, s, rng):
    """None, the causal mask, the causal mask as [1, 1, S, S], or an
    arbitrary fp32 bias with some -inf (key 0 stays finite). "flag" gives the
    JAX side the causal mask and the port the causal flag instead."""
    if kind == "none":
        return None
    if kind == "random":
        bias = rng.standard_normal((s, s)).astype(np.float32)
        bias[rng.random((s, s)) < 0.2] = -np.inf
        bias[:, 0] = 0.0
        return bias
    mask = np.triu(np.full((s, s), -np.inf, np.float32), k=1)
    return mask[None, None] if kind == "causal4d" else mask


def _port_mask(kind, bias, requires_grad=False):
    """The port's (bias, causal) for a case: the flag in place of the mask."""
    if kind == "flag":
        return None, True
    if bias is None:
        return None, False
    return torch.tensor(bias, requires_grad=requires_grad), False


CASES = [(2, 13, 2, "none"), (2, 13, 2, "causal"), (3, 21, 3, "causal4d"),
         (2, 13, 2, "random"), (2, 77, 2, "causal"), (2, 45, 2, "flag")]


@pytest.mark.parametrize("b,s,h,kind", CASES)
def test_flash_forward_matches_jax(b, s, h, kind):
    q, k, v, _, rng = _inputs(1, b, s, h)
    bias = _bias(kind, s, rng)
    jbias = None if bias is None else jnp.asarray(bias)
    want = jax.jit(jfl.flash_attention)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias)
    tbias, causal = _port_mask(kind, bias)
    got = tfl.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), tbias, causal=causal)
    assert got.shape == (b, s, h, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("b,s,h,kind", CASES)
def test_flash_gradients_match_jax(b, s, h, kind):
    """q/k/v gradients of ``sum(out * do)`` through ``FlashAttention`` against
    ``jax.grad``; the bias gets none on either side."""
    q, k, v, do, rng = _inputs(2, b, s, h)
    bias = _bias(kind, s, rng)
    jbias = None if bias is None else jnp.asarray(bias)

    def jf(q_, k_, v_):
        return jnp.sum(jfl.flash_attention(q_, k_, v_, jbias) * jnp.asarray(do))

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tbias, causal = _port_mask(kind, bias, requires_grad=True)
    (tfl.flash_attention(tq, tk, tv, tbias, causal=causal) * torch.from_numpy(do)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL)
    assert tbias is None or tbias.grad is None


def _jax_logits(q, k, bias):
    """The JAX kernel's fp32 logits [B, H, S, S]: q k^T * D^-1/2 + bias."""
    logits = jnp.einsum("bqhc,bkhc->bhqk", jnp.asarray(q, jnp.float32),
                        jnp.asarray(k, jnp.float32)) * q.shape[-1] ** -0.5
    return logits if bias is None else logits + jnp.asarray(bias).reshape(logits.shape[-2:])


@pytest.mark.parametrize("b,s,h,kind", CASES)
def test_flash_lse_reference_matches_jax(b, s, h, kind):
    """The lse-returning plain forward: ``out`` equals the JAX forward, and
    ``lse [B, H, S]`` the log-sum-exp of the JAX kernel's logits."""
    q, k, v, _, rng = _inputs(5, b, s, h)
    bias = _bias(kind, s, rng)
    jbias = None if bias is None else jnp.asarray(bias)
    want = jax.jit(jfl.flash_attention)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias)
    want_lse = jax.nn.logsumexp(_jax_logits(q, k, bias), axis=-1)
    tbias, causal = _port_mask(kind, bias)
    got, lse = tfl.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), tbias,
                                       causal, with_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=FWD_ATOL, rtol=1e-6)


@pytest.mark.parametrize("b,s,h,kind", CASES)
def test_flash_bwd_from_lse_matches_jax_vjp(b, s, h, kind):
    """The plain backward from the forward's ``lse`` (no softmax statistics
    recomputed) against ``jax.vjp`` of the JAX ``flash_attention``."""
    q, k, v, do, rng = _inputs(6, b, s, h)
    bias = _bias(kind, s, rng)
    jbias = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda q_, k_, v_: jfl.flash_attention(q_, k_, v_, jbias),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tbias, causal = _port_mask(kind, bias)
    _, lse = tfl.flash_attention_lse_reference(tq, tk, tv, tbias, causal)
    got = tfl.flash_attention_bwd_reference(tq, tk, tv, tbias, lse, tdo, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL)


def _bf16_spread(got, want):
    """Share of elements that differ from the JAX kernel's at all, and the
    largest difference in bf16 ulps of the tensor's largest value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float((got != want).mean()), float(np.abs(got - want).max() / ulp)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_keeps_p_and_ds_in_fp32(causal):
    """bf16 q, k, v, do: the plain forward and backward against the JAX
    kernel, which computes in fp32 and rounds once. Both round the same fp32
    values, summed in another order, so at most 0.5% of the elements may move
    across a bf16 rounding boundary, by at most one ulp at the tensor's
    scale. The tiny-sequence references (K2), which round p and ds to bf16,
    move over 20% of them: this test fails if those are reused for K3."""
    b, s, h, d = 2, 77, 2, 64
    q, k, v, do, _ = _inputs(0, b, s, h, d)
    mask = np.triu(np.full((s, s), -np.inf, np.float32), k=1) if causal else None
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax.jit(jfl.flash_attention)(*jb[:3], jmask).astype(jnp.float32)

    def jf(q_, k_, v_):
        out = jfl.flash_attention(q_, k_, v_, jmask).astype(jnp.float32)
        return jnp.sum(out * jb[3].astype(jnp.float32))

    want_g = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(*jb[:3])
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got, lse = tfl.flash_attention_fwd(*tb[:3], tmask, with_lse=True)
    got_g = tfl.flash_attention_bwd(*tb[:3], tmask, lse, tb[3])
    assert got.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in got_g)
    for name, g, w in zip(("out", "dq", "dk", "dv"), (got, *got_g), (want, *want_g)):
        share, ulps = _bf16_spread(g.float().numpy(), np.asarray(w, np.float32))
        assert share <= 5e-3 and ulps <= 1.0, (name, share, ulps)
    # the K2 references on the same packed inputs round p (and ds) to bf16
    qkv = torch.cat([t.reshape(b, s, h * d) for t in tb[:3]], dim=-1)
    k2 = tfa.attention_reference(qkv, h, tmask).reshape(b, s, h, d)
    k2_g = tfa.attention_bwd_reference(qkv, h, causal, None, tb[3].reshape(b, s, h * d))
    k2_g = k2_g.reshape(b, s, 3, h, d).unbind(2)
    for name, g, w in zip(("out", "dq", "dk", "dv"), (k2, *k2_g), (want, *want_g)):
        share, _ = _bf16_spread(g.float().numpy(), np.asarray(w, np.float32))
        assert share > 0.2, (name, share)


def test_packed_in_proj_views_take_the_kernel_layout():
    """The towers hand the kernels the q/k/v column blocks of the packed
    [B, S, 3D] in_proj output as [B, S, H, 64] views (token stride 3D, no
    copy); the argument checks accept them, and the plain path gives the
    same result as for contiguous copies."""
    rng = np.random.default_rng(3)
    b, s, h = 2, 9, 3
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * 64)).astype(np.float32))
    q, k, v = (t.reshape(b, s, h, 64) for t in qkv.to(torch.bfloat16).split(h * 64, dim=-1))
    assert q.stride() == (s * 3 * h * 64, 3 * h * 64, 64, 1)
    tfl._check_cuda_args(q, k, v, torch.zeros(s, s))
    got = tfl.flash_attention_fwd(q, k, v)
    want = tfl.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


@pytest.mark.parametrize("kwargs,match", [
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(hd=32), "64"),
    (dict(s=tfl.MAX_SEQ + 1), "S <="),
    (dict(bias_shape=(4, 5)), "bias"),
    (dict(bias_dtype=torch.bfloat16), "bias"),
    (dict(strides="k_copy"), "share"),
])
def test_flash_kernel_argument_checks(kwargs, match):
    """The checks the wrapper runs before a CUDA launch (tensors here stay
    on the CPU; the checks read only shape, dtype, strides and alignment)."""
    s, hd = kwargs.get("s", 4), kwargs.get("hd", 64)
    qkv = torch.zeros(2, s, 3, 2, hd, dtype=kwargs.get("dtype", torch.bfloat16))
    q, k, v = qkv.unbind(2)
    if kwargs.get("strides") == "k_copy":
        k = k.contiguous()
    bias = None
    if "bias_shape" in kwargs or "bias_dtype" in kwargs:
        bias = torch.zeros(kwargs.get("bias_shape", (s, s)),
                           dtype=kwargs.get("bias_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        tfl._check_cuda_args(q, k, v, bias)


def _bf16_case(seed, b, s, h):
    """bf16 inputs; the JAX kernel's output and gradients with the causal
    bias (computed in fp32, rounded once) and the port's through
    ``flash_attention`` with the flag."""
    q, k, v, do, _ = _inputs(seed, b, s, h)
    jmask = jnp.asarray(np.triu(np.full((s, s), -np.inf, np.float32), k=1))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]

    def jf(q_, k_, v_):
        out = jfl.flash_attention(q_, k_, v_, jmask).astype(jnp.float32)
        return jnp.sum(out * jb[3].astype(jnp.float32))

    want = jax.jit(jfl.flash_attention)(*jb[:3], jmask).astype(jnp.float32)
    want_g = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(*jb[:3])
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    got = tfl.flash_attention(tq, tk, tv, causal=True)
    got.backward(torch.from_numpy(do).to(torch.bfloat16))
    return (got, tq.grad, tk.grad, tv.grad), (want, *want_g)


@pytest.mark.parametrize("s", [32, 45, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_causal_flag_forward_matches_jax(s, dtype):
    """``flash_attention(..., causal=True)`` against the JAX
    ``flash_attention`` with the causal bias: fp32 within FWD_ATOL; bf16 as
    the bf16 test below (at most 0.5% of elements across a bf16 rounding
    boundary, by at most one ulp at the tensor's scale)."""
    b, h = 2, 2
    if dtype == "bfloat16":
        (got, *_), (want, *_) = _bf16_case(7, b, s, h)
        share, ulps = _bf16_spread(got.detach().float().numpy(), np.asarray(want, np.float32))
        assert got.dtype == torch.bfloat16 and share <= 5e-3 and ulps <= 1.0, (share, ulps)
        return
    q, k, v, _, rng = _inputs(8, b, s, h)
    mask = _bias("causal", s, rng)
    want = jax.jit(jfl.flash_attention)(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask))
    got = tfl.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("s", [32, 45, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_causal_flag_gradients_match_jax(s, dtype):
    """Gradients through ``flash_attention(..., causal=True)`` against
    ``jax.grad`` of the JAX call with the causal bias (fp32: GRAD_ATOL; bf16:
    as the forward)."""
    b, h = 2, 2
    if dtype == "bfloat16":
        (_, *got), (_, *want) = _bf16_case(9, b, s, h)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            share, ulps = _bf16_spread(g.float().numpy(), np.asarray(w, np.float32))
            assert g.dtype == torch.bfloat16 and share <= 5e-3 and ulps <= 1.0, (name, share, ulps)
        return
    q, k, v, do, rng = _inputs(10, b, s, h)
    jmask = jnp.asarray(_bias("causal", s, rng))

    def jf(q_, k_, v_):
        return jnp.sum(jfl.flash_attention(q_, k_, v_, jmask) * jnp.asarray(do))

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (tfl.flash_attention(tq, tk, tv, causal=True) * torch.from_numpy(do)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL)


def test_serving_call_saves_nothing():
    """Without a gradient to take, ``flash_attention`` calls the forward
    alone (no ``FlashAttention`` node, no ``lse``); with one, the node saves
    the forward's ``lse`` [B, H, S]."""
    q = torch.randn(2, 9, 2, 64, requires_grad=True)
    with torch.no_grad():
        assert tfl.flash_attention(q, q, q, causal=True).grad_fn is None
    out = tfl.flash_attention(q, q, q, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert out.grad_fn.saved_tensors[-1].shape == (2, 2, 9)


def test_cpu_calls_launch_nothing():
    """A CPU tensor takes the plain versions, which are not counted."""
    before = (tfl.flash_attention_fwd.launches, tfl.flash_attention_bwd.launches)
    q = torch.randn(1, 5, 1, 64, requires_grad=True)
    tfl.flash_attention(q, q, q).sum().backward()
    assert (tfl.flash_attention_fwd.launches, tfl.flash_attention_bwd.launches) == before
