"""PyTorch port vs the JAX package: gradients.

The same numpy inputs (``default_rng`` seeds) go through ``jax.grad`` of a
JAX function and torch autograd of its counterpart in the port, both fp32 on
the CPU: the JAX Pallas kernels run in interpret mode, the port's kernel
wrappers take their plain versions (inside the same ``autograd.Function``s
the card runs). Covered: the sparsemax VJP (sort and bisection), the
codebook pooling backward (K1-bwd dq and dsd), the tiny-attention backward
(K2-bwd, with ``dbias3``, and with the JAX entry point's ``[S, S]`` logits
bias, which gets no gradient) and the gradients of the whole small CLIP-FDT
loss.

Tolerances: atol 1e-5 on O(1) gradients of single functions (fp32 on both
sides, summation order only); the whole-model gradients as stated there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu.models.sparsemax import sparsemax as j_sparsemax
from iterated_learning_for_vlm_tpu.models.sparsemax import sparsemax_bisect as j_bisect
from iterated_learning_for_vlm_tpu.ops import codebook_attention as jcb
from iterated_learning_for_vlm_tpu.ops import fused_attention as jfa
from iterated_learning_for_vlm_tpu.train.loss import clip_info_nce as j_info_nce
from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.models.sparsemax import sparsemax, sparsemax_bisect
from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as tcb
from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as tfa
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import (
    load_jax_params, state_dict_from_jax_params,
)
from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce
from test_torch_port_layers import K2_BIAS_CASES, _bf16_spread, k2_bias_inputs
from test_torch_port_slice import make_batch, small_cfg

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-5
# leaves the FDT forward never reads: JAX gives them exact zero gradients
UNREAD = ("visual.ln_post.", "visual.proj", "encode_text.text_projection.", "logit_scale_sd")


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=grad)


# -- the repair: the sparsemax VJP ------------------------------------------
@pytest.mark.parametrize("scale", [0.05, 0.5, 3.0, 30.0])
@pytest.mark.parametrize("method", ["sort", "bisect"])
def test_sparsemax_gradient_matches_jax(method, scale):
    """The exact sparsemax gradient, from a support of many entries (scale
    0.05) down to one (scale 30). Autograd through the forward's own ops
    (tau held constant) missed it by up to 1.2 at scale 3."""
    rng = np.random.default_rng(int(scale * 100))
    z = (rng.standard_normal((4, 64)) * scale).astype(np.float32)
    w = rng.standard_normal((4, 64)).astype(np.float32)
    jf, tf = (j_sparsemax, sparsemax) if method == "sort" else (j_bisect, sparsemax_bisect)
    want = jax.grad(lambda x: jnp.sum(jf(x) * w))(jnp.asarray(z))
    zt = _t(z, grad=True)
    (tf(zt) * _t(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), atol=ATOL)
    support = (np.asarray(jf(jnp.asarray(z))) > 0).sum(-1)
    if scale == 30.0:
        assert support.min() == 1
    if scale == 0.05:
        assert support.min() > 10


# -- K1: codebook pooling backward -------------------------------------------
def _pool_inputs(seed, b=4, t=9, d=32, n=96, with_keep=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, d)).astype(np.float32)
    sd = rng.standard_normal((n, d)).astype(np.float32)
    keep = None
    if with_keep:
        keep = (rng.random((b, t)) > 0.3).astype(np.float32)
        keep[:, 0] = 1.0
    g = rng.standard_normal((b, n)).astype(np.float32)
    return q, sd, keep, g


def _all_negative_row(q, sd, keep):
    """Row 0 scores negative everywhere, so its pads (0) win the max."""
    sd[:] = np.abs(sd) + 0.1
    q[0] = -np.abs(q[0]) - 0.1
    keep[0] = 1.0
    keep[0, [2, 5]] = 0.0


@pytest.mark.parametrize("with_keep,n,nn,negative_row", [
    (True, 96, 512, False),
    (False, 96, 512, False),
    (True, 100, 64, False),   # the JAX tile does not divide the codebook
    (True, 96, 512, True),    # pads decide amax in row 0
])
def test_pooled_bwd_reference_matches_jax(with_keep, n, nn, negative_row):
    """The plain backward against the JAX kernels ``_pooled_bwd`` from the
    same amax (JAX's forward), so the routing is the same."""
    q, sd, keep, g = _pool_inputs(20 + n, n=n, with_keep=with_keep)
    if negative_row:
        _all_negative_row(q, sd, keep)
    jkeep = None if keep is None else jnp.asarray(keep)
    _, amax = jcb._pooled_fwd(jnp.asarray(q), jnp.asarray(sd), jkeep, 0.7, bb=2, nn=nn)
    want_dq, want_dsd = jcb._pooled_bwd(jnp.asarray(q), jnp.asarray(sd), jkeep, 0.7, amax,
                                        jnp.asarray(g), bb=2, nn=nn)
    tkeep = None if keep is None else _t(keep)
    args = (_t(q), _t(sd), tkeep, 0.7, torch.from_numpy(np.array(amax)), _t(g))
    got_dq, got_dsd = tcb.codebook_pool_bwd_reference(*args)
    np.testing.assert_allclose(got_dq.numpy(), np.asarray(want_dq), atol=ATOL)
    np.testing.assert_allclose(got_dsd.numpy(), np.asarray(want_dsd), atol=ATOL)
    # the CPU wrappers are the same plain version, entry by entry
    np.testing.assert_array_equal(tcb.codebook_pool_bwd_dq(*args).numpy(), got_dq.numpy())
    np.testing.assert_array_equal(tcb.codebook_pool_bwd_dsd(*args).numpy(), got_dsd.numpy())
    if keep is not None:  # pads get exactly zero gradient
        assert np.all(got_dq.numpy()[keep == 0] == 0)
    if negative_row:
        assert np.all(np.asarray(amax)[0] == 2)


@pytest.mark.parametrize("t,with_keep", [(144, True), (196, False)])
def test_pooled_bwd_reference_matches_jax_long_t(t, with_keep):
    """T past 128 (a 384-px ViT-B/32, the B/16 tower): the plain dq and dsd
    against the JAX kernels from JAX's amax."""
    q, sd, keep, g = _pool_inputs(50 + t, t=t, with_keep=with_keep)
    jkeep = None if keep is None else jnp.asarray(keep)
    _, amax = jcb._pooled_fwd(jnp.asarray(q), jnp.asarray(sd), jkeep, 0.7, bb=2, nn=64)
    want_dq, want_dsd = jcb._pooled_bwd(jnp.asarray(q), jnp.asarray(sd), jkeep, 0.7, amax,
                                        jnp.asarray(g), bb=2, nn=64)
    args = (_t(q), _t(sd), None if keep is None else _t(keep), 0.7,
            torch.from_numpy(np.array(amax)), _t(g))
    got_dq, got_dsd = tcb.codebook_pool_bwd_reference(*args)
    np.testing.assert_allclose(got_dq.numpy(), np.asarray(want_dq), atol=ATOL)
    np.testing.assert_allclose(got_dsd.numpy(), np.asarray(want_dsd), atol=ATOL)
    if keep is not None:
        assert np.all(got_dq.numpy()[keep == 0] == 0)


def _bf16(x: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 (round to nearest even), kept in fp32."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


@pytest.mark.parametrize("t,with_keep", [(49, False), (32, True)])
def test_dq_two_term_model_within_tolerance(t, with_keep):
    """A numpy model of dq as the TPU kernel's dense one-hot product on the
    tensor cores (the design the shipped gather was measured against): the
    routed weight w = g c keep enters as bf16 hi + bf16 lo, each product
    summed in fp32, the sum rounded to bf16. At the main path's D = 512,
    N = 4096 it stays within chip_smoke.py's POOL_BWD tolerance of the plain
    version (fp32 w, fp32 sums, bf16 out)."""
    rng = np.random.default_rng(t)
    b, d, n = 4, 512, 4096
    sd = _bf16(rng.standard_normal((n, d)).astype(np.float32))
    amax = rng.integers(0, t, (b, n))
    g = rng.standard_normal((b, n)).astype(np.float32)
    keep = np.ones((b, t), np.float32)
    if with_keep:
        keep[:, t // 2:] = 0.0
    c = np.float32(tcb.pool_coeff(d, 1.0))
    w = (g * c) * np.take_along_axis(keep, amax, axis=1)
    m = np.where(np.arange(t)[None, :, None] == amax[:, None, :], w[:, None, :], np.float32(0))
    hi = _bf16(m)
    lo = _bf16(m - hi)
    model = _bf16(np.matmul(hi, sd) + np.matmul(lo, sd))
    ref = _bf16(np.matmul(m, sd))
    err = np.abs(model - ref)
    assert np.all(err <= 1e-4 + 8e-3 * np.abs(ref)), err.max()


@pytest.mark.parametrize("with_keep,n,negative_row", [
    (True, 96, False), (False, 96, False), (True, 100, False), (True, 96, True),
])
def test_fused_codebook_attention_gradients_match_jax(with_keep, n, negative_row):
    """Autograd through ``PooledCodebookLogits``, the bisection sparsemax and
    ``att @ sd`` against ``jax.grad`` of the JAX fused chain, in q and sd.
    atol 1e-4: the sparsemax gradient and ``att @ sd`` add summation-order
    differences on gradients up to ~30."""
    q, sd, keep, g = _pool_inputs(30 + n, n=n, with_keep=with_keep)
    if negative_row:
        _all_negative_row(q, sd, keep)

    def jf(q_, sd_):
        att, ft = jcb.fused_codebook_attention(
            q_, sd_, keep_mask=None if keep is None else jnp.asarray(keep > 0),
            temperature=0.7, fwd_tiles=(2, 64), bwd_tiles=(2, 64))
        return jnp.sum(ft * ft) + jnp.sum(att * g)

    want_q, want_sd = jax.grad(jf, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(sd))
    qt, sdt = _t(q, grad=True), _t(sd, grad=True)
    att, ft = tcb.fused_codebook_attention(
        qt, sdt, keep_mask=None if keep is None else torch.from_numpy(keep > 0),
        temperature=0.7)
    ((ft * ft).sum() + (att * _t(g)).sum()).backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want_q), atol=1e-4)
    np.testing.assert_allclose(sdt.grad.numpy(), np.asarray(want_sd), atol=1e-4)


# -- K2: tiny attention backward ---------------------------------------------
@pytest.mark.parametrize("b,s,h,causal,with_bias", [
    (3, 1, 2, False, True),
    (3, 1, 2, True, False),
    (3, 13, 2, False, False),
    (3, 13, 2, True, True),
    (2, 17, 4, False, True),
    (2, 16, 2, True, False),
])
def test_tiny_attention_gradients_match_jax(b, s, h, causal, with_bias):
    """``attention_bwd_reference`` and autograd through ``fused_tiny_attention``
    (the ``TinyAttention`` Function) against ``jax.grad`` of the JAX
    ``fused_tiny_attention``: dqkv and dbias3."""
    rng = np.random.default_rng(40 + s)
    hd = 32
    d = h * hd
    qkv = rng.standard_normal((b, s, 3 * d)).astype(np.float32)
    bias3 = rng.standard_normal(3 * d).astype(np.float32)
    dout = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = np.triu(np.full((s, s), -np.inf, np.float32), k=1) if causal else None

    def jf(x, b3):
        out = jfa.fused_tiny_attention(
            x, h, bias=None if mask is None else jnp.asarray(mask), head_group=2,
            batch_block=1, qkv_bias=b3 if with_bias else None)
        return jnp.sum(out * dout)

    want_x, want_b = jax.grad(jf, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias3))
    tb = _t(bias3, grad=True) if with_bias else None
    ref = tfa.attention_bwd_reference(_t(qkv), h, causal, tb, _t(dout))
    np.testing.assert_allclose(ref.detach().numpy(), np.asarray(want_x), atol=ATOL)
    xt = _t(qkv, grad=True)
    out = tfa.fused_tiny_attention(xt, h, causal=causal, qkv_bias=tb)
    (out * _t(dout)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=ATOL)
    if with_bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_b), atol=ATOL)


@pytest.mark.parametrize("s,with_b3,dtype,causal", K2_BIAS_CASES)
def test_tiny_attention_bias_gradients_match_jax(s, with_b3, dtype, causal):
    """Autograd through ``fused_tiny_attention(qkv, h, bias)`` (the
    ``TinyAttention`` Function, plain versions on the CPU) against ``jax.vjp``
    of the JAX call: ``dqkv`` and ``dbias3``; the ``[S, S]`` bias gets no
    gradient (JAX stops it). fp32 within ATOL. bf16: dqkv as the bf16
    forward (p and ds rounded at the same places on both sides: at most
    0.1% of elements cross a rounding boundary, by at most one ulp at the
    tensor's scale). JAX sums ``dbias3`` in bf16 itself; the port sums in
    fp32 and rounds once, so it is held to the fp32 sum of JAX's ``dqkv``:
    one bf16 ulp plus the summed ``dqkv`` differences."""
    h = 2
    qkv, bias3, bias, dout, jbias = k2_bias_inputs(s, causal, seed=70 + s)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jf(x, b3):
        return jfa.fused_tiny_attention(x, h, bias=jnp.asarray(jbias), head_group=2,
                                        batch_block=2, qkv_bias=b3 if with_b3 else None)

    _, vjp = jax.vjp(jf, jnp.asarray(qkv, jdt), jnp.asarray(bias3, jdt))
    want_x, want_b = (np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout, jdt)))
    xt = torch.from_numpy(qkv).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias3).to(tdt).requires_grad_() if with_b3 else None
    tbias = torch.from_numpy(bias).requires_grad_()
    out = tfa.fused_tiny_attention(xt, h, tbias, qkv_bias=tb, causal=causal)
    out.backward(torch.from_numpy(dout).to(tdt))
    assert tbias.grad is None
    got_x = xt.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got_x, want_x, atol=ATOL)
        if with_b3:
            np.testing.assert_allclose(tb.grad.numpy(), want_b, atol=ATOL)
        return
    share, ulps = _bf16_spread(got_x, want_x)
    assert share <= 1e-3 and ulps <= 1.0, (share, ulps)
    if with_b3:
        ref_b = want_x.sum(axis=(0, 1))
        tol = (2.0 ** -7 * np.abs(ref_b) + np.abs(got_x - want_x).sum(axis=(0, 1))
               + np.finfo(np.float32).eps * np.abs(want_x).sum(axis=(0, 1)))
        assert np.all(np.abs(tb.grad.float().numpy() - ref_b) <= tol)


# -- the whole model ----------------------------------------------------------
def noisy_params():
    """The small CLIP-FDT's JAX params (one tree for both forms: the kernel
    flags do not change it), with noise on every leaf so zero biases and unit
    LayerNorm scales are live. The JAX side is jitted throughout: eager
    interpret-mode Pallas costs minutes on this CPU."""
    model = jax_model_entry(small_cfg(fused=False))
    images, tokens, pad = (jnp.asarray(x) for x in make_batch(0, 2))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), images, tokens, pad)["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                        .astype(np.float32), params)


@pytest.fixture(scope="module")
def jax_params():
    return noisy_params()


def jax_loss_grads(params, fused, batch, temperature=0.5):
    model = jax_model_entry(small_cfg(fused, temperature))

    def loss_fn(p, images, tokens, pad):
        out = model.apply({"params": p}, images, tokens, pad)
        return j_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, *(jnp.asarray(x) for x in batch))
    return float(loss), state_dict_from_jax_params(grads)


def port_loss_grads(params, fused, batch, temperature=0.5):
    port = load_jax_params(model_entry(small_cfg(fused, temperature), device="cpu"), params)
    images, tokens, pad = batch
    out = port(torch.from_numpy(images), torch.from_numpy(tokens).long(),
               torch.from_numpy(pad))
    loss, _ = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])
    loss.backward()
    return loss.item(), dict(port.named_parameters())


@pytest.mark.parametrize("fused", [True, False])
def test_model_gradients_match_jax(jax_params, fused):
    """Every parameter's gradient of the small CLIP-FDT InfoNCE loss, kernels
    on (``fused``) and off, against ``jax.grad`` mapped through the weight
    bridge. Tolerance atol 2e-5 + 1e-3 * max|grad| of the parameter: fp32 on
    both sides, but the differences of summation order pass back through the
    loss, the sparsemax threshold and two transformer layers per tower. The
    leaves the forward never reads have gradient None here and exact zeros
    in JAX; conv1 is frozen on both sides (``stop_gradient`` in JAX)."""
    batch = make_batch(6, 4)
    want_loss, want = jax_loss_grads(jax_params, fused, batch)
    got_loss, params = port_loss_grads(jax_params, fused, batch)
    assert abs(got_loss - want_loss) <= 1e-5
    assert set(params) == set(want)
    for name, p in params.items():
        w = want[name]
        if name.startswith(UNREAD) or name == "visual.conv1.weight":
            assert p.grad is None, name
            assert np.all(w == 0), name
            continue
        tol = 2e-5 + 1e-3 * np.abs(w).max()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol, err_msg=name)
        assert np.abs(w).max() > 0, name
