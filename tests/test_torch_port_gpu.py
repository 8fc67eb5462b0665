"""The port's hand-written Hopper kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: every test skips without an sm_90 CUDA device (the kernels
are CUDA C++ for sm_90a and have no CPU form). On the card, from the repo root:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

(``--noconftest``: the suite's conftest sets up JAX, which the port's machine
does not have; this file imports no JAX.) Inputs are bf16, the kernels'
working type. ``chip_smoke.py`` repeats these checks at the full serving
shapes.
"""
import gc

import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu_torch.models import layers as layers_model
from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb
from iterated_learning_for_vlm_tpu_torch.ops import flash_attention as fl
from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa
from iterated_learning_for_vlm_tpu_torch.ops import graphs

pytestmark = pytest.mark.gpu

# K2: both sides round the output to bf16 after an fp32 sum taken in another
# order, and p to bf16 before p @ v: two bf16 ulps of |out| <= 2 plus 1%.
ATTN_ATOL, ATTN_RTOL = 2e-2, 1e-2
# K1: fp32 sums of the same bf16 products in another order (512 terms).
POOL_ATOL, POOL_RTOL = 1e-4, 1e-5
# K2-bwd: dqkv rounds fp32 sums taken in another order to bf16, after p and ds
# were rounded to bf16 at the same places on both sides; as K2-fwd.
ATTN_BWD_ATOL, ATTN_BWD_RTOL = 2e-2, 1e-2
# dbias3 sums B*S such dqkv values in fp32: their independent one-ulp
# differences grow as sqrt(B*S), as the sum itself does.
BIAS_GRAD_RTOL = 1e-2
# K1-bwd: the same routed products summed in fp32 in another order, then
# rounded to bf16: one bf16 ulp (<= 2^-7 relative) plus fp32 noise near 0.
POOL_BWD_ATOL, POOL_BWD_RTOL = 1e-4, 8e-3
# K3-fwd and K3-bwd: both sides form the same fp32 values (p and ds unrounded)
# in another summation order and round once to bf16: one bf16 ulp of |ref|
# (<= 2^-7 relative), plus 1e-3 for fp32 noise on values near 0.
FLASH_ATOL, FLASH_RTOL = 1e-3, 2.0 ** -7
# K3-fwd's lse: the log-sum-exp of the same fp32 logits (bf16 products summed
# in another order), in base 2 with one log per row: ~1e-6 at |lse| <= 10.
LSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 (Hopper) device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


# the padding edges of the kernels' 16-row tiles (S16 = 16, 32, 48, 64, 80,
# 96, 128 warps' worth), with and without the causal mask and the bias, and
# the full vision grid (B = 256, H = 12)
K2_EDGES = [
    (2, 15, 2, True, True), (2, 15, 2, False, False), (2, 16, 4, False, True),
    (2, 16, 4, True, False), (2, 33, 2, True, True), (2, 33, 2, False, False),
    (2, 64, 4, False, True), (2, 64, 4, True, True), (2, 65, 2, True, False),
    (2, 65, 2, False, True), (2, 80, 8, True, True), (2, 80, 8, False, False),
    (2, 127, 4, False, True), (2, 127, 4, True, True), (256, 50, 12, False, True),
]


@pytest.mark.parametrize("b,s,h,causal,with_bias", [
    (3, 1, 2, False, False), (3, 17, 2, False, True), (2, 50, 12, False, True),
    (2, 77, 8, True, True), (2, 32, 8, True, False), (2, 128, 4, True, True),
    (2, 100, 4, False, False),
] + K2_EDGES)
def test_tiny_attention_kernel_matches_plain(dev, b, s, h, causal, with_bias):
    d = 64 * h
    g = _gen(s)
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    bias3 = bias3 if with_bias else None
    before = fa.tiny_attention_fwd.launches
    got = fa.tiny_attention_fwd(qkv, h, causal=causal, qkv_bias=bias3)
    torch.cuda.synchronize()
    assert fa.tiny_attention_fwd.launches == before + 1
    x = qkv if bias3 is None else qkv + bias3
    ref = fa.attention_reference(x, h, fa.causal_bias(s, dev) if causal else None)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, d)
    err = (got.float() - ref.float()).abs()
    assert torch.all(err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()), err.max().item()


@pytest.mark.parametrize("b,s,h,causal,with_bias", [
    (3, 1, 2, False, False), (3, 1, 2, True, True), (3, 17, 2, False, True),
    (2, 50, 12, False, True), (2, 77, 8, True, True), (2, 32, 8, True, False),
    (2, 128, 4, True, True), (2, 128, 4, False, False), (2, 100, 4, False, True),
] + K2_EDGES)
def test_tiny_attention_bwd_kernel_matches_plain(dev, b, s, h, causal, with_bias):
    d = 64 * h
    g = _gen(s + 1000)
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(b, s, d, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    bias3 = bias3 if with_bias else None
    before = fa.tiny_attention_bwd.launches
    got = fa.tiny_attention_bwd(qkv, h, causal, bias3, dout)
    torch.cuda.synchronize()
    assert fa.tiny_attention_bwd.launches == before + 1
    ref = fa.attention_bwd_reference(qkv, h, causal, bias3, dout)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    err = (got.float() - ref.float()).abs()
    assert torch.all(err <= ATTN_BWD_ATOL + ATTN_BWD_RTOL * ref.float().abs()), err.max().item()


@pytest.mark.parametrize("s,h,causal", [(50, 12, False), (77, 8, True), (32, 8, True)])
def test_tiny_attention_bwd_repeats_bit_for_bit(dev, s, h, causal):
    """Every dqkv element has one owner summing in a fixed order (no float
    atomics), so two calls agree bit for bit."""
    g = _gen(s + 3000)
    qkv = torch.randn(64, s, 3 * 64 * h, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(64, s, 64 * h, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * 64 * h, generator=g, device=dev)).to(torch.bfloat16)
    first = fa.tiny_attention_bwd(qkv, h, causal, bias3, dout)
    assert torch.equal(first, fa.tiny_attention_bwd(qkv, h, causal, bias3, dout))


def test_tiny_attention_function_bias_grad(dev):
    """Autograd through ``fused_tiny_attention`` on the card: dqkv from the
    kernel, dbias3 its fp32 sum over (B, S), against the plain backward."""
    b, s, h = 4, 50, 12
    d = 64 * h
    g = _gen(7)
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    bias3.requires_grad_()
    dout = torch.randn(b, s, d, generator=g, device=dev).to(torch.bfloat16)
    fa.fused_tiny_attention(qkv, h, qkv_bias=bias3).backward(dout)
    ref = fa.attention_bwd_reference(qkv.detach(), h, False, bias3.detach(), dout)
    err = (qkv.grad.float() - ref.float()).abs()
    assert torch.all(err <= ATTN_BWD_ATOL + ATTN_BWD_RTOL * ref.float().abs()), err.max().item()
    ref_b = ref.float().sum(dim=(0, 1))
    assert bias3.grad.dtype == torch.bfloat16
    berr = (bias3.grad.float() - ref_b).abs().max().item()
    assert berr <= BIAS_GRAD_RTOL * ref_b.abs().max().item(), berr


def _k2_bias(s, g, dev):
    """A random fp32 [S, S] logits bias with ~20% of its entries -inf and a
    finite diagonal, so every row keeps a key even under the causal mask."""
    bias = 1.5 * torch.randn(s, s, generator=g, device=dev)
    bias[torch.rand(s, s, generator=g, device=dev) < 0.2] = float("-inf")
    bias.fill_diagonal_(0.0)
    return bias


@pytest.mark.parametrize("b,s,h,causal,with_b3", [
    (2, 15, 2, False, True), (2, 15, 2, True, False), (4, 50, 12, False, True),
    (2, 77, 8, True, True), (2, 77, 8, False, False), (2, 128, 4, False, True),
    (2, 128, 4, True, True),
])
def test_tiny_attention_bias_kernels_match_plain(dev, b, s, h, causal, with_b3):
    """``fused_tiny_attention(qkv, h, bias)`` on the card: K2-fwd and K2-bwd
    launch once each with the [S, S] bias (composed with the causal flag),
    match their plain versions, give the bias no gradient, and the backward
    repeats bit for bit."""
    d = 64 * h
    g = _gen(s + 4000)
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    bias3 = (0.3 * torch.randn(3 * d, generator=g, device=dev)).to(torch.bfloat16)
    bias3 = bias3 if with_b3 else None
    dout = torch.randn(b, s, d, generator=g, device=dev).to(torch.bfloat16)
    bias = _k2_bias(s, g, dev).requires_grad_()
    before = (fa.tiny_attention_fwd.launches, fa.tiny_attention_bwd.launches)
    x = qkv.clone().requires_grad_()
    out = fa.fused_tiny_attention(x, h, bias, qkv_bias=bias3, causal=causal)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.tiny_attention_fwd.launches, fa.tiny_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert bias.grad is None
    full = bias.detach() + (fa.causal_bias(s, dev) if causal else 0.0)
    ref = fa.attention_reference(qkv if bias3 is None else qkv + bias3, h, full)
    err = (out.float() - ref.float()).abs()
    assert torch.all(err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()), err.max().item()
    ref_g = fa.attention_bwd_reference(qkv, h, causal, bias3, dout, bias.detach())
    err = (x.grad.float() - ref_g.float()).abs()
    assert torch.all(err <= ATTN_BWD_ATOL + ATTN_BWD_RTOL * ref_g.float().abs()), err.max().item()
    args = (qkv, h, causal, bias3, dout, bias.detach())
    assert torch.equal(fa.tiny_attention_bwd(*args), fa.tiny_attention_bwd(*args))


def test_tiny_attention_bias_all_masked_row(dev):
    """A bias that masks every key of row 3: kernel and plain version both
    give that row zeros in the output and in dq, and agree elsewhere."""
    b, s, h = 2, 50, 4
    g = _gen(11)
    qkv = torch.randn(b, s, 3 * 64 * h, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(b, s, 64 * h, generator=g, device=dev).to(torch.bfloat16)
    bias = _k2_bias(s, g, dev)
    bias[3] = float("-inf")
    got = fa.tiny_attention_fwd(qkv, h, bias=bias)
    ref = fa.attention_reference(qkv, h, bias)
    assert torch.all(got[:, 3] == 0) and torch.all(ref[:, 3] == 0)
    err = (got.float() - ref.float()).abs()
    assert torch.all(err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()), err.max().item()
    got_g = fa.tiny_attention_bwd(qkv, h, False, None, dout, bias)
    ref_g = fa.attention_bwd_reference(qkv, h, False, None, dout, bias)
    assert torch.all(got_g[:, 3, :64 * h] == 0) and torch.isfinite(ref_g).all()
    err = (got_g.float() - ref_g.float()).abs()
    assert torch.all(err <= ATTN_BWD_ATOL + ATTN_BWD_RTOL * ref_g.float().abs()), err.max().item()


def _flash_case(dev, b, s, h, bias_kind, seed):
    """q, k, v as the [B, S, H, 64] column-block views of one packed
    [B, S, 3D] tensor (the tower route's layout), a contiguous output
    gradient, the bias (none, causal, or arbitrary with some -inf) and the
    causal flag ("flag": the causal mask by index, no bias)."""
    g = _gen(seed)
    d = 64 * h
    qkv = torch.randn(b, s, 3 * d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, 64) for t in qkv.split(d, dim=-1))
    dout = torch.randn(b, s, h, 64, generator=g, device=dev).to(torch.bfloat16)
    bias = None
    if bias_kind == "causal":
        bias = fa.causal_bias(s, dev)
    elif bias_kind == "random":
        bias = torch.randn(s, s, generator=g, device=dev)
        bias[torch.rand(s, s, generator=g, device=dev) < 0.2] = float("-inf")
        bias[:, 0] = 0.0
    return q, k, v, dout, bias, bias_kind == "flag"


def _assert_flash_close(name, got, ref):
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
    err = (got.float() - ref.float()).abs()
    assert torch.all(err <= FLASH_ATOL + FLASH_RTOL * ref.float().abs()), (name, err.max().item())


# the tower shapes (text S=32 and 77 causal, vision S=50, ViT-B/16 S=197,
# L/14 S=257), the edges (S=1, the S bound) and an arbitrary bias; every
# causal case both by the flag and by the causal bias
FLASH_CASES = [
    (3, 1, 2, "none"), (2, 32, 8, "causal"), (2, 32, 8, "flag"), (4, 50, 12, "none"),
    (2, 77, 8, "causal"), (2, 77, 8, "flag"), (2, 197, 12, "none"), (2, 257, 16, "none"),
    (2, 257, 4, "causal"), (2, 257, 4, "flag"), (2, 100, 4, "random"), (1, 1024, 2, "causal"),
    (1, 1024, 2, "flag"), (2, 1024, 1, "none"),
]


@pytest.mark.parametrize("b,s,h,bias_kind", FLASH_CASES)
def test_flash_attention_kernels_match_plain(dev, b, s, h, bias_kind):
    """K3-fwd (with lse) and K3-bwd (from the plain version's lse) against
    their plain versions; one launch count each."""
    q, k, v, dout, bias, causal = _flash_case(dev, b, s, h, bias_kind, seed=s)
    ref_out, ref_lse = fl.flash_attention_lse_reference(q, k, v, bias, causal)
    before = (fl.flash_attention_fwd.launches, fl.flash_attention_bwd.launches)
    out, _ = fl.flash_attention_fwd(q, k, v, bias, causal, with_lse=True)
    grads = fl.flash_attention_bwd(q, k, v, bias, ref_lse, dout, causal)
    torch.cuda.synchronize()
    assert (fl.flash_attention_fwd.launches, fl.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_flash_close("out", out, ref_out)
    refs = fl.flash_attention_bwd_reference(q, k, v, bias, ref_lse, dout, causal)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        _assert_flash_close(name, got, ref)


@pytest.mark.parametrize("b,s,h,bias_kind", [
    (3, 1, 2, "none"), (2, 77, 8, "flag"), (2, 77, 8, "causal"), (2, 197, 12, "none"),
    (2, 100, 4, "random"), (1, 1024, 2, "flag"),
])
def test_flash_attention_lse_matches_plain(dev, b, s, h, bias_kind):
    """K3-fwd's row log-sum-exp against the plain version's (fp32 sums of the
    same bf16 products in another order, taken in base 2: LSE_ATOL), and the
    serving call (no lse) gives the same output bit for bit."""
    q, k, v, _, bias, causal = _flash_case(dev, b, s, h, bias_kind, seed=s + 500)
    out, lse = fl.flash_attention_fwd(q, k, v, bias, causal, with_lse=True)
    _, ref = fl.flash_attention_lse_reference(q, k, v, bias, causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    err = (lse - ref).abs().max().item()
    assert err <= LSE_ATOL, err
    assert torch.equal(out, fl.flash_attention_fwd(q, k, v, bias, causal))


@pytest.mark.parametrize("s,h,bias_kind", [(197, 12, "none"), (77, 8, "flag")])
def test_flash_attention_bwd_repeats_bit_for_bit(dev, s, h, bias_kind):
    """Every gradient element has one owner summing in a fixed order (no
    float atomics), so two calls agree bit for bit."""
    q, k, v, dout, bias, causal = _flash_case(dev, 8, s, h, bias_kind, seed=s + 3)
    _, lse = fl.flash_attention_fwd(q, k, v, bias, causal, with_lse=True)
    first = fl.flash_attention_bwd(q, k, v, bias, lse, dout, causal)
    second = fl.flash_attention_bwd(q, k, v, bias, lse, dout, causal)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("route", ["flag", "bias"])
def test_flash_attention_function_autograd(dev, route):
    """Autograd through ``flash_attention`` from the packed tensor: the
    [B, S, 3D] gradient is the kernels' dq | dk | dv (the backward from the
    forward's saved lse), against the plain backward; the causal mask as
    the flag or as a bias, which gets no gradient."""
    b, s, h = 3, 77, 8
    g = _gen(11)
    qkv = torch.randn(b, s, 3 * 64 * h, generator=g, device=dev).to(torch.bfloat16)
    qkv.requires_grad_()
    dout = torch.randn(b, s, h, 64, generator=g, device=dev).to(torch.bfloat16)
    bias = fa.causal_bias(s, dev).requires_grad_()
    q, k, v = (t.reshape(b, s, h, 64) for t in qkv.split(64 * h, dim=-1))
    if route == "flag":
        fl.flash_attention(q, k, v, causal=True).backward(dout)
    else:
        fl.flash_attention(q, k, v, bias[None, None]).backward(dout)
    q, k, v = (t.detach() for t in (q, k, v))
    _, lse = fl.flash_attention_lse_reference(q, k, v, bias.detach())
    refs = fl.flash_attention_bwd_reference(q, k, v, bias.detach(), lse, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), qkv.grad.split(64 * h, dim=-1), refs):
        _assert_flash_close(name, got.reshape(b, s, h, 64), ref)
    assert bias.grad is None


def _pool_case(dev, b, t, d, n, with_keep, seed):
    g = _gen(seed)
    q = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
    sd = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    keep = None
    if with_keep:
        keep = (torch.rand(b, t, generator=g, device=dev) > 0.3).float()
        keep[:, 0] = 1.0
    return q, sd, keep


def _check_pool(q, sd, keep, temp):
    got_p, got_a = cb.codebook_pool_fwd(q, sd, keep, temp)
    ref_p, ref_a = cb.codebook_pool_fwd_reference(q, sd, keep, temp)
    torch.cuda.synchronize()
    err = (got_p - ref_p).abs()
    assert torch.all(err <= POOL_ATOL + POOL_RTOL * ref_p.abs()), err.max().item()
    inner = torch.einsum("btd,nd->btn", q.float(), sd.float()) * q.shape[-1] ** -0.5
    if keep is not None:
        inner = inner * keep[..., None]
    top2 = (inner / temp).topk(min(2, q.shape[1]), dim=1).values
    decided = (top2[:, 0] - top2[:, -1] > 10 * POOL_ATOL) | (top2[:, 0] == top2[:, -1])
    assert torch.equal(got_a[decided], ref_a[decided])
    return got_p, got_a


@pytest.mark.parametrize("b,t,d,n,with_keep,temp", [
    (3, 1, 64, 96, False, 1.0), (4, 13, 128, 200, True, 0.37), (2, 49, 512, 4096, False, 125.0),
    (3, 77, 512, 4096, True, 1.0), (2, 32, 512, 1000, True, 3.0), (2, 128, 64, 130, True, 1.0),
])
def test_codebook_pool_kernel_matches_plain(dev, b, t, d, n, with_keep, temp):
    q, sd, keep = _pool_case(dev, b, t, d, n, with_keep, seed=t)
    before = cb.codebook_pool_fwd.launches
    _check_pool(q, sd, keep, temp)
    assert cb.codebook_pool_fwd.launches == before + 1


def test_codebook_pool_pads_enter_as_zero(dev):
    """An all-negative row: pads (0) win, ties going to the first pad."""
    q, sd, keep = _pool_case(dev, 3, 9, 64, 96, True, seed=5)
    sd = sd.abs() + 0.1
    q[0] = -(q[0].abs() + 0.1)
    keep[0] = torch.tensor([1, 1, 0, 1, 0, 0, 1, 1, 1], dtype=torch.float32, device=dev)
    got_p, got_a = _check_pool(q, sd, keep, 2.0)
    assert torch.all(got_p[0] == 0) and torch.all(got_a[0] == 2)


@pytest.mark.parametrize("b,t,d,n,with_keep,temp", [
    (3, 1, 64, 96, False, 1.0), (3, 1, 64, 96, True, 1.0), (4, 13, 128, 200, True, 0.37),
    (2, 49, 512, 4096, False, 125.0), (3, 77, 512, 4096, True, 1.0),
    (2, 32, 512, 1000, True, 3.0), (2, 128, 64, 130, True, 1.0),
    (2, 128, 512, 4093, True, 1.0),
])
def test_codebook_pool_bwd_kernels_match_plain(dev, b, t, d, n, with_keep, temp):
    """dq and dsd from the same amax (the forward kernel's) on both sides, so
    the routing is identical and only the summation order differs."""
    q, sd, keep = _pool_case(dev, b, t, d, n, with_keep, seed=t + 100)
    _, amax = cb.codebook_pool_fwd(q, sd, keep, temp)
    gp = torch.randn(b, n, generator=_gen(n), device=dev)
    before = (cb.codebook_pool_bwd_dq.launches, cb.codebook_pool_bwd_dsd.launches)
    dq, dsd = cb.codebook_pool_bwd(q, sd, keep, temp, amax, gp)
    torch.cuda.synchronize()
    assert (cb.codebook_pool_bwd_dq.launches, cb.codebook_pool_bwd_dsd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_dq, ref_dsd = cb.codebook_pool_bwd_reference(q, sd, keep, temp, amax, gp)
    for name, got, ref in (("dq", dq, ref_dq), ("dsd", dsd, ref_dsd)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        err = (got.float() - ref.float()).abs()
        ok = err <= POOL_BWD_ATOL + POOL_BWD_RTOL * ref.float().abs()
        assert torch.all(ok), (name, err.max().item())
    if keep is not None:  # pads get exactly zero gradient
        assert torch.all(dq[keep == 0] == 0)


# T from 1 to 1024 across the 16-row tiles and the forward's 64-row steps
# (a sample inside one step, across two, over many), ragged N (4000 codes:
# a partial last code tile), with and without pads; B = 64 gives each
# forward block 16 samples, 8 a row group
K1_TOKENS = [1, 15, 16, 17, 49, 64, 77, 128, 129, 144, 196, 200, 512, 1024]


@pytest.mark.parametrize("t", K1_TOKENS)
@pytest.mark.parametrize("with_keep", [False, True])
def test_codebook_pool_kernels_any_t(dev, t, with_keep):
    """K1-fwd, K1-bwd dq and dsd against their plain versions at any T, the
    backward from the forward kernel's amax."""
    b, d, n = 64, 128, 4000
    q, sd, keep = _pool_case(dev, b, t, d, n, with_keep, seed=t + 7)
    _, amax = _check_pool(q, sd, keep, 0.7)
    gp = torch.randn(b, n, generator=_gen(t), device=dev)
    args = (q, sd, keep, 0.7, amax, gp)
    ref_dq, ref_dsd = cb.codebook_pool_bwd_reference(*args)
    for name, got, ref in (("dq", cb.codebook_pool_bwd_dq(*args), ref_dq),
                           ("dsd", cb.codebook_pool_bwd_dsd(*args), ref_dsd)):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        assert torch.all(err <= POOL_BWD_ATOL + POOL_BWD_RTOL * ref.float().abs()), (
            name, err.max().item())
        if keep is not None and name != "dsd":
            assert torch.all(got[keep == 0] == 0), name


@pytest.mark.parametrize("b,t,d,n", [(6, 49, 1024, 500), (3, 196, 1024, 4096), (70, 3, 64, 96),
                                     (3, 5, 64, 9000)])
def test_codebook_pool_kernels_depth_edges(dev, b, t, d, n):
    """D = 1024 (the forward's 64-code tiles), D = 64 (one depth chunk), and
    N = 9000, too many codes for dq's resident codebook slice (read in place)."""
    q, sd, keep = _pool_case(dev, b, t, d, n, True, seed=d + t)
    _, amax = _check_pool(q, sd, keep, 1.3)
    gp = torch.randn(b, n, generator=_gen(d), device=dev)
    args = (q, sd, keep, 1.3, amax, gp)
    for got, ref in zip(cb.codebook_pool_bwd(*args), cb.codebook_pool_bwd_reference(*args)):
        err = (got.float() - ref.float()).abs()
        assert torch.all(err <= POOL_BWD_ATOL + POOL_BWD_RTOL * ref.float().abs()), err.max().item()


@pytest.mark.parametrize("t", [49, 196])
def test_codebook_pool_kernels_repeat_bit_for_bit(dev, t):
    """K1-fwd (pooled and amax) and K1-bwd dq at B = 256, D = 512, N = 4096:
    every output element has one owner reducing in a fixed order (dq's
    routing sorted without atomics), so two calls agree bit for bit."""
    q, sd, keep = _pool_case(dev, 256, t, 512, 4096, False, seed=t + 11)
    first = cb.codebook_pool_fwd(q, sd, keep, 1.0)
    second = cb.codebook_pool_fwd(q, sd, keep, 1.0)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    gp = torch.randn(256, 4096, generator=_gen(t + 1), device=dev)
    args = (q, sd, keep, 1.0, first[1], gp)
    assert torch.equal(cb.codebook_pool_bwd_dq(*args), cb.codebook_pool_bwd_dq(*args))


# dsd's ring: a stage holds min(8, 256 // T) batch rows' slices in one
# tensor copy up to T = 256, one row in several copies past it, and the
# slice rows are read in place past T = 888; each edge from both sides (8
# rows a stage to 7 at T = 33, 2 to 1 at T = 129, one copy to two at 257,
# 4 stages to 2 at 437)
DSD_RING_EDGES = [12, 13, 32, 33, 128, 129, 256, 257, 436, 437, 888, 889]


@pytest.mark.parametrize("t", DSD_RING_EDGES)
def test_codebook_pool_dsd_ring_edges(dev, t):
    """K1-bwd dsd on both sides of each change of its ring's depth, with a
    ragged last code tile (N = 600) and pads, against the plain version."""
    b, d, n = 6, 128, 600
    q, sd, keep = _pool_case(dev, b, t, d, n, True, seed=t + 9)
    _, amax = cb.codebook_pool_fwd(q, sd, keep, 0.9)
    gp = torch.randn(b, n, generator=_gen(t + 1), device=dev)
    args = (q, sd, keep, 0.9, amax, gp)
    before = cb.codebook_pool_bwd_dsd.launches
    got = cb.codebook_pool_bwd_dsd(*args)
    torch.cuda.synchronize()
    assert cb.codebook_pool_bwd_dsd.launches == before + 1
    ref = cb.codebook_pool_bwd_dsd_reference(*args)
    err = (got.float() - ref.float()).abs()
    assert torch.all(err <= POOL_BWD_ATOL + POOL_BWD_RTOL * ref.float().abs()), err.max().item()


@pytest.mark.parametrize("t,n", [(49, 4096), (32, 4093), (889, 300)])
def test_codebook_pool_dsd_all_pad_row_adds_nothing(dev, t, n):
    """A batch row whose keep is all 0 routes weight 0 to every code: dsd
    with it equals, bit for bit, dsd of the batch without it (each element
    summed in order, so a zero term changes nothing), and matches the plain
    version. N = 4093 ends in a partial code tile, T = 889 reads the rows in
    place."""
    b, d = 5, 512
    q, sd, keep = _pool_case(dev, b, t, d, n, True, seed=t + 21)
    keep[2] = 0.0
    _, amax = cb.codebook_pool_fwd(q, sd, keep, 1.0)
    gp = torch.randn(b, n, generator=_gen(t + 2), device=dev)
    got = cb.codebook_pool_bwd_dsd(q, sd, keep, 1.0, amax, gp)
    ref = cb.codebook_pool_bwd_dsd_reference(q, sd, keep, 1.0, amax, gp)
    err = (got.float() - ref.float()).abs()
    assert torch.all(err <= POOL_BWD_ATOL + POOL_BWD_RTOL * ref.float().abs()), err.max().item()
    rows = [0, 1, 3, 4]
    without = cb.codebook_pool_bwd_dsd(q[rows].contiguous(), sd, keep[rows].contiguous(), 1.0,
                                       amax[rows].contiguous(), gp[rows].contiguous())
    assert torch.equal(got, without)


@pytest.mark.parametrize("t", [32, 49, 196, 1024])
def test_codebook_pool_dsd_repeats_bit_for_bit(dev, t):
    """K1-bwd dsd at B = 256, D = 512, N = 4096 (T = 1024 on the in-place
    rows): one thread sums each element in batch order, no atomics, so two
    calls agree bit for bit."""
    q, sd, keep = _pool_case(dev, 256 if t < 1024 else 32, t, 512, 4096, t == 32, seed=t + 13)
    _, amax = cb.codebook_pool_fwd(q, sd, keep, 1.0)
    gp = torch.randn(q.shape[0], 4096, generator=_gen(t + 3), device=dev)
    args = (q, sd, keep, 1.0, amax, gp)
    assert torch.equal(cb.codebook_pool_bwd_dsd(*args), cb.codebook_pool_bwd_dsd(*args))


def test_wrappers_raise_on_unsupported_cuda_inputs(dev):
    with pytest.raises(ValueError, match="bias must"):
        fa.fused_tiny_attention(torch.zeros(1, 4, 3 * 64, dtype=torch.bfloat16, device=dev),
                                1, fa.causal_bias(5, dev))
    with pytest.raises(ValueError, match="bias must"):
        fa.tiny_attention_fwd(torch.zeros(1, 4, 3 * 64, dtype=torch.bfloat16, device=dev), 1,
                              bias=fa.causal_bias(4, dev).to(torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.tiny_attention_fwd(torch.zeros(1, 4, 3 * 64, device=dev), 1)
    with pytest.raises(ValueError, match="bfloat16"):
        cb.codebook_pool_fwd(torch.zeros(1, 4, 64, device=dev),
                             torch.zeros(8, 64, device=dev), None, 1.0)
    bf = torch.bfloat16
    qkv = torch.zeros(2, 4, 3 * 64, dtype=bf, device=dev)
    with pytest.raises(ValueError, match="dout"):
        fa.tiny_attention_bwd(qkv, 1, False, None, torch.zeros(2, 4, 64, device=dev))
    with pytest.raises(ValueError, match="S <="):
        fa.tiny_attention_bwd(torch.zeros(1, 129, 3 * 64, dtype=bf, device=dev), 1, False,
                              None, torch.zeros(1, 129, 64, dtype=bf, device=dev))
    q, sd = torch.zeros(2, 4, 64, dtype=bf, device=dev), torch.zeros(8, 64, dtype=bf, device=dev)
    amax = torch.zeros(2, 8, dtype=torch.int32, device=dev)
    gp = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError, match="amax"):
        cb.codebook_pool_bwd_dq(q, sd, None, 1.0, amax.long(), gp)
    with pytest.raises(ValueError, match="g must"):
        cb.codebook_pool_bwd_dsd(q, sd, None, 1.0, amax, gp.to(bf))
    with pytest.raises(ValueError, match="bfloat16"):
        fl.flash_attention_fwd(*(torch.zeros(1, 4, 2, 64, device=dev),) * 3)
    big = torch.zeros(1, fl.MAX_SEQ + 1, 1, 64, dtype=bf, device=dev)
    with pytest.raises(ValueError, match="S <="):
        fl.flash_attention_fwd(big, big, big)
    qh = torch.zeros(2, 4, 1, 64, dtype=bf, device=dev)
    lse = torch.zeros(2, 1, 4, device=dev)
    with pytest.raises(ValueError, match="dout"):
        fl.flash_attention_bwd(qh, qh, qh, None, lse, torch.zeros(2, 4, 1, 64, device=dev))
    with pytest.raises(ValueError, match="lse"):
        fl.flash_attention_bwd(qh, qh, qh, None, lse.to(bf), qh)
    with pytest.raises(ValueError, match="D <="):
        cb.codebook_pool_bwd_dsd(torch.zeros(2, 4, 1088, dtype=bf, device=dev),
                                 torch.zeros(8, 1088, dtype=bf, device=dev), None, 1.0,
                                 amax, gp)
    with pytest.raises(ValueError, match="D <="):
        cb.codebook_pool_fwd(torch.zeros(2, 4, 1088, dtype=bf, device=dev),
                             torch.zeros(8, 1088, dtype=bf, device=dev), None, 1.0)


def _small_cfg(fused):
        return {"type": "clip_fdt_vitb32", "kwargs": {
            "image_encode": {"input_resolution": 64, "patch_size": 16, "width": 128,
                             "layers": 2, "heads": 2, "embed_dim": 64},
            "text_encode": {"context_length": 20, "vocab_size": 300, "width": 128,
                            "heads": 2, "layers": 2, "embed_dim": 64},
            "fdt": {"sd_num": 256, "sd_dim": 64, "raw_img_ft_dim": 128,
                    "raw_txt_ft_dim": 128, "sparsemax_method": "bisect",
                    "use_fused_kernel": fused, "sd_temperature": 2.0},
            "fused_attn": fused, "dtype": "bfloat16"}}


def _small_pair(dev):
    """The small bf16 CLIP-FDT (head_dim 64, codebook depth 64) on the kernel
    path and the same weights on the plain path, and a batch of 5."""
    fast = model_entry(_small_cfg(True), device=dev, generator=_gen(0))
    plain = model_entry(_small_cfg(False), device=dev, generator=_gen(1))
    plain.load_state_dict(fast.state_dict())
    g = _gen(2)
    images = torch.randn(5, 64, 64, 3, generator=g, device=dev)
    tokens = torch.randint(1, 298, (5, 20), generator=g, device=dev)
    tokens[:, 9] = 299
    tokens[:, 10:] = 0
    pad = torch.zeros(5, 20, device=dev)
    pad[:, 10:] = float("-inf")
    return fast, plain, (images, tokens, pad)


def test_model_kernel_path_matches_plain_path(dev):
    """Both kernels' forwards against the same weights on the plain path;
    cosine >= 0.999 per embedding (bf16 towers, rounding at the same places
    in another order)."""
    fast, plain, (images, tokens, pad) = _small_pair(dev)
    with torch.no_grad():
        a = fast(images, tokens, pad)
        b = plain(images, tokens, pad)
    for key in ("image_embed", "text_embed"):
        cos = (a[key] * b[key]).sum(-1)
        assert torch.all(cos >= 0.999), (key, cos.min().item())


def test_model_gradients_kernel_path_match_plain_path(dev):
    """Autograd through the small model, all four kernels (K1 and K2, forward
    and backward) against the plain path from the same weights: cosine >= 0.99
    per parameter gradient (bf16 towers; the two paths round the codebook
    product and the attention at other places), exact zeros on the leaves the
    FDT forward never reads."""
    from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce

    fast, plain, batch = _small_pair(dev)
    counts = (fa.tiny_attention_bwd.launches, cb.codebook_pool_bwd_dq.launches,
              cb.codebook_pool_bwd_dsd.launches)
    grads = []
    for model in (fast, plain):
        out = model(*batch)
        loss, _ = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    torch.cuda.synchronize()
    assert (fa.tiny_attention_bwd.launches - counts[0], cb.codebook_pool_bwd_dq.launches
            - counts[1], cb.codebook_pool_bwd_dsd.launches - counts[2]) == (4, 2, 2)
    unread = ("visual.ln_post.", "visual.proj", "encode_text.text_projection.", "logit_scale_sd")
    for name, ga in grads[0].items():
        gb = grads[1][name]
        if name.startswith(unread):
            assert ga is None and gb is None, name
            continue
        cos = torch.nn.functional.cosine_similarity(ga.flatten().float(), gb.flatten().float(),
                                                    dim=0).item()
        assert cos >= 0.99, (name, cos)


def test_clip_flash_route_matches_plain_route(dev):
    """A small bf16 CLIP (head_dim 64) on the flash route against the same
    weights on the plain route: embeddings at cosine >= 0.999, every
    gradient at cosine >= 0.99, and K3 launched once per layer each way."""
    from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce

    def cfg(flash):
        return {"type": "clip_vitb32", "kwargs": {
            "image_encode": {"input_resolution": 64, "patch_size": 16, "width": 128,
                             "layers": 2, "heads": 2, "embed_dim": 64},
            "text_encode": {"context_length": 20, "vocab_size": 300, "width": 128,
                            "heads": 2, "layers": 2, "embed_dim": 64},
            "use_flash": flash, "dtype": "bfloat16"}}

    fast = model_entry(cfg(True), device=dev, generator=_gen(0))
    plain = model_entry(cfg(False), device=dev, generator=_gen(1))
    plain.load_state_dict(fast.state_dict())
    _, _, batch = _small_pair(dev)
    before = (fl.flash_attention_fwd.launches, fl.flash_attention_bwd.launches)
    grads, outs = [], []
    for model in (fast, plain):
        out = model(*batch)
        loss, _ = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])
        loss.backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    torch.cuda.synchronize()
    assert (fl.flash_attention_fwd.launches - before[0],
            fl.flash_attention_bwd.launches - before[1]) == (4, 4)
    for key in ("image_embed", "text_embed"):
        cos = (outs[0][key] * outs[1][key]).sum(-1)
        assert torch.all(cos >= 0.999), (key, cos.min().item())
    for name, ga in grads[0].items():
        cos = torch.nn.functional.cosine_similarity(ga.flatten().float(),
                                                    grads[1][name].flatten().float(), dim=0)
        assert cos.item() >= 0.99, (name, cos.item())


def test_clip_flash_route_launch_counts(dev):
    """A small bf16 CLIP with the baseline's 12 layers a tower on the flash
    route: one train step launches K3-fwd and K3-bwd 24 times each and no
    other kernel; serving images and texts at two context buckets launches
    K3-fwd 36 times and nothing else."""
    import numpy as np

    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
    from iterated_learning_for_vlm_tpu_torch.train import optim, schedule
    from iterated_learning_for_vlm_tpu_torch.train.step import make_train_step
    from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState

    model = model_entry({"type": "clip_vitb32", "kwargs": {
        "image_encode": {"input_resolution": 64, "patch_size": 16, "width": 128,
                         "layers": 12, "heads": 2, "embed_dim": 64},
        "text_encode": {"context_length": 77, "vocab_size": 300, "width": 128, "heads": 2,
                        "layers": 12, "embed_dim": 64},
        "use_flash": True, "dtype": "bfloat16"}}, device=dev, generator=_gen(0))
    counted = (fa.tiny_attention_fwd, fa.tiny_attention_bwd, cb.codebook_pool_fwd,
               cb.codebook_pool_bwd_dq, cb.codebook_pool_bwd_dsd, fl.flash_attention_fwd,
               fl.flash_attention_bwd)

    def launches(fn):
        before = [c.launches for c in counted]
        fn()
        torch.cuda.synchronize()
        return [c.launches - n for c, n in zip(counted, before)]

    params = dict(model.named_parameters())
    state = TrainState.create(params, optim.adamw_init(params),
                              optim.trainable_mask_tree(params), None)
    step = make_train_step(model, schedule.cosine(5e-5, 5e-4, 0.0, 10, 100),
                           optim.build_wd_tree(params, 0.1, {}), is_fdt=False)
    g = _gen(2)
    tokens = torch.randint(1, 298, (4, 32), generator=g, device=dev)
    tokens[:, 20] = 299
    pad = torch.zeros(4, 32, device=dev)
    pad[:, 21:] = float("-inf")
    batch = {"image": torch.randn(4, 64, 64, 3, generator=g, device=dev), "tokens": tokens,
             "pad_mask": pad}
    assert launches(lambda: step(state, batch, 0.0)) == [0, 0, 0, 0, 0, 24, 24]

    rng = np.random.default_rng(0)
    enc = TorchEncoder(model, batch_size=4, text_buckets=(16, 32))
    images = rng.standard_normal((4, 64, 64, 3), dtype=np.float32)
    texts = []
    for n in (30, 77):  # the ctx-32 bucket, then the full context
        tok = np.zeros((4, 77), np.int64)
        tok[:, :n] = rng.integers(1, 298, (4, n))
        tok[:, n - 1] = 299
        p = np.full((4, 77), -np.inf, np.float32)
        p[:, :n] = 0.0
        texts.append((tok, p))

    def serve():
        enc.encode_images(images)
        for tok, p in texts:
            enc.encode_texts_tokens(tok, p)

    assert launches(serve) == [0, 0, 0, 0, 0, 36, 0]


def _grads_of(model, batch):
    from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce

    out = model(*batch)
    loss, _ = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])
    loss.backward()
    return out, {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def _assert_paths_agree(a, b, min_cos=0.999, min_grad_cos=0.99):
    """Embeddings at cosine >= 0.999, every gradient at cosine >= 0.99 (the
    small-model bounds above), no gradient on one path only."""
    (out_a, grads_a), (out_b, grads_b) = a, b
    for key in ("image_embed", "text_embed"):
        cos = (out_a[key] * out_b[key]).sum(-1)
        assert torch.all(cos >= min_cos), (key, cos.min().item())
    for name, ga in grads_a.items():
        gb = grads_b[name]
        assert (ga is None) == (gb is None), name
        if ga is not None:
            cos = torch.nn.functional.cosine_similarity(ga.flatten().float(),
                                                        gb.flatten().float(), dim=0).item()
            assert cos >= min_grad_cos, (name, cos)


def _counts():
    """Every registered counter (``ops/graphs.py``) by name."""
    return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in graphs.COUNTERS}


def _deltas(before):
    """The counters that moved since ``before``, by how much."""
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _moved(**by_name):
    """``_deltas`` of the named wrappers' launches and routes' refusals."""
    return {f"{n}.{'plain_routes' if n.endswith('_route') else 'launches'}": v
            for n, v in by_name.items() if v}


def _graph_counts(cache):
    """A ``GraphCache``'s eager calls, captures and replays."""
    return cache.eager, cache.captures, cache.replays


def test_fdt_long_t_takes_the_codebook_kernels(dev):
    """A small bf16 CLIP-FDT at 96 px, patch 8: T = 144 image tokens, past
    the old 128 cap. Forward and backward run K1 (fwd, dq and dsd once a
    tower) and match the plain branch from the same weights."""
    def cfg(fused):
        c = _small_cfg(fused)
        c["kwargs"]["image_encode"].update(input_resolution=96, patch_size=8)
        c["kwargs"]["fused_attn"] = False
        return c

    fast = model_entry(cfg(True), device=dev, generator=_gen(0))
    plain = model_entry(cfg(False), device=dev, generator=_gen(1))
    plain.load_state_dict(fast.state_dict())
    _, _, (_, tokens, pad) = _small_pair(dev)
    images = torch.randn(5, 96, 96, 3, generator=_gen(3), device=dev)
    before = _counts()
    got = _grads_of(fast, (images, tokens, pad))
    torch.cuda.synchronize()
    assert _deltas(before) == _moved(codebook_pool_fwd=2, codebook_pool_bwd_dq=2,
                                     codebook_pool_bwd_dsd=2)
    _assert_paths_agree(got, _grads_of(plain, (images, tokens, pad)))


def test_fdt_fp32_knobs_route_to_plain(dev):
    """An fp32 CLIP-FDT with ``fused_attn`` and ``use_fused_kernel``: the
    kernels take bf16 only, so every call routes to the plain path (counted:
    4 attention calls and 2 codebook calls a forward), launches nothing, and
    matches the same weights with both knobs off."""
    def cfg(fused):
        c = _small_cfg(fused)
        c["kwargs"]["dtype"] = "float32"
        return c

    fast = model_entry(cfg(True), device=dev, generator=_gen(0))
    plain = model_entry(cfg(False), device=dev, generator=_gen(1))
    plain.load_state_dict(fast.state_dict())
    _, _, batch = _small_pair(dev)
    before = _counts()
    got = _grads_of(fast, batch)
    torch.cuda.synchronize()
    assert _deltas(before) == _moved(attention_route=4, codebook_route=2)
    _assert_paths_agree(got, _grads_of(plain, batch))


def test_clip_head_width_32_flash_knob_routes_to_plain(dev):
    """A bf16 CLIP with head width 32 (width 128, 4 heads) under
    ``use_flash``: K3 takes head width 64 only, so each of the 4 attention
    calls a forward takes the plain path (counted), nothing launches, and it
    matches the plain route from the same weights."""
    def cfg(flash):
        return {"type": "clip_vitb32", "kwargs": {
            "image_encode": {"input_resolution": 64, "patch_size": 16, "width": 128,
                             "layers": 2, "heads": 4, "embed_dim": 64},
            "text_encode": {"context_length": 20, "vocab_size": 300, "width": 128,
                            "heads": 4, "layers": 2, "embed_dim": 64},
            "use_flash": flash, "dtype": "bfloat16"}}

    fast = model_entry(cfg(True), device=dev, generator=_gen(0))
    plain = model_entry(cfg(False), device=dev, generator=_gen(1))
    plain.load_state_dict(fast.state_dict())
    _, _, batch = _small_pair(dev)
    before = _counts()
    got = _grads_of(fast, batch)
    torch.cuda.synchronize()
    assert _deltas(before) == _moved(attention_route=4)
    _assert_paths_agree(got, _grads_of(plain, batch))


def _solver_cfg(train=None):
    """A two-layer bf16 CLIP-FDT Solver config with both kernels on (head
    width 64, codebook depth 64), on synthetic batches of 8 at ctx 20 (or the
    data block ``train``): IL on (reset at step 4, smooth 1), 6 steps, a save
    at 3 and at 6."""
    model = _small_cfg(True)
    del model["kwargs"]["text_encode"]["vocab_size"]  # the tokenizer's ids
    return {"model": model,
            "grad_clip": {"type": "logit_scale_param_value", "value": 3, "max_value": 6},
            "t_decay": {"org_t": 2.0, "sd_T_decay_iter": 2, "sd_T_decay_w": 0.5,
                        "sd_T_min": 0.5},
            "optimizer": {"type": "AdamW", "kwargs": {"weight_decay": 0.1}},
            "lr_scheduler": {"type": "Cosine", "kwargs": {
                "base_lr": 5e-4, "warmup_lr": 5e-3, "min_lr": 0.0, "warmup_steps": 2,
                "max_iter": 6}},
            "data": {"train": train or {"synthetic": True, "batch_size": 8, "num_batches": 6}},
            "saver": {"print_freq": 1, "save_freq": 3},
            "reset": {"enable": True, "reset_steps": 2, "reset_nums": 3, "smooth_steps": 1}}


def _solver_run(tmp_path, name, train=None, contexts=None, config=None, **kw):
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    s = Solver(Config(config or _solver_cfg(train)), output_path=str(tmp_path / name), **kw)
    losses, step_fn = {}, s.train_step

    def spy(state, batch, temperature):
        if contexts is not None:
            contexts.append(batch["tokens"].shape[1])
        m = step_fn(state, batch, temperature)
        losses[state.step] = m["loss"]
        return m

    s.train_step = spy
    before = _counts()
    s.train()
    torch.cuda.synchronize()
    return s, {k: v.item() for k, v in losses.items()}, _deltas(before)


def test_solver_kernels_and_resume(dev, tmp_path):
    """``Solver.train()`` on the card with no device named: 6 steps launch
    K2-fwd/bwd 4 times a step (2 layers x 2 towers) and K1-fwd, dq and dsd
    twice, with no plain route; a fresh Solver resumed from ``ckpt_3`` gives
    the straight run's losses of steps 4-6 and its final parameters bit for
    bit (no kernel on the path sums with float atomics)."""
    a, losses_a, counts = _solver_run(tmp_path, "a")
    assert a.device.type == "cuda"
    assert counts == _moved(tiny_attention_fwd=24, tiny_attention_bwd=24, codebook_pool_fwd=12,
                            codebook_pool_bwd_dq=12, codebook_pool_bwd_dsd=12)
    assert sorted(losses_a) == [1, 2, 3, 4, 5, 6]
    assert all(torch.isfinite(torch.tensor(v)) for v in losses_a.values())
    ckpt_3 = a.save_path + "/ckpt_3.pth.tar"
    b, losses_b, counts_b = _solver_run(tmp_path, "b", ckpt_path=ckpt_3)
    assert counts_b == _moved(tiny_attention_fwd=12, tiny_attention_bwd=12, codebook_pool_fwd=6,
                              codebook_pool_bwd_dq=6, codebook_pool_bwd_dsd=6)
    assert losses_b == {s: losses_a[s] for s in (4, 5, 6)}
    for n, p in b.params.items():
        assert torch.equal(p, a.params[n]), n


# -- the data pipeline's device half ----------------------------------------------
def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8),
             "tokens": rng.integers(0, 49408, (16, 20)).astype(np.int32),
             "pad_mask": np.where(rng.random((16, 20)) < 0.5, 0.0, -np.inf).astype(np.float32)}
            for _ in range(n)]


def test_prefetch_to_device_pinned_copies(dev):
    """``prefetch_to_device`` on the card gives each batch equal to a
    blocking copy of its arrays (the uint8 image normalized on the card), and
    a batch the consumer holds stays intact while the producer stages the
    next ones and the allocator is busy."""
    from iterated_learning_for_vlm_tpu_torch.data.pipeline import (
        normalize_device_batch, prefetch_to_device,
    )

    host = _host_batches(6)
    held = []
    for i, got in enumerate(prefetch_to_device(iter(host), dev, size=2)):
        want = normalize_device_batch({k: torch.from_numpy(v).to(dev) for k, v in host[i].items()})
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cuda" and got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), (i, k)
        held.append((i, got))
        torch.randn(1 << 22, device=dev)  # churn the caching allocator
    torch.cuda.synchronize()
    for i, got in held:
        want = normalize_device_batch({k: torch.from_numpy(v).to(dev) for k, v in host[i].items()})
        assert all(torch.equal(got[k], want[k]) for k in want), i


def test_device_normalize_within_one_ulp_of_host(dev):
    """The uint8 wire normalized on the card against the host float path
    (``x * _NORM_SCALE + _NORM_OFFSET`` in numpy fp32): within one fp32 ulp."""
    from iterated_learning_for_vlm_tpu_torch.data.augment import _NORM_OFFSET, _NORM_SCALE
    from iterated_learning_for_vlm_tpu_torch.data.pipeline import normalize_device_batch

    x = np.arange(256, dtype=np.uint8).repeat(3).reshape(1, 16, 16, 3)
    host = x.astype(np.float32) * _NORM_SCALE + _NORM_OFFSET
    got = normalize_device_batch({"image": torch.from_numpy(x).to(dev)})["image"].cpu().numpy()
    assert got.dtype == np.float32
    assert np.all(np.abs(got - host) <= np.spacing(np.abs(host)))


def test_solver_from_shards_kernels_and_resume(dev, tmp_path):
    """The two-layer CLIP-FDT ``Solver`` on the card over 32-px JPEG shards
    (MOCOV2_single, the uint8 wire, context buckets [12, 20]): 6 steps with a
    save at 3 launch K2-fwd/bwd 4 times a step and K1-fwd, dq and dsd twice,
    with no plain route, at both contexts; a fresh Solver resumed from
    ``ckpt_3`` gives steps 4-6's losses and the final parameters bit for bit."""
    from iterated_learning_for_vlm_tpu_torch.tools.make_train_shards import write_shards

    write_shards(str(tmp_path / "shards"), 3, 24, image_size=32, num_classes=16,
                 caption_fn=lambda k, c: c + " " + c if k % 7 == 3 else c)
    train = {"data_path": str(tmp_path / "shards" / "{00000..00002}.tar"), "batch_size": 8,
             "num_samples": 72, "workers": 2, "transforms": "MOCOV2_single",
             "context_buckets": [12, 20]}
    contexts = []
    a, losses_a, counts = _solver_run(tmp_path, "a", train, contexts)
    assert counts == _moved(tiny_attention_fwd=24, tiny_attention_bwd=24, codebook_pool_fwd=12,
                            codebook_pool_bwd_dq=12, codebook_pool_bwd_dsd=12)
    assert sorted(losses_a) == [1, 2, 3, 4, 5, 6] and set(contexts) == {12, 20}, contexts
    assert all(np.isfinite(v) for v in losses_a.values())
    b, losses_b, counts_b = _solver_run(tmp_path, "b", train, ckpt_path=a.save_path
                                        + "/ckpt_3.pth.tar")
    assert counts_b == _moved(tiny_attention_fwd=12, tiny_attention_bwd=12, codebook_pool_fwd=6,
                              codebook_pool_bwd_dq=6, codebook_pool_bwd_dsd=6)
    assert losses_b == {s: losses_a[s] for s in (4, 5, 6)}
    for n, p in b.params.items():
        assert torch.equal(p, a.params[n]), n


# -- the evaluation suite ----------------------------------------------------------
def _eval_setup(tmp_path, dev):
    """The two-layer bf16 CLIP-FDT of ``_solver_cfg`` as a YAML config, a
    checkpoint of it written by ``save_checkpoint``, and SugarCREPE probes
    from the port's ``make_compositional_data.py`` (5 splits x 6 items)."""
    import yaml

    from iterated_learning_for_vlm_tpu_torch.tools import make_compositional_data
    from iterated_learning_for_vlm_tpu_torch.train.checkpoint import save_checkpoint
    from iterated_learning_for_vlm_tpu_torch.train.optim import adamw_init, trainable_mask_tree
    from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState

    model_cfg = _solver_cfg()["model"]
    config = tmp_path / "model.yaml"
    config.write_text(yaml.safe_dump({"model": model_cfg}))
    model = model_entry(model_cfg, device=dev, generator=_gen(5))
    params = dict(model.named_parameters())
    state = TrainState.create(params, adamw_init(params), trainable_mask_tree(params),
                              params["space_dict"])
    ckpt = save_checkpoint(str(tmp_path / "ckpts"), model, state, 7)
    make_compositional_data.main([str(tmp_path / "comp"), "--shards", "0", "--eval-per-split",
                                  "6", "--image-size", "48"])
    return str(config), ckpt, str(tmp_path / "comp" / "eval")


def test_eval_cli_on_the_card(dev, tmp_path, monkeypatch):
    """``eval.cli.main`` with no device named runs on the card: zero-shot on
    the dummy set and SugarCREPE launch K2-fwd twice (2 layers) and K1-fwd
    once for each encoder batch, nothing else, and take no plain route."""
    from iterated_learning_for_vlm_tpu_torch.eval import cli
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder

    config, ckpt, sc = _eval_setup(tmp_path, dev)
    batches = []
    for name in ("image_batch", "text_batch"):
        def counted(self, *a, _orig=getattr(TorchEncoder, name), **k):
            batches.append(self.device.type)
            return _orig(self, *a, **k)
        monkeypatch.setattr(TorchEncoder, name, counted)
    common = ["--model_config", config, "--pretrained", ckpt, "--batch_size", "8"]
    before = _counts()
    zs = cli.main(["eval", "--dataset", "dummy"] + common)
    sugar = cli.main(["sugar_crepe", "--data_root", sc, "--image_root", sc + "/images"] + common)
    torch.cuda.synchronize()
    n = len(batches)
    assert set(batches) == {"cuda"} and n == (1 + 2) + 5 * (1 + 2 * 1)
    assert _deltas(before) == _moved(tiny_attention_fwd=2 * n, codebook_pool_fwd=n)
    assert 0.0 <= zs["metrics"]["acc1"] <= 1.0
    assert len(sugar["metrics"]) == 6
    assert all(0.0 <= v <= 1.0 for v in sugar["metrics"].values())


def test_train_head_on_the_card_matches_cpu(dev):
    """The linear-probe head trained on the card (fp32, TF32 off) against
    the same on the CPU: weights within 1e-4."""
    from iterated_learning_for_vlm_tpu_torch.eval.linear_probe import _train_head

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((300, 64)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    labels = rng.integers(0, 10, 300)
    torch.backends.cuda.matmul.allow_tf32 = True  # the head turns it off for itself
    try:
        w, b = _train_head(feats, labels, 10, weight_decay=1e-4, device=dev)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    w_cpu, b_cpu = _train_head(feats, labels, 10, weight_decay=1e-4)
    np.testing.assert_allclose(w, w_cpu, atol=1e-4, rtol=0)
    np.testing.assert_allclose(b, b_cpu, atol=1e-4, rtol=0)
    assert np.abs(w_cpu).max() > 0.1


def test_eval_hook_leaves_training_bit_for_bit(dev, tmp_path, monkeypatch):
    """The card's Solver with the SugarCREPE hook every 2 steps trains bit
    for bit as without it (losses and final parameters), is back in train
    mode after each hook, and ``imagenet_evaluate`` changes no parameter."""
    from iterated_learning_for_vlm_tpu_torch.tools import make_eval_set
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver

    _, _, sc = _eval_setup(tmp_path, dev)
    make_eval_set.main([str(tmp_path / "zs"), "--num-classes", "4", "--per-class", "2",
                        "--image-size", "48"])
    a, losses_a, _ = _solver_run(tmp_path, "a")
    modes, evaluate = [], Solver.evaluate

    def spy(self, step):
        out = evaluate(self, step)
        modes.append((step, self.model.training, out is not None))
        return out

    monkeypatch.setattr(Solver, "evaluate", spy)
    config = _solver_cfg()
    config["saver"]["val_freq"] = 2
    config["data"]["test"] = {"sc_data_root": sc, "sc_image_root": sc + "/images",
                              "imagenet_root": str(tmp_path / "zs")}
    b, losses_b, _ = _solver_run(tmp_path, "b", config=config)
    assert modes == [(2, True, True), (4, True, True), (6, True, True)]
    assert losses_b == losses_a
    for n, p in b.params.items():
        assert torch.equal(p, a.params[n]), n
    before = {n: p.detach().clone() for n, p in b.params.items()}
    assert b.imagenet_evaluate(6) is not None and b.model.training
    assert all(torch.equal(p, before[n]) for n, p in b.params.items())


# -- clip_fdt_vitb16, attention maps and the HF adapter on the card -------------------
def _b16_cfg(kernels):
    """A narrow bf16 ``clip_fdt_vitb16`` (two layers a tower, head width 64)
    at the full 224-px grid: T = 196 codebook tokens and S = 197 in the image
    tower. ``kernels``: the smoke's routing, the tower-wide ``fused_attn``
    with ``image_encode: {use_flash: true}`` and K1 in both heads."""
    return {"type": "clip_fdt_vitb16", "kwargs": {
        "image_encode": {"width": 128, "layers": 2, "heads": 2, "embed_dim": 64,
                         "use_flash": kernels},
        "text_encode": {"context_length": 20, "vocab_size": 300, "width": 128, "heads": 2,
                        "layers": 2, "embed_dim": 64},
        "fdt": {"sd_num": 256, "sd_dim": 64, "raw_img_ft_dim": 128, "raw_txt_ft_dim": 128,
                "sparsemax_method": "bisect", "use_fused_kernel": kernels,
                "sd_temperature": 2.0},
        "fused_attn": kernels, "dtype": "bfloat16"}}


def test_clip_fdt_vitb16_kernel_routes_match_plain(dev):
    """The kernel routes (K3 at S=197 in the image tower, K2 in the text
    tower, K1 at T=196 and the text T) against the plain routes from the same
    weights: embeddings at cosine >= 0.999, every gradient at >= 0.98, the
    bf16 bound of the full-size steps (at S=197 the positional embedding's
    gradient, a sum over 197 tokens of 5 samples, lay at 0.9896 on the
    H100); launches of one forward and backward: K2 2 / 2, K1 2 / 2 / 2,
    K3 2 / 2, and no plain route."""
    fast = model_entry(_b16_cfg(True), device=dev, generator=_gen(0))
    plain = model_entry(_b16_cfg(False), device=dev, generator=_gen(1))
    plain.load_state_dict(fast.state_dict())
    _, _, (_, tokens, pad) = _small_pair(dev)
    images = torch.randn(5, 224, 224, 3, generator=_gen(3), device=dev)
    before = _counts()
    got = _grads_of(fast, (images, tokens, pad))
    torch.cuda.synchronize()
    assert _deltas(before) == _moved(tiny_attention_fwd=2, tiny_attention_bwd=2,
                                     codebook_pool_fwd=2, codebook_pool_bwd_dq=2,
                                     codebook_pool_bwd_dsd=2, flash_attention_fwd=2,
                                     flash_attention_bwd=2)
    _assert_paths_agree(got, _grads_of(plain, (images, tokens, pad)), min_grad_cos=0.98)


def test_return_attn_on_the_card(dev):
    """``return_attn`` on the bf16 towers of a kernel-route CLIP-FDT B/16 and
    a CLIP B/32 on the K2 route: the plain path, so nothing is launched and
    no plain route is counted; fp32 rows summing to 1 within 1e-3; the
    embeddings at cosine >= 0.999 from the kernel route's."""
    clip_cfg = {"type": "clip_vitb32_auxilary", "kwargs": {
        "image_encode": {"input_resolution": 64, "width": 128, "layers": 2, "heads": 2,
                         "embed_dim": 64},
        "text_encode": {"context_length": 20, "vocab_size": 300, "width": 128, "heads": 2,
                        "layers": 2, "embed_dim": 64},
        "fused_attn": True, "dtype": "bfloat16"}}
    _, _, (_, tokens, pad) = _small_pair(dev)
    for cfg, res in ((_b16_cfg(True), 224), (clip_cfg, 64)):
        model = model_entry(cfg, device=dev, generator=_gen(0)).eval()
        images = torch.randn(3, res, res, 3, generator=_gen(4), device=dev)
        with torch.no_grad():
            ref_v, ref_t = model.visual(images), model.encode_text(tokens, pad)
            before = _counts()
            vis = model.visual(images, return_attn=True)
            txt = model.encode_text(tokens, pad, return_attn=True)
            torch.cuda.synchronize()
            assert _deltas(before) == {}
        s = (res // (16 if res == 224 else 32)) ** 2 + 1
        assert vis["attn_weights"].shape == (2, 3, s, s) and vis["cls_attn"].shape == (2, 3, s)
        assert txt["attn_weights"].shape == (2, 5, 20, 20)
        for w in (vis["attn_weights"], txt["attn_weights"]):
            assert w.dtype == torch.float32
            assert (w.sum(-1) - 1).abs().max().item() <= 1e-3
        for a, b in ((ref_v["embed"], vis["embed"]), (ref_t["embed"], txt["embed"])):
            cos = torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1)
            assert cos.min().item() >= 0.999


def test_hf_adapter_on_the_card(dev, tmp_path):
    """``--model_type ja_clip`` on the card: the adapter's model lives there,
    its embeddings match the CPU adapter's within 1e-4 (fp32, TF32 off), and
    ``eval.cli.main`` with no device named scores through it."""
    pytest.importorskip("transformers")
    from PIL import Image
    from transformers import (
        BertConfig, BertTokenizer, CLIPImageProcessor, CLIPVisionConfig,
        VisionTextDualEncoderConfig, VisionTextDualEncoderModel,
    )

    from iterated_learning_for_vlm_tpu_torch.eval import cli
    from iterated_learning_for_vlm_tpu_torch.eval.hf_adapter import HFClipEncoder

    torch.manual_seed(0)
    d = str(tmp_path / "hf")
    vision = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                              num_attention_heads=2, image_size=32, patch_size=16)
    text = BertConfig(vocab_size=32, hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)
    VisionTextDualEncoderModel(VisionTextDualEncoderConfig.from_vision_text_configs(
        vision, text, projection_dim=16)).save_pretrained(d)
    with open(f"{d}/vocab.txt", "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "dog",
                           "photo", "of", "the", "##s"]))
    BertTokenizer(f"{d}/vocab.txt").save_pretrained(d)
    CLIPImageProcessor(size={"shortest_edge": 32},
                       crop_size={"height": 32, "width": 32}).save_pretrained(d)
    card, host = HFClipEncoder(d, batch_size=2), HFClipEncoder(d, batch_size=2, device="cpu")
    assert card.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in card.model.parameters())
    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
              for _ in range(3)]
    texts = ["a photo of a cat", "a dog", "cats"]
    np.testing.assert_allclose(card.encode_images(images), host.encode_images(images),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(card.encode_texts(texts), host.encode_texts(texts),
                               atol=1e-4, rtol=0)
    rec = cli.main(["eval", "--model_type", "ja_clip", "--pretrained", d, "--dataset", "dummy",
                    "--batch_size", "4", "--quiet"])
    assert 0.0 <= rec["metrics"]["acc1"] <= 1.0


# -- data parallel: two ranks sharing the card over Gloo ---------------------------
def _gloo_rank(rank, port, conn, embeds, batch, config, out):
    """Rank ``rank`` of a two-rank Gloo group on ``cuda:0`` (NCCL refuses two
    ranks on one card): the sharded InfoNCE of its half of ``embeds``, then
    one Solver step through DDP on its half of ``batch``."""
    import os
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    from iterated_learning_for_vlm_tpu_torch.parallel import mesh
    from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce_sharded
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    try:
        mesh.init_data_parallel("gloo", timeout=timedelta(seconds=120))
        dev = torch.device("cuda", 0)
        img, txt = (torch.from_numpy(x[rank * 8:(rank + 1) * 8]).to(dev).requires_grad_()
                    for x in embeds)
        loss, metrics = clip_info_nce_sharded(img, txt, torch.tensor(10.0, device=dev))
        loss.backward()
        res = {"loss": metrics["loss"].item(), "grads": (img.grad.cpu().numpy(),
                                                         txt.grad.cpu().numpy())}
        s = Solver(Config(config), output_path=out, exp_name="gloo", device=dev)
        mine = {k: torch.from_numpy(v[rank * 8:(rank + 1) * 8]).to(dev) for k, v in batch.items()}
        before = _counts()
        metrics = s.train_step(s.state, mine, 2.0)
        torch.cuda.synchronize()
        res["step"] = {"loss": metrics["loss"].item(), "counts": _deltas(before),
                       "wrapped": type(s.train_model).__name__,
                       "params": {n: p.detach().float().cpu().numpy() for n, p in s.params.items()},
                       "grads": {n: None if p.grad is None else p.grad.float().cpu().numpy()
                                 for n, p in s.params.items()}}
        for _ in range(2):  # a Gloo group's steps stay eager
            s.train_step(s.state, mine, 2.0)
        g = s.train_step.graphs
        res["step"]["graphs"] = (g.eager, g.captures, g.replays)
        conn.send(("ok", res))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test, which fails
        conn.send(("error", traceback.format_exc()))


def test_ddp_on_one_card_over_gloo(dev, tmp_path):
    """Two ranks share ``cuda:0`` over Gloo (CUDA tensors staged through the
    host). The sharded InfoNCE of fp32 embeddings: the mean loss within 1e-6
    of the one-process loss of the global batch, and each rank's gradient
    twice (W times) the global-mean gradient of its rows within 1e-6. One
    Solver step of the two-layer bf16 CLIP-FDT through DDP, each rank on half
    of a fixed batch of 16: both ranks launch K2-fwd/bwd 4 times and K1-fwd,
    dq and dsd twice with no plain route, end bit for bit equal, and their
    loss is within 2e-3 relative and every averaged gradient at cosine >=
    0.98 (the bf16 bound) of one process's step on all 16. Gloo stages the
    collectives through the host, which no CUDA graph holds: that step and
    two more all run eagerly."""
    import multiprocessing
    import socket

    from iterated_learning_for_vlm_tpu_torch.data.synthetic import SyntheticClipData
    from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    embeds = [rng.standard_normal((16, 32)).astype(np.float32) for _ in range(2)]
    embeds = [e / np.linalg.norm(e, axis=-1, keepdims=True) for e in embeds]
    batch = SyntheticClipData(batch_size=16, image_size=64, context_length=20).batch(0)
    config = _solver_cfg({"synthetic": True, "batch_size": 8, "num_batches": 6})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    conns, procs = [], []
    for rank in range(2):
        ours, theirs = ctx.Pipe()
        procs.append(ctx.Process(target=_gloo_rank, args=(rank, port, theirs, embeds, batch,
                                                          config, str(tmp_path / "ranks"))))
        procs[-1].start()
        conns.append(ours)
    got = []
    try:
        for conn in conns:
            assert conn.poll(300), "a rank did not answer within 300 s"
            status, value = conn.recv()
            assert status == "ok", value
            got.append(value)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    # the sharded loss against the global loss of one process
    img, txt = (torch.from_numpy(e).to(dev).requires_grad_() for e in embeds)
    loss, _ = clip_info_nce(img, txt, torch.tensor(10.0, device=dev))
    loss.backward()
    for rank, r in enumerate(got):
        assert abs(r["loss"] - loss.item()) <= 1e-6
        for g, ref in zip(r["grads"], (img.grad, txt.grad)):
            np.testing.assert_allclose(g / 2, ref[rank * 8:(rank + 1) * 8].cpu().numpy(),
                                       atol=1e-6, rtol=0)
    # one DDP step against one process's step on the whole batch
    a, b = got[0]["step"], got[1]["step"]
    assert a["wrapped"] == b["wrapped"] == "DistributedDataParallel"
    assert a["counts"] == b["counts"] == _moved(tiny_attention_fwd=4, tiny_attention_bwd=4,
                                                codebook_pool_fwd=2, codebook_pool_bwd_dq=2,
                                                codebook_pool_bwd_dsd=2)
    assert a["graphs"] == b["graphs"] == (3, 0, 0)
    assert a["loss"] == b["loss"]
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n], err_msg=n)
    one = Solver(Config(_solver_cfg({"synthetic": True, "batch_size": 16, "num_batches": 6})),
                 output_path=str(tmp_path / "one"), exp_name="one", device=dev)
    want = one.train_step(one.state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                          2.0)
    assert abs(a["loss"] - want["loss"].item()) <= 2e-3 * abs(want["loss"].item())
    for n, p in one.params.items():
        ga = a["grads"][n]
        assert (ga is None) == (p.grad is None), n
        if ga is not None:
            cos = torch.nn.functional.cosine_similarity(
                torch.from_numpy(ga).flatten(), p.grad.float().cpu().flatten(), dim=0).item()
            assert cos >= 0.98, (n, cos)


# -- the eval encoder's text call as a CUDA graph ----------------------------

# a prompt's length for each text bucket of a 77-token context
GRAPH_LENGTHS = {16: (4, 16), 32: (17, 32), 77: (33, 77)}


def _graph_model(dev, kind):
    """The small bf16 CLIP-FDT of ``_small_cfg`` (K2, K1 and the bisection
    sparsemax) or a CLIP of the same towers on K2, with a 77-token context
    so that every bucket (16, 32, 77) exists."""
    cfg = _small_cfg(True)
    cfg["kwargs"]["text_encode"]["context_length"] = 77
    if kind == "clip":
        cfg = {"type": "clip_vitb32",
               "kwargs": {k: v for k, v in cfg["kwargs"].items() if k != "fdt"}}
    return model_entry(cfg, device=dev, generator=_gen(3))


def _graph_prompts(seed, rows, ctx):
    """Host token ids and pad mask ``[rows, 77]`` whose lengths pick bucket
    ``ctx``; the EOT (id 299, the highest) ends each prompt."""
    rng = np.random.default_rng(seed)
    lo, hi = GRAPH_LENGTHS[ctx]
    lengths = rng.integers(lo, hi + 1, rows)
    lengths[0] = hi
    tokens = rng.integers(1, 299, (rows, 77))
    pad = np.zeros((rows, 77), np.float32)
    for i, n in enumerate(lengths):
        tokens[i, n - 1], tokens[i, n:], pad[i, n:] = 299, 0, -np.inf
    return tokens, pad


def _eager_texts(model, tokens, pad, normalize=True, temperature=None):
    """The same call on a fresh encoder: its first call of a key runs eager."""
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder

    enc = TorchEncoder(model, batch_size=8, normalize=normalize, sd_temperature=temperature)
    out = enc.encode_texts_tokens(tokens, pad)
    assert (enc.text_graphs.eager, enc.text_graphs.captures) == (1, 0)
    return out


@pytest.mark.parametrize("kind", ["fdt", "clip"])
@pytest.mark.parametrize("ctx", [16, 32, 77])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("rows", [8, 5])
def test_text_graph_replay_is_the_eager_call(dev, kind, ctx, normalize, rows):
    """Four calls of one key (a full batch of 8, or 5 rows padded to 8), each
    with other prompts: eager, capture, replay, replay, each bit for bit the
    eager call of a fresh encoder. The counters read 1 / 1 / 2, and K2-fwd
    and K1-fwd launched as four eager calls launch."""
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder

    model = _graph_model(dev, kind)
    enc = TorchEncoder(model, batch_size=8, normalize=normalize)
    calls = [_graph_prompts(seed, rows, ctx) for seed in range(4)]
    before = _counts()
    got = [enc.encode_texts_tokens(tokens, pad) for tokens, pad in calls]
    torch.cuda.synchronize()
    launched = _deltas(before)
    assert _graph_counts(enc.text_graphs) == (1, 1, 2)
    assert launched == _moved(tiny_attention_fwd=4 * 2, codebook_pool_fwd=4 * (kind == "fdt"))
    for (tokens, pad), out in zip(calls, got):
        assert out.shape == (rows, 64)
        assert np.array_equal(out, _eager_texts(model, tokens, pad, normalize))


@pytest.mark.parametrize("change", ["temperature", "param_replaced", "param_in_place"])
def test_text_graph_follows_the_weights(dev, change):
    """After a capture, a new temperature or a parameter replaced by a new
    tensor starts a new key (eager, then a new capture); a parameter updated
    in place is read by the next replay. Every result follows the new values,
    bit for bit a fresh encoder's eager call."""
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder

    model = _graph_model(dev, "fdt")
    enc = TorchEncoder(model, batch_size=8)
    tokens, pad = _graph_prompts(0, 8, 16)
    old = [enc.encode_texts_tokens(tokens, pad) for _ in range(3)]
    weight = model.txt_query_model.q_map[4].weight
    with torch.no_grad():
        if change == "temperature":
            enc.sd_temperature = 0.5
        elif change == "param_replaced":
            weight.data = weight.data * 2.0
        else:
            weight.mul_(2.0)
    new = [enc.encode_texts_tokens(tokens, pad) for _ in range(3)]
    want_counts = (1, 1, 4) if change == "param_in_place" else (2, 2, 2)
    assert _graph_counts(enc.text_graphs) == want_counts
    want = _eager_texts(model, tokens, pad, temperature=enc.sd_temperature)
    assert not np.array_equal(want, old[0])
    for out in new:
        assert np.array_equal(out, want)


def test_text_graph_result_outlives_the_next_call(dev):
    """``text_batch`` returns a tensor of its own: a replay's result is not
    overwritten by the next replay."""
    from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder

    enc = TorchEncoder(_graph_model(dev, "fdt"), batch_size=8)
    a, b = (tuple(torch.from_numpy(x[:, :16]).to(dev) for x in _graph_prompts(s, 8, 16))
            for s in (0, 1))
    for _ in range(2):
        enc.text_batch(*a)
    first = enc.text_batch(*a)
    kept = first.clone()
    second = enc.text_batch(*b)
    torch.cuda.synchronize()
    assert enc.text_graphs.replays == 2
    assert torch.equal(first, kept) and not torch.equal(first, second)


# -- K4: Swin window attention ---------------------------------------------------------------
# K4-fwd and K4-bwd round at the same places as their plain versions (p and ds
# to bf16 before the products, fp32 sums taken in another order, one rounding
# of each output): as K2's.
WIN_ATOL, WIN_RTOL = 2e-2, 1e-2
# The bias gradient sums W fp32 ds values per entry in another order (blocks'
# strided window sets, then the partials): relative to the gradient's norm,
# fp32 noise grows as sqrt(W) ulps.
WIN_DBIAS_RTOL = 1e-4

# (images, ws, heads, shifted): N = 144 at stages 0-2 (masked at 0 and 1),
# N = 36 at stage 3, head width 32; and N = 16, 100 for the padding edges
K4_SHAPES = [(2, 12, 4, True), (2, 12, 4, False), (3, 12, 16, False), (4, 6, 32, False),
             (2, 6, 8, True), (2, 4, 2, True), (2, 10, 4, True)]


def _window_inputs(dev, images, ws, heads, shifted, seed):
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    hw = 4 * ws if shifted else 2 * ws
    nw = (hw // ws) ** 2
    n, c = ws * ws, 32 * heads
    g = _gen(seed)
    qkv = torch.randn(images * nw, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, heads, generator=g, device=dev)
    index = torch.from_numpy(wa.relative_position_index(ws)).to(dev)
    rel = wa.RelativePositionBias.apply(table, index, ws)
    mask = torch.from_numpy(wa.shift_mask(hw, ws, ws // 2)).to(dev) if shifted else None
    return qkv, rel, mask, wa.combined_bias(rel, mask), g


@pytest.mark.parametrize("images,ws,heads,shifted", K4_SHAPES)
def test_window_attention_kernel_matches_plain(dev, images, ws, heads, shifted):
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    qkv, _, _, bias, _ = _window_inputs(dev, images, ws, heads, shifted, ws * 10 + heads)
    before = wa.window_attention_fwd.launches
    got = wa.window_attention_fwd(qkv, bias, heads)
    torch.cuda.synchronize()
    assert wa.window_attention_fwd.launches == before + 1
    ref = wa.window_attention_reference(qkv, bias, heads)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    assert torch.all(err <= WIN_ATOL + WIN_RTOL * ref.float().abs()), err.max().item()


@pytest.mark.parametrize("images,ws,heads,shifted", K4_SHAPES)
def test_window_attention_bwd_kernel_matches_plain(dev, images, ws, heads, shifted):
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    qkv, _, _, bias, g = _window_inputs(dev, images, ws, heads, shifted, ws * 10 + heads + 1)
    dout = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, generator=g,
                       device=dev).to(torch.bfloat16)
    before = wa.window_attention_bwd.launches
    dqkv, dbias = wa.window_attention_bwd(qkv, bias, heads, dout)
    torch.cuda.synchronize()
    assert wa.window_attention_bwd.launches == before + 1
    ref_dqkv, ref_dbias = wa.window_attention_bwd_reference(qkv, bias, heads, dout)
    err = (dqkv.float() - ref_dqkv.float()).abs()
    assert torch.all(err <= WIN_ATOL + WIN_RTOL * ref_dqkv.float().abs()), err.max().item()
    assert dbias.dtype == torch.float32 and dbias.shape == ref_dbias.shape
    gap = (dbias - ref_dbias).norm() / ref_dbias.norm()
    assert gap <= WIN_DBIAS_RTOL, gap.item()
    # no float atomics: a second call gives the same bits
    again = wa.window_attention_bwd(qkv, bias, heads, dout)
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])


def test_window_attention_function_and_table_grad(dev):
    """Autograd through K4 on the card: dqkv and the bias table's gradient
    against autograd through the plain forward (fp32 table, bf16 qkv)."""
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    ws, heads = 12, 4
    qkv, _, mask, _, g = _window_inputs(dev, 2, ws, heads, True, 77)
    table = (0.5 * torch.randn((2 * ws - 1) ** 2, heads, generator=g, device=dev))
    index = torch.from_numpy(wa.relative_position_index(ws)).to(dev)
    dout = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, generator=g,
                       device=dev).to(torch.bfloat16)
    grads = []
    for kernel in (True, False):
        x = qkv.clone().requires_grad_()
        t = table.clone().requires_grad_()
        rel = wa.RelativePositionBias.apply(t, index, ws)
        if kernel:
            out = wa.WindowAttentionFn.apply(x, rel, mask, heads)
        else:
            out = wa.window_attention_reference(x, wa.combined_bias(rel, mask), heads)
        out.backward(dout)
        grads.append((x.grad.float(), t.grad))
    (dx, dt), (rx, rt) = grads
    assert torch.all((dx - rx).abs() <= WIN_ATOL + WIN_RTOL * rx.abs())
    # autograd's plain backward rounds at other places (no ds rounding): 1%
    assert (dt - rt).norm() / rt.norm() <= 1e-2


def test_swin_tower_takes_k4_on_the_card(dev):
    """A bf16 two-stage Swin-MoE tower on the card: every window attention
    call launches K4 forward and backward, and the MoE counters add up; a
    float32 tower raises in K4 rather than take a plain route."""
    from iterated_learning_for_vlm_tpu_torch.models import swin

    cfg = swin.SwinConfig(input_resolution=96, window_size=12, embed_dim=64, depths=(2, 2),
                          num_heads=(2, 4), num_experts=4, moe_blocks=((1,), (1,)))
    tower = layers_model.init_module_tree(
        swin.SwinTransformer(cfg, dtype=torch.bfloat16, device=dev), _gen(3))
    from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa

    fwd, bwd = wa.window_attention_fwd.launches, wa.window_attention_bwd.launches
    x = torch.randn(8, 96, 96, 3, generator=_gen(4), device=dev)
    out = tower(x)
    (out["embed"].float().square().sum() + out["moe_aux"]).backward()
    torch.cuda.synchronize()
    assert wa.window_attention_fwd.launches - fwd == 4
    assert wa.window_attention_bwd.launches - bwd == 4
    routed, kept, slots, largest = (int(v) for v in sum(m.counters for m in tower.moe_layers()))
    assert routed == 8 * (576 + 144) and kept <= min(routed, slots) and largest > 0
    assert tower.layers[0].blocks[0].attn.relative_position_bias_table.grad.abs().sum() > 0
    fp32 = layers_model.init_module_tree(
        swin.SwinTransformer(cfg, dtype=torch.float32, device=dev), _gen(3))
    with pytest.raises(ValueError, match="bfloat16"):
        fp32(x)


# -- the train step as a CUDA graph (train/step.py) --------------------------------------
def _step_model(dev, kind):
    """A small bf16 model whose step runs hand-written kernels: the CLIP-FDT of
    ``_small_cfg`` (K2 and K1), a CLIP of its towers (K2), or a CLIP Swin-MoE
    with a 96-px two-stage tower of head width 32 and 4 experts (K4) and the
    same text tower (K2)."""
    cfg = _small_cfg(True)
    towers = {k: v for k, v in cfg["kwargs"].items() if k != "fdt"}
    if kind == "clip":
        cfg = {"type": "clip_vitb32", "kwargs": towers}
    elif kind == "swinmoe":
        towers["image_encode"] = {"input_resolution": 96, "window_size": 12, "depths": [2, 2],
                                  "num_heads": [4, 8], "num_experts": 4,
                                  "moe_blocks": [[1], [1]], "embed_dim": 64}
        cfg = {"type": "clip_swinMoE_B", "kwargs": towers}
    return model_entry(cfg, device=dev, generator=_gen(5))


def _step_pair(dev, kind):
    """Two copies of one model, each with a fresh TrainState."""
    from iterated_learning_for_vlm_tpu_torch.train import optim
    from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState

    a, b = _step_model(dev, kind), _step_model(dev, kind)
    b.load_state_dict(a.state_dict())
    states = []
    for m in (a, b):
        params = dict(m.named_parameters())
        states.append(TrainState.create(params, optim.adamw_init(params),
                                        optim.trainable_mask_tree(params),
                                        params.get("space_dict")))
    return (a, states[0]), (b, states[1])


def _step_fn(model, kind):
    from iterated_learning_for_vlm_tpu_torch.train import optim
    from iterated_learning_for_vlm_tpu_torch.train.step import make_train_step

    params = dict(model.named_parameters())
    return make_train_step(model, lambda s: 1e-3 * s / (s + 2.0),
                           optim.build_wd_tree(params, 0.1, {}), is_fdt=kind == "fdt",
                           grad_clip_type="logit_scale_param_value", grad_clip_value=3.0,
                           grad_clip_max_value=6.0)


def _step_batches(dev, kind, n):
    res = 96 if kind == "swinmoe" else 64
    g = _gen(7)
    out = []
    for _ in range(n):
        tokens = torch.randint(1, 298, (8, 20), generator=g, device=dev)
        lengths = torch.randint(4, 21, (8, 1), generator=g, device=dev)
        pos = torch.arange(20, device=dev)
        tokens = torch.where(pos == lengths - 1, 299, torch.where(pos < lengths, tokens, 0))
        pad = torch.where(pos < lengths, 0.0, float("-inf")).float()
        out.append({"image": torch.randn(8, res, res, 3, generator=g, device=dev),
                    "tokens": tokens, "pad_mask": pad})
    return out


def _assert_same_state(a, state_a, b, state_b):
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        for k in ("mu", "nu"):
            assert torch.equal(state_a.opt_state[k][n], state_b.opt_state[k][n]), (k, n)
    assert state_a.opt_state["count"] == state_b.opt_state["count"]
    assert (state_a.step, state_a.hold_codebook) == (state_b.step, state_b.hold_codebook)


@pytest.mark.parametrize("kind", ["fdt", "clip", "swinmoe"])
def test_step_graph_replay_is_the_eager_step(dev, kind):
    """Six steps through one step function (eager, capture, four replays) give
    the parameters, moments, counts and metrics of six eager steps from the
    same state, each a fresh step function's first call, bit for bit; the five
    losses of the capture and the replays are five tensors of their own."""
    (a, state_a), (b, state_b) = _step_pair(dev, kind)
    step = _step_fn(a, kind)
    batches = _step_batches(dev, kind, 6)
    got, want = [], []
    for batch in batches:
        got.append(step(state_a, batch, 2.0))
        eager = _step_fn(b, kind)
        want.append(eager(state_b, batch, 2.0))
        assert _graph_counts(eager.graphs) == (1, 0, 0)
    torch.cuda.synchronize()
    assert _graph_counts(step.graphs) == (1, 1, 4)
    for g, w in zip(got, want):
        assert g["lr"] == w["lr"]
        for k in ("loss", "logit_scale", "acc1", "acc5"):
            assert torch.equal(g[k], w[k]), k
    _assert_same_state(a, state_a, b, state_b)
    losses = torch.stack([m["loss"] for m in got[1:]])
    assert len(set(losses.tolist())) == 5, losses


def _il_reset(model, state, step):
    """An IL reset as ``ILController.on_step`` makes it: snapshot and hold the
    codebook, redraw the text tower and zero its moments and counts, freeze
    the vision tower."""
    from iterated_learning_for_vlm_tpu_torch.train import il, optim

    params = dict(model.named_parameters())
    state.stored_codebook = params["space_dict"].detach().clone()
    state.hold_codebook = True
    mask = il.weight_reset_tree(params, optim.TEXT_ROOTS, (1, step, "text"))
    optim.reset_opt_state_for(state.opt_state, mask)
    state.trainable = optim.trainable_mask_tree(params, frozenset({"vision"}))


def _il_release(model, state):
    from iterated_learning_for_vlm_tpu_torch.train import optim

    state.hold_codebook = False
    state.trainable = optim.trainable_mask_tree(dict(model.named_parameters()))


def test_step_graph_recaptures_at_il_events(dev):
    """An IL reset after step 3 (snapshot, hold, text redrawn and its counts
    zeroed, vision frozen) and a release with a new temperature after step 6
    each change the key: every three steps run eager, capture, replay, and
    all nine equal eager steps from the same state bit for bit."""
    (a, state_a), (b, state_b) = _step_pair(dev, "fdt")
    step = _step_fn(a, "fdt")
    for k, batch in enumerate(_step_batches(dev, "fdt", 9)):
        temperature = 2.0 if k < 6 else 1.0
        got = step(state_a, batch, temperature)
        want = _step_fn(b, "fdt")(state_b, batch, temperature)
        assert torch.equal(got["loss"], want["loss"]), k
        if k == 2:
            _il_reset(a, state_a, 3)
            _il_reset(b, state_b, 3)
        if k == 5:
            _il_release(a, state_a)
            _il_release(b, state_b)
    torch.cuda.synchronize()
    assert _graph_counts(step.graphs) == (3, 3, 3)
    _assert_same_state(a, state_a, b, state_b)


def test_step_graph_two_steps_share_a_pool(dev):
    """Two models' step functions in one process, their calls interleaved
    (each eager, capture, four replays), capture on one side stream into
    one memory pool: each model's six steps equal six eager steps from the
    same state bit for bit, though each replay overwrites what the other
    graph left in the pool."""
    assert graphs._side(dev) is graphs._side(dev)
    (a, state_a), (a2, state_a2) = _step_pair(dev, "fdt")
    (b, state_b), (b2, state_b2) = _step_pair(dev, "clip")
    step_a, step_b = _step_fn(a, "fdt"), _step_fn(b, "clip")
    for batch_a, batch_b in zip(_step_batches(dev, "fdt", 6), _step_batches(dev, "clip", 6)):
        got_a, got_b = step_a(state_a, batch_a, 2.0), step_b(state_b, batch_b, 2.0)
        want_a = _step_fn(a2, "fdt")(state_a2, batch_a, 2.0)
        want_b = _step_fn(b2, "clip")(state_b2, batch_b, 2.0)
        assert torch.equal(got_a["loss"], want_a["loss"])
        assert torch.equal(got_b["loss"], want_b["loss"])
    torch.cuda.synchronize()
    for step in (step_a, step_b):
        assert _graph_counts(step.graphs) == (1, 1, 4)
    gc.collect()  # as a capture does: graphs only a cycle holds leave the live set
    assert len({entry.graph.pool() for entry in graphs._side(dev)[1]}) == 1
    _assert_same_state(a, state_a, a2, state_a2)
    _assert_same_state(b, state_b, b2, state_b2)


def test_step_graph_takes_a_new_pool_when_all_graphs_are_gone(dev):
    """When every graph of the shared pool is gone (its step functions freed),
    the next step's capture takes a new pool instead of the one the
    allocator is freeing, and replays as before."""
    (a, state_a), _ = _step_pair(dev, "clip")
    step = _step_fn(a, "clip")
    for batch in _step_batches(dev, "clip", 3):
        step(state_a, batch, 2.0)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    (b, state_b), (b2, state_b2) = _step_pair(dev, "clip")
    step = _step_fn(b, "clip")
    for batch in _step_batches(dev, "clip", 3):
        got = step(state_b, batch, 2.0)
        want = _step_fn(b2, "clip")(state_b2, batch, 2.0)
        assert torch.equal(got["loss"], want["loss"])
    assert _graph_counts(step.graphs) == (1, 1, 1)
    _assert_same_state(b, state_b, b2, state_b2)


@pytest.mark.parametrize("kind", ["fdt", "swinmoe"])
def test_step_graph_replay_advances_the_counters(dev, kind):
    """Each of four steps (eager, capture, two replays) advances every kernel
    wrapper's ``.launches`` and the routes' counts by the eager step's
    increments: a capture adds what it launches once (at its replay), a
    replay what its capture recorded."""
    (a, state_a), _ = _step_pair(dev, kind)
    step = _step_fn(a, kind)
    deltas = []
    for batch in _step_batches(dev, kind, 4):
        before = _counts()
        step(state_a, batch, 2.0)
        deltas.append(_deltas(before))
    assert _graph_counts(step.graphs) == (1, 1, 2)
    assert all(d == deltas[0] for d in deltas), deltas
    k2 = 4 if kind == "fdt" else 2  # the text tower's in both
    if kind == "fdt":
        want = _moved(tiny_attention_fwd=k2, tiny_attention_bwd=k2, codebook_pool_fwd=2,
                      codebook_pool_bwd_dq=2, codebook_pool_bwd_dsd=2)
    else:
        want = _moved(tiny_attention_fwd=k2, tiny_attention_bwd=k2, window_attention_fwd=4,
                      window_attention_bwd=4)
    assert deltas[0] == want


# -- the DDP step as a CUDA graph: two NCCL ranks, a card each -----------------------
DDP_GRAPH_STEPS = 6


def _ddp_step_fn(wrapper, kind="fdt"):
    """``_step_fn`` for a ``DistributedDataParallel`` wrapper (its module's
    parameter names)."""
    from iterated_learning_for_vlm_tpu_torch.train import optim
    from iterated_learning_for_vlm_tpu_torch.train.step import make_train_step

    params = dict(wrapper.module.named_parameters())
    return make_train_step(wrapper, lambda s: 1e-3 * s / (s + 2.0),
                           optim.build_wd_tree(params, 0.1, {}), is_fdt=kind == "fdt",
                           grad_clip_type="logit_scale_param_value", grad_clip_value=3.0,
                           grad_clip_max_value=6.0)


def _ddp_graph_job(il):
    """On this rank (card ``rank``): two copies of the small CLIP-FDT, each in
    DDP as the Solver wraps it, take the same steps on this rank's batches
    (other rows on each rank): ``a`` through one step function (eager,
    capture, replays), ``b`` each step through a fresh step function, whose
    first call runs eagerly. ``il``: 9 steps, an IL reset after step 3 and a
    release with a new temperature after step 6; else ``DDP_GRAPH_STEPS``
    steps, then one more replay under a CUDA profiler. Every metric, and in
    the end every parameter, gradient, moment and count, must agree bit for
    bit. Returns the graph counts, each step's counter increments, a digest
    of the parameters, the profiled replay's NCCL kernels and the warnings
    of an ``AccumulateGrad`` node on another stream than the backward's."""
    import hashlib
    import warnings

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from iterated_learning_for_vlm_tpu_torch.train.step import wrap_data_parallel

    rank = dist.get_rank()
    dev = torch.device("cuda", rank)
    (a, state_a), (b, state_b) = _step_pair(dev, "fdt")
    step = _ddp_step_fn(wrap_data_parallel(a))
    wrapped_b = wrap_data_parallel(b)
    n = 9 if il else DDP_GRAPH_STEPS
    batches = _step_batches(dev, "fdt", 2 * n)[rank::2]
    deltas = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _ddp_steps(step, wrapped_b, a, state_a, b, state_b, batches, il, deltas)
    torch.cuda.synchronize()
    _assert_same_state(a, state_a, b, state_b)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        assert p.grad is None or torch.equal(p.grad, q.grad), name
    out = {"modes": _graph_counts(step.graphs), "deltas": deltas,
           "stream_warnings": [str(w.message)[:200] for w in caught
                               if "AccumulateGrad" in str(w.message)]}
    if not il:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state_a, batches[-1], 2.0)
            torch.cuda.synchronize()
        out["profiled_mode"] = step.graphs.mode
        out["nccl_kernels"] = sorted({e.key for e in prof.key_averages()
                                      if "nccl" in e.key.lower()})
    h = hashlib.sha256()
    for p in a.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    out["digest"] = h.hexdigest()
    return out


def _ddp_steps(step, wrapped_b, a, state_a, b, state_b, batches, il, deltas):
    """The steps of :func:`_ddp_graph_job`, each held against an eager step."""
    for k, batch in enumerate(batches):
        temperature = 1.0 if il and k >= 6 else 2.0
        before = _counts()
        got = step(state_a, batch, temperature)
        deltas.append(_deltas(before))
        eager = _ddp_step_fn(wrapped_b)
        want = eager(state_b, batch, temperature)
        assert _graph_counts(eager.graphs) == (1, 0, 0)
        assert got["lr"] == want["lr"]
        for key in ("loss", "logit_scale", "acc1", "acc5"):
            assert torch.equal(got[key], want[key]), (k, key)
        if il and k == 2:
            _il_reset(a, state_a, 3)
            _il_reset(b, state_b, 3)
        if il and k == 5:
            _il_release(a, state_a)
            _il_release(b, state_b)


_KEPT = []  # what a job leaves alive until its process ends


def _ddp_solver_job(out):
    """``Solver.train()`` of the small CLIP-FDT over the group: 8 steps of one
    key (no IL event, no temperature decay). The Solver stays alive while
    the group is destroyed, as ``cli_entry`` does; returns the step's graph
    counts."""
    import torch.distributed as dist

    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    config = _solver_cfg({"synthetic": True, "batch_size": 8, "num_batches": 8})
    config["lr_scheduler"]["kwargs"]["max_iter"] = 8
    config["reset"]["enable"] = False
    config["saver"]["save_freq"] = 0
    del config["t_decay"]
    # the card by index: the Solver's prefetch thread starts on card 0
    s = Solver(Config(config), output_path=out, exp_name="nccl",
               device=torch.device("cuda", dist.get_rank()))
    s.train()
    _KEPT.append(s)
    return {"modes": _graph_counts(s.step_graphs), "wrapped": type(s.train_model).__name__}


def _nccl_serve(rank, port, conn):
    """Rank ``rank`` of a two-rank NCCL group on cards 0 and 1: runs the jobs
    sent over ``conn`` (``(name, kwargs)`` in, ``("ok", result)`` or
    ``("error", traceback)`` out) until ``None``."""
    import os
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    from iterated_learning_for_vlm_tpu_torch.parallel import mesh

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    try:
        mesh.init_data_parallel("nccl", timeout=timedelta(seconds=120))
    except BaseException:  # noqa: BLE001 — reported to the test, which fails
        conn.send(("error", traceback.format_exc()))
        return
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
            gc.collect()  # what a job left to cycles goes before the group does
    finally:
        dist.destroy_process_group()


def _answers(conns, timeout_s):
    """Each rank's answer to one job, in rank order; fails at the first error
    any rank reports (its peers may be waiting in a collective for it)."""
    import time
    from multiprocessing.connection import wait

    pending, answers = dict(enumerate(conns)), {}
    deadline = time.monotonic() + timeout_s
    while pending:
        ready = wait(list(pending.values()), timeout=max(0.0, deadline - time.monotonic()))
        assert ready, f"ranks {sorted(pending)} did not answer within {timeout_s} s"
        for rank, conn in list(pending.items()):
            if conn in ready:
                status, value = conn.recv()
                assert status == "ok", f"rank {rank}: {value}"
                del pending[rank]
                answers[rank] = value
    return [answers[rank] for rank in range(len(conns))]


@pytest.fixture(scope="module")
def nccl_runs(dev, tmp_path_factory):
    """The two jobs of :func:`_ddp_graph_job`, then :func:`_ddp_solver_job`,
    on a two-rank NCCL group (a card a rank), each rank's result by job;
    ``ended``: each rank's exit code after the group was destroyed (None:
    still running after 120 s)."""
    import multiprocessing
    import socket

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card a rank")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    conns, procs = [], []
    for rank in range(2):
        ours, theirs = ctx.Pipe()
        procs.append(ctx.Process(target=_nccl_serve, args=(rank, port, theirs), daemon=True))
        procs[-1].start()
        theirs.close()
        conns.append(ours)
    runs = {}
    out = str(tmp_path_factory.mktemp("nccl_solver"))
    jobs = {"plain": ("_ddp_graph_job", {"il": False}), "il": ("_ddp_graph_job", {"il": True}),
            "solver": ("_ddp_solver_job", {"out": out})}
    try:
        for job, call in jobs.items():
            for conn in conns:
                conn.send(call)
            runs[job] = _answers(conns, 300)
    finally:
        for conn in conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for proc in procs:
            proc.join(timeout=120)
        runs["ended"] = [proc.exitcode for proc in procs]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    return runs


def test_ddp_step_graph_replay_is_the_eager_step(nccl_runs):
    """Over NCCL the DDP step replays: six steps through one step function
    (eager, capture, four replays), the InfoNCE's all-gathers and the
    gradient all-reduce inside the graph, equal six eager DDP steps from the
    same state bit for bit on each rank (checked on the rank), and the two
    ranks end bit for bit equal. No backward meets an ``AccumulateGrad``
    node that DDP made on another stream (which voids a capture where NCCL
    runs a blocking stream of its own)."""
    for job in ("plain", "il"):
        assert [r["stream_warnings"] for r in nccl_runs[job]] == [[], []]
    runs = nccl_runs["plain"]
    assert [r["modes"] for r in runs] == [(1, 1, DDP_GRAPH_STEPS - 2)] * 2
    assert runs[0]["digest"] == runs[1]["digest"]


def test_ddp_step_graph_recaptures_at_il_events(nccl_runs):
    """An IL reset after step 3 and a release with a new temperature after
    step 6 each change the DDP step's key: every three steps run eager,
    capture, replay, and all nine equal eager DDP steps bit for bit."""
    runs = nccl_runs["il"]
    assert [r["modes"] for r in runs] == [(3, 3, 3)] * 2
    assert runs[0]["digest"] == runs[1]["digest"]


def test_ddp_step_graph_replay_advances_the_counters(nccl_runs):
    """Each DDP step, eager, captured or replayed, advances the registered
    kernel counters by the eager step's increments."""
    for r in nccl_runs["plain"]:
        assert all(d == r["deltas"][0] for d in r["deltas"]), r["deltas"]
        assert r["deltas"][0] == _moved(tiny_attention_fwd=4, tiny_attention_bwd=4,
                                        codebook_pool_fwd=2, codebook_pool_bwd_dq=2,
                                        codebook_pool_bwd_dsd=2)


def test_ddp_step_graph_replay_runs_the_nccl_kernels(nccl_runs):
    """A profiled replay of the DDP step holds NCCL's all-gather and
    all-reduce kernels: the collectives run inside the graph."""
    for r in nccl_runs["plain"]:
        assert r["profiled_mode"] == "replay"
        kernels = r["nccl_kernels"]
        assert any("AllGather" in k for k in kernels), kernels
        assert any("AllReduce" in k for k in kernels), kernels


def test_ddp_solver_graph_releases_the_group(nccl_runs):
    """``Solver.train()`` on two NCCL ranks captures its step once and replays
    the rest; after it the group is destroyed while the Solver lives (as
    ``cli_entry`` does), and both ranks end: ``train()`` released the step's
    graphs, whose NCCL collectives would hold the communicator."""
    for r in nccl_runs["solver"]:
        assert r["wrapped"] == "DistributedDataParallel"
        assert r["modes"] == (1, 1, 6)
    assert nccl_runs["ended"] == [0, 0]
