"""The port's hand-written Hopper kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: every test skips without an sm_90 CUDA device (the kernels
are CUDA C++ for sm_90a and have no CPU form). On the card, from the repo root:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

(``--noconftest``: the suite's conftest sets up JAX, which the port's machine
does not have; this file imports no JAX.) Inputs are bf16, the kernels'
working type. ``chip_smoke.py`` repeats these checks at the full serving
shapes.
"""
import pytest
import torch

from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.ops import codebook_attention as cb
from iterated_learning_for_vlm_tpu_torch.ops import fused_attention as fa

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


@pytest.mark.parametrize("b,s,h,causal,with_bias", [
    (3, 1, 2, False, False), (3, 17, 2, False, True), (2, 50, 12, False, True),
    (2, 77, 8, True, True), (2, 32, 8, True, False), (2, 128, 4, True, True),
    (2, 100, 4, False, False),
])
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
])
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


def test_wrappers_raise_on_unsupported_cuda_inputs(dev):
    with pytest.raises(ValueError, match="causal=True"):
        fa.fused_tiny_attention(torch.zeros(1, 4, 3 * 64, dtype=torch.bfloat16, device=dev),
                                1, fa.causal_bias(4, dev))
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
    with pytest.raises(ValueError, match="D <="):
        cb.codebook_pool_bwd_dsd(torch.zeros(2, 4, 1088, dtype=bf, device=dev),
                                 torch.zeros(8, 1088, dtype=bf, device=dev), None, 1.0,
                                 amax, gp)


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
