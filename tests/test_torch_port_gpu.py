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


def test_wrappers_raise_on_unsupported_cuda_inputs(dev):
    with pytest.raises(ValueError, match="causal=True"):
        fa.fused_tiny_attention(torch.zeros(1, 4, 3 * 64, dtype=torch.bfloat16, device=dev),
                                1, fa.causal_bias(4, dev))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.tiny_attention_fwd(torch.zeros(1, 4, 3 * 64, device=dev), 1)
    with pytest.raises(ValueError, match="bfloat16"):
        cb.codebook_pool_fwd(torch.zeros(1, 4, 64, device=dev),
                             torch.zeros(8, 64, device=dev), None, 1.0)


def test_model_kernel_path_matches_plain_path(dev):
    """A small bf16 CLIP-FDT (head_dim 64, codebook depth 64) through both
    kernels against the same weights on the plain path; cosine >= 0.999 per
    embedding (bf16 towers, rounding at the same places in another order)."""
    def cfg(fused):
        return {"type": "clip_fdt_vitb32", "kwargs": {
            "image_encode": {"input_resolution": 64, "patch_size": 16, "width": 128,
                             "layers": 2, "heads": 2, "embed_dim": 64},
            "text_encode": {"context_length": 20, "vocab_size": 300, "width": 128,
                            "heads": 2, "layers": 2, "embed_dim": 64},
            "fdt": {"sd_num": 256, "sd_dim": 64, "raw_img_ft_dim": 128,
                    "raw_txt_ft_dim": 128, "sparsemax_method": "bisect",
                    "use_fused_kernel": fused, "sd_temperature": 2.0},
            "fused_attn": fused, "dtype": "bfloat16"}}

    fast = model_entry(cfg(True), device=dev, generator=_gen(0))
    plain = model_entry(cfg(False), device=dev, generator=_gen(1))
    plain.load_state_dict(fast.state_dict())
    g = _gen(2)
    images = torch.randn(5, 64, 64, 3, generator=g, device=dev)
    tokens = torch.randint(1, 298, (5, 20), generator=g, device=dev)
    tokens[:, 9] = 299
    tokens[:, 10:] = 0
    pad = torch.zeros(5, 20, device=dev)
    pad[:, 10:] = float("-inf")
    with torch.no_grad():
        a = fast(images, tokens, pad)
        b = plain(images, tokens, pad)
    for key in ("image_embed", "text_embed"):
        cos = (a[key] * b[key]).sum(-1)
        assert torch.all(cos >= 0.999), (key, cos.min().item())
