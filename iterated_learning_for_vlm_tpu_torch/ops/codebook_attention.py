"""Fused FDT codebook attention (kernels K1-fwd, K1-bwd dq and K1-bwd dsd).

Counterpart of ``iterated_learning_for_vlm_tpu/ops/codebook_attention.py``.
The FDT query head scores every token against every codebook entry and
max-pools over the tokens:

    pooled[b, n] = max_t (q[b, t] . sd[n] * D^-1/2 * keep[b, t] / temperature)

The unfused path materialises the ``[B, T, N]`` fp32 product (323 MB at
B=256, T=77, N=4096) and rereads it for the max; the kernel keeps it on chip
and writes only ``pooled`` and the argmax ``amax`` (the token each gradient
routes to). The backward sends each ``g[b, n]`` to that one token, with
``c = D^-1/2 / temperature``:

    dq[b, t] = sum_n [amax[b, n] = t] g[b, n] c keep[b, t] sd[n]
    dsd[n]   = sum_b g[b, n] c keep[b, amax[b, n]] q[b, amax[b, n]]

- :func:`codebook_pool_fwd_reference`, :func:`codebook_pool_bwd_dq_reference`
  and :func:`codebook_pool_bwd_dsd_reference` are the plain PyTorch versions, with the TPU kernels' operation order
  (fp32 dot, ``* scale``, ``* keep``, ``/ temperature``; the backward as a
  dense one-hot routing ``[B, T, N]`` in fp32). Pads enter the max as 0 and
  ties go to the smallest t.
- :func:`codebook_pool_fwd`, :func:`codebook_pool_bwd_dq` and
  :func:`codebook_pool_bwd_dsd` are the kernel wrappers: a CPU tensor takes
  the plain version, a CUDA tensor launches ``csrc/codebook_pool_fwd.cu`` or
  ``csrc/codebook_pool_bwd.cu`` or raises. Each counts its kernel launches
  in ``.launches``. The kernels take any T; D is a multiple of 64, at most
  ``MAX_DEPTH``.
- :class:`PooledCodebookLogits` is the ``autograd.Function`` over them (the
  JAX custom VJP of ``pooled_codebook_logits``); torch's own ``amax``
  backward would split the gradient among ties, which is not the routing
  rule here.
- :func:`fused_codebook_attention` is the whole fused chain: pooling,
  bisection sparsemax and ``att @ sd`` (the last two stay framework ops, as
  they stay XLA in the JAX package).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .graphs import counted
from ..models.sparsemax import sparsemax_bisect

DEPTH_STEP = 64  # the forward kernel stages D in steps of 64
MAX_DEPTH = 1024  # the forward keeps a [codes, D] tile resident (128 KB)


def codebook_pool_fwd_reference(q: torch.Tensor, sd: torch.Tensor,
                                keep: Optional[torch.Tensor],
                                temperature: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(pooled [B, N] fp32, amax [B, N] int32)``.

    Operands are widened to fp32 before the product, which is exact for bf16
    inputs, so the sum is the fp32 accumulation the kernel does."""
    t = q.shape[1]
    inner = torch.einsum("btd,nd->btn", q.float(), sd.float())
    inner = inner * q.shape[-1] ** -0.5
    if keep is not None:
        inner = inner * keep.float()[..., None]
    inner = inner / temperature
    pooled = inner.amax(dim=1)
    # first t reaching the max, spelled out so no backend's tie rule matters
    t_ids = torch.arange(t, dtype=torch.int32, device=q.device)[None, :, None]
    hit = torch.where(inner == pooled[:, None, :], t_ids, t)
    return pooled, hit.amin(dim=1).to(torch.int32)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)


def _check_cuda_args(q, sd, keep, name="codebook_pool_fwd"):
    if q.dim() != 3 or sd.dim() != 2 or q.shape[-1] != sd.shape[-1]:
        raise ValueError(f"{name}: q [B, T, D] and sd [N, D] expected, "
                         f"got {tuple(q.shape)} and {tuple(sd.shape)}")
    for arg, x in (("q", q), ("sd", sd)):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name}: {arg} must be contiguous bfloat16 "
                             f"on {q.device}, got {x.dtype} on {x.device}")
    if q.data_ptr() % 16 or sd.data_ptr() % 16:
        raise ValueError(f"{name}: q and sd must start on a 16-byte boundary")
    b, t, d = q.shape
    if t < 1 or d % DEPTH_STEP or not 0 < d <= MAX_DEPTH or not 1 <= b <= 65535:
        raise ValueError(f"{name}: needs T >= 1, D a multiple of {DEPTH_STEP} with "
                         f"D <= {MAX_DEPTH}, and 1 <= B <= 65535, got B={b} T={t} D={d}")
    if keep is not None and (keep.shape != (b, t) or keep.dtype != torch.float32
                             or keep.device != q.device or not keep.is_contiguous()):
        raise ValueError(f"{name}: keep must be a contiguous [{b}, {t}] "
                         f"float32 tensor on {q.device}")


def _check_bwd_args(q, sd, keep, amax, g, name):
    _check_cuda_args(q, sd, keep, name)
    b, n = q.shape[0], sd.shape[0]
    for arg, x, dtype in (("amax", amax, torch.int32), ("g", g, torch.float32)):
        if (x.shape != (b, n) or x.dtype != dtype or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be a contiguous [{b}, {n}] {dtype} "
                             f"tensor on {q.device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")


@counted("launches")
def codebook_pool_fwd(q: torch.Tensor, sd: torch.Tensor, keep: Optional[torch.Tensor],
                      temperature: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooled codebook logits and their argmax token: ``(pooled, amax)``.

    q: ``[B, T, D]``; sd: ``[N, D]`` in q's dtype; keep: ``[B, T]`` float
    (1 real, 0 pad) or None; temperature: a Python float, passed to the
    kernel at run time."""
    if q.device.type == "cpu":
        return codebook_pool_fwd_reference(q, sd, keep, temperature)
    if q.device.type != "cuda":
        raise ValueError(f"codebook_pool_fwd: unsupported device {q.device}")
    _check_cuda_args(q, sd, keep)
    b, t, d = q.shape
    n = sd.shape[0]
    pooled = torch.empty((b, n), dtype=torch.float32, device=q.device)
    amax = torch.empty((b, n), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        fn = _build.kernel("codebook_pool_fwd", _ARGTYPES)
        status = fn(q.data_ptr(), sd.data_ptr(),
                    None if keep is None else keep.data_ptr(),
                    pooled.data_ptr(), amax.data_ptr(), b, t, d, n,
                    d ** -0.5, float(temperature),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "codebook_pool_fwd")
    codebook_pool_fwd.launches += 1
    return pooled, amax


def pool_coeff(depth: int, temperature: float) -> float:
    """``c = D^-1/2 / temperature`` rounded as the TPU kernel forms it in fp32."""
    return float(np.float32(depth ** -0.5) / np.float32(temperature))


def _routing(t, keep, temperature, amax, g, depth):
    """``[B, T, N]`` fp32 one-hot routing: ``g[b, n] c`` at row ``amax[b, n]``,
    times ``keep[b, t]`` (JAX ``_routing_matrix``)."""
    t_ids = torch.arange(t, dtype=amax.dtype, device=amax.device)[None, :, None]
    m = torch.where(t_ids == amax[:, None, :], g.float()[:, None, :], 0.0)
    m = m * pool_coeff(depth, temperature)
    if keep is not None:
        m = m * keep.float()[:, :, None]
    return m


def codebook_pool_bwd_dq_reference(q, sd, keep, temperature, amax, g):
    """Plain ``dq [B, T, D]`` in q's dtype: an fp32 sum over the dense routing."""
    m = _routing(q.shape[1], keep, temperature, amax, g, q.shape[-1])
    return torch.einsum("btn,nd->btd", m, sd.float()).to(q.dtype)


def codebook_pool_bwd_dsd_reference(q, sd, keep, temperature, amax, g):
    """Plain ``dsd [N, D]`` in sd's dtype: an fp32 sum over the dense routing."""
    m = _routing(q.shape[1], keep, temperature, amax, g, q.shape[-1])
    return torch.einsum("btn,btd->nd", m, q.float()).to(sd.dtype)


def codebook_pool_bwd_reference(q, sd, keep, temperature, amax, g):
    """Plain version of the backward: ``(dq, dsd)``."""
    return (codebook_pool_bwd_dq_reference(q, sd, keep, temperature, amax, g),
            codebook_pool_bwd_dsd_reference(q, sd, keep, temperature, amax, g))


# (q, sd, keep, amax, g, out, scratch), (batch, tokens, depth, codes), coeff,
# stream; the int32 scratch holds the entry's routing
_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4 + (ctypes.c_float,
                                                                 ctypes.c_void_p)


def _launch_bwd(entry, out, q, sd, keep, temperature, amax, g, scratch):
    _check_bwd_args(q, sd, keep, amax, g, entry)
    b, t, d = q.shape
    with torch.cuda.device(q.device):
        fn = _build.kernel(entry, _BWD_ARGTYPES)
        status = fn(q.data_ptr(), sd.data_ptr(), None if keep is None else keep.data_ptr(),
                    amax.data_ptr(), g.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, t, d,
                    sd.shape[0], pool_coeff(d, temperature),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, entry)
    return out


@counted("launches")
def codebook_pool_bwd_dq(q, sd, keep, temperature, amax, g):
    """``dq [B, T, D]`` in q's dtype; g is the fp32 ``[B, N]`` gradient of
    ``pooled`` and amax the forward's argmax. On the card: a route kernel
    sorts each row's codes by amax into an int32 scratch (per row, 2N + T + 1
    values, each part rounded up to 16 bytes), then a gather kernel sums each
    token's run."""
    if q.device.type == "cpu":
        return codebook_pool_bwd_dq_reference(q, sd, keep, temperature, amax, g)
    if q.device.type != "cuda":
        raise ValueError(f"codebook_pool_bwd_dq: unsupported device {q.device}")
    b, t, _ = q.shape
    n2, t4 = (sd.shape[0] + 1) // 2 * 2, (t + 4) // 4 * 4
    scratch = torch.empty((b * (2 * n2 + t4),), dtype=torch.int32, device=q.device)
    out = _launch_bwd("codebook_pool_bwd_dq", torch.empty_like(q), q, sd, keep,
                      temperature, amax, g, scratch)
    codebook_pool_bwd_dq.launches += 1
    return out


@counted("launches")
def codebook_pool_bwd_dsd(q, sd, keep, temperature, amax, g):
    """``dsd [N, D]`` in sd's dtype (arguments as :func:`codebook_pool_bwd_dq`).
    On the card: a route kernel writes each (b, n)'s token and weight into an
    int32 scratch (per row, 2N values, N rounded up to 256), then the gather
    kernel walks the batch rows in order."""
    if q.device.type == "cpu":
        return codebook_pool_bwd_dsd_reference(q, sd, keep, temperature, amax, g)
    if q.device.type != "cuda":
        raise ValueError(f"codebook_pool_bwd_dsd: unsupported device {q.device}")
    n256 = (sd.shape[0] + 255) // 256 * 256
    scratch = torch.empty((q.shape[0] * 2 * n256,), dtype=torch.int32, device=q.device)
    out = _launch_bwd("codebook_pool_bwd_dsd", torch.empty_like(sd), q, sd, keep,
                      temperature, amax, g, scratch)
    codebook_pool_bwd_dsd.launches += 1
    return out


def codebook_pool_bwd(q, sd, keep, temperature, amax, g):
    """Both gradients of the pooling: ``(dq, dsd)``."""
    return (codebook_pool_bwd_dq(q, sd, keep, temperature, amax, g),
            codebook_pool_bwd_dsd(q, sd, keep, temperature, amax, g))


class PooledCodebookLogits(torch.autograd.Function):
    """``apply(q, sd, keep, temperature)`` -> ``pooled [B, N]`` fp32, with the
    max-pool backward routed to the forward's argmax token (K1-bwd)."""

    @staticmethod
    def forward(ctx, q, sd, keep, temperature):
        pooled, amax = codebook_pool_fwd(q, sd, keep, temperature)
        ctx.save_for_backward(q, sd, keep, amax)
        ctx.temperature = temperature
        return pooled

    @staticmethod
    def backward(ctx, g):
        q, sd, keep, amax = ctx.saved_tensors
        dq, dsd = codebook_pool_bwd(q, sd, keep, ctx.temperature, amax,
                                    g.float().contiguous())
        return dq, dsd, None, None


def pooled_codebook_logits(q, sd, keep, temperature):
    """``max_t`` of masked scaled codebook inner products, ``[B, N]`` fp32,
    differentiable in q and sd."""
    return PooledCodebookLogits.apply(q, sd, keep, temperature)


def fused_codebook_attention(
    q: torch.Tensor,
    sd: torch.Tensor,
    keep_mask: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    pool_type: str = "max",
):
    """Fused sparsemax/max-pool QueryModel attention: ``(att [B, N], att_ft [B, D])``.

    The codebook is cast to q's dtype for the pooling; the bisection
    sparsemax always runs on this path; ``att_ft = att @ sd`` in fp32."""
    if pool_type != "max":
        raise ValueError("the fused codebook kernel implements max pooling only")
    keep = None if keep_mask is None else keep_mask.float().contiguous()
    pooled = pooled_codebook_logits(q.contiguous(), sd.to(q.dtype).contiguous(), keep,
                                    temperature)
    att = sparsemax_bisect(pooled)
    att_ft = torch.matmul(att, sd.float())
    return att, att_ft
