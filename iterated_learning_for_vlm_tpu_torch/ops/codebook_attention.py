"""Fused FDT codebook attention (kernel K1-fwd).

Counterpart of ``iterated_learning_for_vlm_tpu/ops/codebook_attention.py``.
The FDT query head scores every token against every codebook entry and
max-pools over the tokens:

    pooled[b, n] = max_t (q[b, t] . sd[n] * D^-1/2 * keep[b, t] / temperature)

The unfused path materialises the ``[B, T, N]`` fp32 product (323 MB at
B=256, T=77, N=4096) and rereads it for the max; the kernel keeps it on chip
and writes only ``pooled`` and the argmax ``amax`` (the token each gradient
would route to).

- :func:`codebook_pool_fwd_reference` is the plain PyTorch version, with the
  TPU kernel's operation order (fp32 dot, ``* scale``, ``* keep``,
  ``/ temperature``); pads enter the max as 0 and ties go to the smallest t.
- :func:`codebook_pool_fwd` is the kernel wrapper: a CPU tensor takes the
  plain version, a CUDA tensor launches ``csrc/codebook_pool_fwd.cu`` or
  raises. ``codebook_pool_fwd.launches`` counts kernel launches.
- :func:`fused_codebook_attention` is the whole fused chain: pooling,
  bisection sparsemax and ``att @ sd`` (the last two stay framework ops, as
  they stay XLA in the JAX package).

Forward only: the backward kernels (K1-bwd dq/dsd) are not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ..models.sparsemax import sparsemax_bisect

MAX_TOKENS = 128
DEPTH_STEP = 64  # the kernel stages D in steps of 64


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


def _check_cuda_args(q, sd, keep):
    if q.dim() != 3 or sd.dim() != 2 or q.shape[-1] != sd.shape[-1]:
        raise ValueError(f"codebook_pool_fwd: q [B, T, D] and sd [N, D] expected, "
                         f"got {tuple(q.shape)} and {tuple(sd.shape)}")
    for name, x in (("q", q), ("sd", sd)):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"codebook_pool_fwd: {name} must be contiguous bfloat16 "
                             f"on {q.device}, got {x.dtype} on {x.device}")
    b, t, d = q.shape
    if not 1 <= t <= MAX_TOKENS or d % DEPTH_STEP or d == 0 or not 1 <= b <= 65535:
        raise ValueError(f"codebook_pool_fwd: needs 1 <= T <= {MAX_TOKENS}, D a "
                         f"multiple of {DEPTH_STEP} and 1 <= B <= 65535, "
                         f"got B={b} T={t} D={d}")
    if keep is not None and (keep.shape != (b, t) or keep.dtype != torch.float32
                             or keep.device != q.device or not keep.is_contiguous()):
        raise ValueError(f"codebook_pool_fwd: keep must be a contiguous [{b}, {t}] "
                         f"float32 tensor on {q.device}")


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


codebook_pool_fwd.launches = 0


def pooled_codebook_logits(q, sd, keep, temperature):
    """``max_t`` of masked scaled codebook inner products, ``[B, N]`` fp32."""
    return codebook_pool_fwd(q, sd, keep, temperature)[0]


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
