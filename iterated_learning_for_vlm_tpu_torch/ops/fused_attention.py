"""Fused multi-head self-attention for tiny sequences (kernel K2-fwd).

Counterpart of ``iterated_learning_for_vlm_tpu/ops/fused_attention.py``. The
CLIP towers attend over S=50 (vision) and S<=77 (text) tokens with head_dim
64; the kernel reads the packed ``[B, S, 3D]`` in_proj output directly (q | k
| v column blocks, torch ``in_proj`` order), optionally adds the packed
in_proj bias itself, and writes ``[B, S, D]`` in the layout ``out_proj``
takes, so no head-split transposes or bias pass touch device memory.

- :func:`attention_reference` is the plain PyTorch version, with the numerics
  of the JAX package's ``xla_attention_reference``: fp32 logits and softmax,
  the value product in the operand dtype.
- :func:`tiny_attention_fwd` is the kernel wrapper. A CPU tensor takes the
  plain version; a CUDA tensor launches ``csrc/tiny_attention_fwd.cu`` or
  raises. ``tiny_attention_fwd.launches`` counts kernel launches.
- :func:`fused_tiny_attention` keeps the JAX entry point's signature. The
  TPU tiling knobs (``head_group``, ``batch_block``, ``sample_group``, their
  ``*_bwd`` forms, ``bwd_fuse3``) still parse and mean nothing here. On the
  main path the JAX ``bias`` is only ever the constant causal mask, which the
  kernel takes as a flag: pass ``causal=True``. An arbitrary ``bias`` runs on
  a CPU tensor (plain version) and is refused on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_SEQ = 128  # the tower routes longer sequences to the plain path
HEAD_DIM = 64  # the kernel's head width (every main-path tower)


def causal_bias(s: int, device=None) -> torch.Tensor:
    """``[S, S]`` fp32 additive mask: ``-inf`` above the diagonal."""
    return torch.triu(torch.full((s, s), float("-inf"), dtype=torch.float32,
                                 device=device), diagonal=1)


def attention_reference(qkv: torch.Tensor, heads: int,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain packed-QKV attention: fp32 logits and softmax, operand-dtype
    value product (``xla_attention_reference``)."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // heads
    q, k, v = (t.reshape(b, s, heads, hd) for t in qkv.split(d, dim=-1))
    logits = torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float()) * hd ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhc->bqhc", w.to(qkv.dtype), v)
    return out.reshape(b, s, d)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p)


def _check_cuda_args(qkv, heads, qkv_bias):
    if qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError(f"tiny_attention_fwd: qkv must be a contiguous [B, S, 3D] "
                         f"bfloat16 tensor, got {tuple(qkv.shape)} {qkv.dtype}")
    b, s, three_d = qkv.shape
    if three_d % (3 * heads) or three_d // (3 * heads) != HEAD_DIM:
        raise ValueError(f"tiny_attention_fwd: head_dim must be {HEAD_DIM} "
                         f"(3D={three_d}, heads={heads})")
    if not 1 <= s <= MAX_SEQ or not 1 <= b <= 65535:
        raise ValueError(f"tiny_attention_fwd: needs 1 <= S <= {MAX_SEQ} and "
                         f"1 <= B <= 65535, got B={b} S={s}")
    if qkv_bias is not None and (
            qkv_bias.shape != (three_d,) or qkv_bias.dtype != qkv.dtype
            or qkv_bias.device != qkv.device or not qkv_bias.is_contiguous()):
        raise ValueError(f"tiny_attention_fwd: qkv_bias must be a contiguous "
                         f"[{three_d}] {qkv.dtype} tensor on {qkv.device}")


def tiny_attention_fwd(qkv: torch.Tensor, heads: int, causal: bool = False,
                       qkv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over packed ``qkv`` ``[B, S, 3D]`` -> ``[B, S, D]``.

    ``qkv_bias`` (``[3D]``, operand dtype) is the in_proj bias when ``qkv`` is
    the pre-bias product; it is added in the operand dtype."""
    if qkv.device.type == "cpu":
        x = qkv if qkv_bias is None else qkv + qkv_bias.to(qkv.dtype)
        return attention_reference(
            x, heads, causal_bias(qkv.shape[1], qkv.device) if causal else None)
    if qkv.device.type != "cuda":
        raise ValueError(f"tiny_attention_fwd: unsupported device {qkv.device}")
    _check_cuda_args(qkv, heads, qkv_bias)
    b, s, three_d = qkv.shape
    out = torch.empty((b, s, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        fn = _build.kernel("tiny_attention_fwd", _ARGTYPES)
        status = fn(qkv.data_ptr(),
                    None if qkv_bias is None else qkv_bias.data_ptr(),
                    out.data_ptr(), b, s, heads, int(bool(causal)),
                    HEAD_DIM ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "tiny_attention_fwd")
    tiny_attention_fwd.launches += 1
    return out


tiny_attention_fwd.launches = 0


def fused_tiny_attention(
    qkv: torch.Tensor,
    heads: int,
    bias: Optional[torch.Tensor] = None,
    head_group: int = 4,
    batch_block: int = 8,
    sample_group: int = 1,
    head_group_bwd: Optional[int] = None,
    sample_group_bwd: Optional[int] = None,
    qkv_bias: Optional[torch.Tensor] = None,
    bwd_fuse3: int = 0,
    *,
    causal: bool = False,
) -> torch.Tensor:
    """The JAX ``fused_tiny_attention`` entry point (forward only). The TPU
    tiling knobs are accepted and ignored: the Hopper kernel has one block per
    (sample, head) and no block-diagonal grouping. ``bias`` is an ``[S, S]``
    additive logits bias; the kernel takes only the causal one, as
    ``causal=True``."""
    del head_group, batch_block, sample_group, head_group_bwd
    del sample_group_bwd, bwd_fuse3
    if bias is None:
        return tiny_attention_fwd(qkv, heads, causal=causal, qkv_bias=qkv_bias)
    if qkv.device.type != "cpu" or causal:
        raise ValueError("fused_tiny_attention: the CUDA kernel takes no bias tensor; "
                         "pass causal=True for the causal mask")
    x = qkv if qkv_bias is None else qkv + qkv_bias.to(qkv.dtype)
    return attention_reference(x, heads, bias)
