"""Flash attention over ``[B, S, H, D]`` heads (kernels K3-fwd, K3-bwd).

Counterpart of ``iterated_learning_for_vlm_tpu/ops/flash_attention.py``: per
(sample, head), fp32 logits scaled by ``D^-1/2`` plus an optional shared
``[S, S]`` fp32 bias, an fp32 softmax, the value product in fp32 (``v``
upcast, ``p`` not rounded) and one cast to q's dtype; the backward forms
``p`` again from the forward's row log-sum-exp and every gradient in fp32.
A ``causal`` flag computes the function of the causal bias without one.
These are not the numerics of the tiny-sequence kernels K2
(``ops/fused_attention.py``), which round ``p`` and ``ds`` to the operand
dtype.

- :func:`flash_attention_reference`, :func:`flash_attention_lse_reference`
  (which also returns ``lse``) and :func:`flash_attention_bwd_reference`
  (from ``lse``) are the plain PyTorch versions.
- :func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the kernel
  wrappers. A CPU tensor takes the plain version; a CUDA tensor launches
  ``csrc/flash_attention_fwd.cu`` / ``csrc/flash_attention_bwd.cu`` or
  raises. Each counts its calls that launch in ``.launches``.
- :class:`FlashAttention` is the ``autograd.Function`` over them (the JAX
  custom VJP): it saves q, k, v, the bias and ``lse``, and the bias gets no
  gradient.
- :func:`flash_attention` keeps the JAX entry point's signature and bias
  handling, and adds ``causal``. The JAX ``batch_partitioned`` SPMD wrapper
  has no counterpart.

The kernels read q, k and v in place as ``[B, S, H, 64]`` views with any
batch and token stride (the column blocks of the packed in_proj output) and
write contiguous ``[B, S, H, 64]``, the layout ``out_proj`` takes.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .graphs import counted

MAX_SEQ = 1024  # the kernels stage keys in chunks; the wrappers bound S here
HEAD_DIM = 64


def _logits(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
            causal: bool) -> torch.Tensor:
    """fp32 logits ``[B, H, S, S]`` in the TPU kernel's order: dot, scale,
    bias; then ``-inf`` above the diagonal when ``causal``."""
    logits = torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        s = q.shape[1]
        above = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(above, float("-inf"))
    return logits


def _probabilities(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
                   causal: bool) -> torch.Tensor:
    """``p [B, H, S, S]`` in fp32, in the TPU kernel's order: the logits,
    minus the row max, exp, divided by the row sum."""
    logits = _logits(q, k, bias, causal)
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return unnorm / unnorm.sum(dim=-1, keepdim=True)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              causal: bool = False) -> torch.Tensor:
    """Plain forward: ``[B, S, H, D]`` in q's dtype, ``p v`` in fp32."""
    p = _probabilities(q, k, bias, causal)
    return torch.einsum("bhqk,bkhc->bqhc", p, v.float()).to(q.dtype)


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: Optional[torch.Tensor] = None, causal: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward that also returns each row's fp32 log-sum-exp of the
    logits, ``lse [B, H, S]`` (natural log), which the backward takes."""
    return (flash_attention_reference(q, k, v, bias, causal),
            torch.logsumexp(_logits(q, k, bias, causal), dim=-1))


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias: Optional[torch.Tensor], lse: torch.Tensor,
                                  dout: torch.Tensor, causal: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward from the forward's ``lse``: ``p = exp(logits - lse)``,
    ``D = sum_j dp p`` exactly, then ``(dq, dk, dv)`` in q's dtype, every
    product in fp32."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_logits(q, k, bias, causal) - lse[..., None])
    do = dout.float()
    dv = torch.einsum("bhqk,bqhc->bkhc", p, do)
    dp = torch.einsum("bqhc,bkhc->bhqk", do, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhc->bqhc", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhc->bkhc", ds, q.float()) * scale
    dt = q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


# (q, k, v, bias, out, lse), (batch, seq, heads), strides, causal, scale, stream
_FWD_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (
    ctypes.c_longlong,) * 2 + (ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
# (q, k, v, bias, lse, dout, dq, dk, dv, dstat), (batch, seq, heads), strides,
# causal, scale, stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 3 + (
    ctypes.c_longlong,) * 4 + (ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def _check_heads(name: str, what: str, t: torch.Tensor, device) -> None:
    """A ``[B, S, H, 64]`` bf16 view the kernels read in place: heads at a
    stride of 64 and 16-byte aligned rows."""
    if (t.dim() != 4 or t.dtype != torch.bfloat16 or t.device != device
            or t.shape[-1] != HEAD_DIM or t.stride(3) != 1 or t.stride(2) != HEAD_DIM
            or t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16):
        raise ValueError(f"{name}: {what} must be a [B, S, H, {HEAD_DIM}] bfloat16 tensor on "
                         f"{device} with heads at a stride of {HEAD_DIM} and 16-byte aligned "
                         f"rows, got {tuple(t.shape)} {t.dtype} strides {t.stride()} "
                         f"on {t.device}")


def _check_cuda_args(q, k, v, bias, name="flash_attention_fwd"):
    for what, t in (("q", q), ("k", k), ("v", v)):
        _check_heads(name, what, t, q.device)
    if k.shape != q.shape or v.shape != q.shape or k.stride() != q.stride() \
            or v.stride() != q.stride():
        raise ValueError(f"{name}: q, k and v must share their shape and strides")
    b, s, h, _ = q.shape
    if not 1 <= s <= MAX_SEQ or not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f"{name}: needs 1 <= S <= {MAX_SEQ}, 1 <= B <= 65535 and "
                         f"1 <= H <= 65535, got B={b} S={s} H={h}")
    if bias is not None and (bias.shape != (s, s) or bias.dtype != torch.float32
                             or bias.device != q.device or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous [{s}, {s}] float32 tensor "
                         f"on {q.device}, got {tuple(bias.shape)} {bias.dtype}")


@counted("launches")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, causal: bool = False,
                        with_lse: bool = False):
    """Attention over ``[B, S, H, D]`` heads -> contiguous ``[B, S, H, D]``;
    ``bias`` an fp32 ``[S, S]`` additive logits bias or None, ``causal``
    masks keys above the diagonal. With ``with_lse`` it returns
    ``(out, lse)``, ``lse [B, H, S]`` fp32 the rows' log-sum-exp, which the
    backward takes (serving calls leave it out, and the kernel writes none)."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_lse_reference(q, k, v, bias, causal)
        return flash_attention_reference(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check_cuda_args(q, k, v, bias)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        fn = _build.kernel("flash_attention_fwd", _FWD_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, s, h, q.stride(0), q.stride(1),
                    int(causal), HEAD_DIM ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return (out, lse) if with_lse else out


@counted("launches")
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], lse: torch.Tensor, dout: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``, contiguous ``[B, S, H, D]``, of
    :func:`flash_attention_fwd` for the output gradient ``dout`` (q's dtype),
    from what the forward saved: the inputs, the bias, the causal flag and
    ``lse``. On the card one call makes two launches (dq, which also forms
    ``D = sum_j dp p`` per row, then dk and dv) and counts once."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, bias, lse, dout, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check_cuda_args(q, k, v, bias, "flash_attention_bwd")
    _check_heads("flash_attention_bwd", "dout", dout, q.device)
    b, s, h, d = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: dout must have q's shape {tuple(q.shape)}, "
                         f"got {tuple(dout.shape)}")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous [{b}, {h}, {s}] "
                         f"float32 tensor on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    dstat = torch.empty((b, h, s), dtype=torch.float32, device=q.device)  # D per row
    with torch.cuda.device(q.device):
        fn = _build.kernel("flash_attention_bwd", _BWD_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if bias is None else bias.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dstat.data_ptr(), b, s, h,
                    q.stride(0), q.stride(1), dout.stride(0), dout.stride(1), int(causal),
                    HEAD_DIM ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, bias, causal)``: K3-fwd forward, K3-bwd backward (the
    JAX custom VJP). Saves q, k, v, the bias and the forward's ``lse``; the
    bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        out, lse = flash_attention_fwd(q, k, v, bias, causal, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, bias, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, lse, g.to(q.dtype).contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """q/k/v: ``[B, S, H, D]``; bias: optional additive ``[S, S]`` logits mask,
    or a shared ``[1, 1, S, S]`` one; ``causal`` masks keys above the diagonal
    (the function of ``bias=causal_bias(S)``, without reading one). Returns
    ``[B, S, H, D]`` in q's dtype; differentiable in q, k and v. Without a
    gradient to take (serving), it calls the forward alone, which saves
    nothing and writes no ``lse``."""
    if bias is not None:
        bias = bias.float()
        if bias.dim() == 4:  # [1, 1, S, S] -> [S, S] (shared masks only)
            bias = bias.reshape(bias.shape[-2], bias.shape[-1])
        bias = bias.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, bias, causal)
    return flash_attention_fwd(q, k, v, bias, causal)
