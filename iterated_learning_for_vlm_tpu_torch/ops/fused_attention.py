"""Fused multi-head self-attention for tiny sequences (kernels K2-fwd, K2-bwd).

Counterpart of ``iterated_learning_for_vlm_tpu/ops/fused_attention.py``. The
CLIP towers attend over S=50 (vision) and S<=77 (text) tokens with head_dim
64; the kernel reads the packed ``[B, S, 3D]`` in_proj output directly (q | k
| v column blocks, torch ``in_proj`` order), optionally adds the packed
in_proj bias itself, and writes ``[B, S, D]`` in the layout ``out_proj``
takes, so no head-split transposes or bias pass touch device memory.

- :func:`attention_reference` is the plain PyTorch version, with the numerics
  of the JAX package's ``xla_attention_reference``: fp32 logits and softmax,
  the value product in the operand dtype.
- :func:`attention_bwd_reference` is the plain version of the backward, with
  the rounding of the JAX ``_bwd_kernel``: the softmax recomputed in fp32
  (with the same bias), p rounded to bf16 for ``dv = p^T do``, ``dp = do v^T`` and
  ``ds = p (dp - sum(dp p))`` in fp32, ds rounded to bf16 for
  ``dq = ds k scale`` and ``dk = ds^T q scale``; fp32 sums, bf16 outputs.
- :func:`tiny_attention_fwd` and :func:`tiny_attention_bwd` are the kernel
  wrappers. A CPU tensor takes the plain version; a CUDA tensor launches
  ``csrc/tiny_attention_fwd.cu`` / ``csrc/tiny_attention_bwd.cu`` (one
  block per (sample, head), every product on the tensor cores) or raises.
  The kernels read their inputs by 16-byte copies, so each tensor must start
  16-byte aligned. Each wrapper counts its kernel launches in ``.launches``.
- :class:`TinyAttention` is the ``autograd.Function`` over them (the JAX
  custom VJP ``_attend``): ``dqkv`` from K2-bwd and ``dbias3``, its fp32 sum
  over (B, S) cast to the bias dtype; the ``[S, S]`` logits bias gets none.
- :func:`fused_tiny_attention` keeps the JAX entry point's signature. The
  TPU tiling knobs (``head_group``, ``batch_block``, ``sample_group``, their
  ``*_bwd`` forms, ``bwd_fuse3``) still parse and mean nothing here. ``bias``
  is any constant ``[S, S]`` additive logits bias, passed as fp32 to the
  kernels on every device and given no gradient, as the JAX
  ``stop_gradient`` has it. The towers pass the causal mask as the flag
  ``causal=True`` instead, which reads no tensor; a bias and the flag
  compose (the bias is added, then keys above the diagonal are masked).
  A row whose keys the bias masks all (``-inf``) comes out as zeros on both
  the kernel and the plain version; the JAX kernel, which clamps its mask at
  a finite floor, gives that row a mean over its padded key slots instead.
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


def _softmax(logits: torch.Tensor, masked: bool) -> torch.Tensor:
    """fp32 row softmax. With ``masked`` (a bias was added), a row whose keys
    are all ``-inf`` gets p = 0, as the kernels give it, not NaN."""
    p = torch.softmax(logits, dim=-1)
    if masked:
        p = p.masked_fill(torch.isneginf(logits.amax(dim=-1, keepdim=True)), 0.0)
    return p


def attention_reference(qkv: torch.Tensor, heads: int,
                        bias: Optional[torch.Tensor] = None, return_weights: bool = False):
    """Plain packed-QKV attention: fp32 logits and softmax, operand-dtype
    value product (``xla_attention_reference``). With ``return_weights`` it
    returns ``(out, weights)``, the fp32 probabilities averaged over heads
    ``[B, S, S]`` (JAX ``MultiheadAttention(return_weights=True)``)."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // heads
    q, k, v = (t.reshape(b, s, heads, hd) for t in qkv.split(d, dim=-1))
    logits = torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float()) * hd ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    w = _softmax(logits, bias is not None)
    out = torch.einsum("bhqk,bkhc->bqhc", w.to(qkv.dtype), v).reshape(b, s, d)
    if return_weights:
        return out, w.mean(dim=1)
    return out


def _full_bias(bias: Optional[torch.Tensor], causal: bool, s: int, device):
    """The ``[S, S]`` fp32 bias of the plain versions: ``bias``, then the
    causal mask when ``causal`` (None when neither)."""
    if bias is not None:
        bias = bias.float()
    if causal:
        mask = causal_bias(s, device)
        bias = mask if bias is None else bias + mask
    return bias


def attention_bwd_reference(qkv: torch.Tensor, heads: int, causal: bool,
                            qkv_bias: Optional[torch.Tensor], dout: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain backward of packed-QKV attention: ``dqkv [B, S, 3D]`` in qkv's
    dtype, for the pre-bias ``qkv`` (``qkv_bias`` added in qkv's dtype) and
    the ``[S, S]`` logits ``bias`` (none by default)."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // heads
    scale = hd ** -0.5
    dt = qkv.dtype
    x = qkv if qkv_bias is None else qkv + qkv_bias.to(dt)
    q, k, v = (t.reshape(b, s, heads, hd).float() for t in x.split(d, dim=-1))
    do = dout.to(dt).reshape(b, s, heads, hd).float()
    logits = torch.einsum("bqhc,bkhc->bhqk", q, k) * scale
    full = _full_bias(bias, causal, s, qkv.device)
    if full is not None:
        logits = logits + full
    p = _softmax(logits, bias is not None)
    dv = torch.einsum("bhqk,bqhc->bkhc", p.to(dt).float(), do)
    dp = torch.einsum("bqhc,bkhc->bhqk", do, v)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bhqk,bkhc->bqhc", ds, k) * scale
    dk = torch.einsum("bhqk,bqhc->bkhc", ds, q) * scale
    return torch.cat([t.to(dt).reshape(b, s, d) for t in (dq, dk, dv)], dim=-1)


# (qkv, qkv_bias, bias, out), (batch, seq, heads, causal), scale, stream
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p)
# (qkv, qkv_bias, bias, dout, dqkv), (batch, seq, heads, causal), scale, stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_float,
                                                                 ctypes.c_void_p)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _check_cuda_args(qkv, heads, qkv_bias, name="tiny_attention_fwd", bias=None):
    if (qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or not _aligned(qkv)):
        raise ValueError(f"{name}: qkv must be a contiguous, 16-byte aligned [B, S, 3D] "
                         f"bfloat16 tensor, got {tuple(qkv.shape)} {qkv.dtype}")
    b, s, three_d = qkv.shape
    if three_d % (3 * heads) or three_d // (3 * heads) != HEAD_DIM:
        raise ValueError(f"{name}: head_dim must be {HEAD_DIM} "
                         f"(3D={three_d}, heads={heads})")
    if not 1 <= s <= MAX_SEQ or not 1 <= b <= 65535:
        raise ValueError(f"{name}: needs 1 <= S <= {MAX_SEQ} and "
                         f"1 <= B <= 65535, got B={b} S={s}")
    if qkv_bias is not None and (
            qkv_bias.shape != (three_d,) or qkv_bias.dtype != qkv.dtype
            or qkv_bias.device != qkv.device or not qkv_bias.is_contiguous()
            or not _aligned(qkv_bias)):
        raise ValueError(f"{name}: qkv_bias must be a contiguous, 16-byte aligned "
                         f"[{three_d}] {qkv.dtype} tensor on {qkv.device}")
    if bias is not None and (bias.shape != (s, s) or bias.dtype != torch.float32
                             or bias.device != qkv.device or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous [{s}, {s}] float32 tensor "
                         f"on {qkv.device}, got {tuple(bias.shape)} {bias.dtype} "
                         f"on {bias.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def tiny_attention_fwd(qkv: torch.Tensor, heads: int, causal: bool = False,
                       qkv_bias: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over packed ``qkv`` ``[B, S, 3D]`` -> ``[B, S, D]``.

    ``qkv_bias`` (``[3D]``, operand dtype) is the in_proj bias when ``qkv`` is
    the pre-bias product; it is added in the operand dtype. ``bias`` is an
    fp32 ``[S, S]`` additive logits bias (the kernel reads it in place);
    ``causal`` masks keys above the diagonal after it."""
    if qkv.device.type == "cpu":
        x = qkv if qkv_bias is None else qkv + qkv_bias.to(qkv.dtype)
        return attention_reference(x, heads, _full_bias(bias, causal, qkv.shape[1], qkv.device))
    if qkv.device.type != "cuda":
        raise ValueError(f"tiny_attention_fwd: unsupported device {qkv.device}")
    _check_cuda_args(qkv, heads, qkv_bias, bias=bias)
    b, s, three_d = qkv.shape
    out = torch.empty((b, s, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        fn = _build.kernel("tiny_attention_fwd", _ARGTYPES)
        status = fn(qkv.data_ptr(), _ptr(qkv_bias), _ptr(bias), out.data_ptr(), b, s, heads,
                    int(bool(causal)), HEAD_DIM ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "tiny_attention_fwd")
    tiny_attention_fwd.launches += 1
    return out


tiny_attention_fwd.launches = 0


def tiny_attention_bwd(qkv: torch.Tensor, heads: int, causal: bool,
                       qkv_bias: Optional[torch.Tensor], dout: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dqkv [B, S, 3D]`` of :func:`tiny_attention_fwd` for the output
    gradient ``dout [B, S, D]`` (in qkv's dtype), recomputing the softmax
    with the same ``bias`` and ``causal``."""
    if qkv.device.type == "cpu":
        return attention_bwd_reference(qkv, heads, causal, qkv_bias, dout, bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"tiny_attention_bwd: unsupported device {qkv.device}")
    _check_cuda_args(qkv, heads, qkv_bias, "tiny_attention_bwd", bias)
    b, s, three_d = qkv.shape
    if (dout.shape != (b, s, three_d // 3) or dout.dtype != qkv.dtype
            or dout.device != qkv.device or not dout.is_contiguous() or not _aligned(dout)):
        raise ValueError(f"tiny_attention_bwd: dout must be a contiguous, 16-byte aligned "
                         f"[{b}, {s}, {three_d // 3}] {qkv.dtype} tensor on {qkv.device}, "
                         f"got {tuple(dout.shape)} {dout.dtype} on {dout.device}")
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        fn = _build.kernel("tiny_attention_bwd", _BWD_ARGTYPES)
        status = fn(qkv.data_ptr(), _ptr(qkv_bias), _ptr(bias), dout.data_ptr(),
                    dqkv.data_ptr(), b, s, heads, int(bool(causal)), HEAD_DIM ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "tiny_attention_bwd")
    tiny_attention_bwd.launches += 1
    return dqkv


tiny_attention_bwd.launches = 0


class TinyAttention(torch.autograd.Function):
    """``apply(qkv, heads, causal, qkv_bias, bias=None)``: K2-fwd forward,
    K2-bwd backward. Saves the pre-bias ``qkv``, ``qkv_bias`` and the fp32
    ``[S, S]`` logits ``bias``; neither the bias nor the causal mask gets a
    gradient."""

    @staticmethod
    def forward(ctx, qkv, heads, causal, qkv_bias, bias=None):
        ctx.save_for_backward(qkv, qkv_bias, bias)
        ctx.heads, ctx.causal = heads, causal
        return tiny_attention_fwd(qkv, heads, causal=causal, qkv_bias=qkv_bias, bias=bias)

    @staticmethod
    def backward(ctx, g):
        qkv, qkv_bias, bias = ctx.saved_tensors
        dqkv = tiny_attention_bwd(qkv, ctx.heads, ctx.causal, qkv_bias,
                                  g.to(qkv.dtype).contiguous(), bias)
        if qkv_bias is None:
            return dqkv, None, None, None, None
        # the absorbed bias sees every (sample, position) once; an fp32 sum
        # that reads dqkv as it is (no fp32 copy of it)
        dbias = dqkv.sum(dim=(0, 1), dtype=torch.float32)
        return dqkv, None, None, dbias.to(qkv_bias.dtype), None


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
    """The JAX ``fused_tiny_attention`` entry point, differentiable in
    ``qkv`` and ``qkv_bias``. The TPU tiling knobs are accepted and ignored:
    the Hopper kernels have one block per (sample, head) and no
    block-diagonal grouping. ``bias`` is a constant ``[S, S]`` additive
    logits bias: it gets no gradient (JAX's ``stop_gradient``) and goes to
    the kernels as fp32; ``causal=True`` masks keys above the diagonal
    without reading a tensor."""
    del head_group, batch_block, sample_group, head_group_bwd
    del sample_group_bwd, bwd_fuse3
    if bias is not None:
        bias = bias.detach().float().contiguous()
    return TinyAttention.apply(qkv, heads, causal, qkv_bias, bias)
