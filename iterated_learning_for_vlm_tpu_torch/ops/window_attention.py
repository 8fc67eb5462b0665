"""Shifted-window attention of the Swin tower (kernels K4-fwd, K4-bwd).

No TPU kernel stands behind this one: the JAX package's ``WindowAttention``
(``iterated_learning_for_vlm_tpu/models/swin.py``) is two einsums that XLA
fuses. On the card the plain route would write every window's fp32 logits
and probabilities to device memory ([windows, heads, N, N], 1.36 GB a layer
at stage 0 of Swin-B at 192 px and 256 images), so this op keeps them on
chip. Swin's attention differs from the towers' K2 / K3 calls in three ways
the kernels take: head width 32, N = ws^2 = 144 tokens a window (36 at the
last stage), and an additive fp32 bias per (window, head): the head's
learned relative-position bias, gathered from its table, plus the window's
shift mask (-100 across a cyclic-shift seam).

- :func:`relative_position_index` and :func:`shift_mask` build the two
  constants as the JAX package does (``_relative_coords``, ``_shift_mask``).
- :func:`window_attention_reference` / :func:`window_attention_bwd_reference`
  are the plain versions with the kernels' numerics: fp32 logits, bias and
  softmax, p rounded to the operand dtype before ``p v`` (fp32 sums, one
  rounding); the backward as K2-bwd's (``fused_attention.py``), and the
  bias's gradient, the fp32 ds summed over the windows, per head.
- :func:`window_attention_fwd` / :func:`window_attention_bwd` are the kernel
  wrappers: a CPU tensor takes the plain version, a CUDA tensor launches
  ``csrc/window_attention_{fwd,bwd}.cu`` or raises. Each counts its launches
  in ``.launches``.
- :class:`WindowAttentionFn` is the ``autograd.Function`` over them;
  :class:`RelativePositionBias` gathers the ``[H, N, N]`` bias from the
  ``[(2 ws - 1)^2, H]`` table and reduces its gradient back onto the table
  by two small contractions with 0/1 diagonal matrices, no float atomics
  (``index_put`` with accumulation would take them on the card).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .graphs import counted

MAX_N = 144      # tokens a window: 12 x 12, the largest window the kernels take
HEAD_DIM = 32    # every Swin-B stage's head width
SHIFT_MASK = -100.0


def relative_position_index(ws: int) -> np.ndarray:
    """``[ws^2, ws^2]`` int64: the table row of each (query, key) pair, as the
    JAX ``WindowAttention`` indexes it."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # [N, N, 2]
    return ((rel[..., 0] + ws - 1) * (2 * ws - 1) + (rel[..., 1] + ws - 1)).astype(np.int64)


def shift_mask(hw: int, ws: int, shift: int) -> np.ndarray:
    """``[nW, N, N]`` fp32: -100 between tokens of one shifted window that came
    from different regions of the rolled image, 0 elsewhere (JAX
    ``SwinBlock._shift_mask``)."""
    img = np.zeros((hw, hw), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(hw // ws, ws, hw // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, SHIFT_MASK, 0.0).astype(np.float32)


def combined_bias(rel_bias: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernels' ``[nbias, H, N, N]`` fp32 bias: the heads' relative-position
    bias plus each window's mask (window w takes entry ``w % nbias``)."""
    bias = rel_bias.float()[None]
    if mask is not None:
        bias = bias + mask.float()[:, None]
    return bias.contiguous()


def _split(qkv: torch.Tensor, heads: int):
    w, n, three_c = qkv.shape
    hd = three_c // (3 * heads)
    return (t.reshape(w, n, heads, hd) for t in qkv.split(three_c // 3, dim=-1))


def _per_window(bias: torch.Tensor, windows: int) -> torch.Tensor:
    """``[windows, H, N, N]`` view of the ``[nbias, H, N, N]`` bias."""
    nbias = bias.shape[0]
    return bias[None].expand(windows // nbias, *bias.shape).reshape(windows, *bias.shape[1:])


def _probs(qkv: torch.Tensor, bias: torch.Tensor, heads: int):
    q, k, v = _split(qkv, heads)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("wqhc,wkhc->whqk", q.float(), k.float()) * scale
    logits = logits + _per_window(bias, qkv.shape[0])
    return torch.softmax(logits, dim=-1), v


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain window attention: ``qkv [W, N, 3C]`` (q | k | v column blocks,
    bias added), ``bias [nbias, H, N, N]`` fp32 -> ``[W, N, C]`` in qkv's
    dtype: fp32 logits, bias and softmax, p rounded to the operand dtype for
    ``p v``."""
    w, n, three_c = qkv.shape
    p, v = _probs(qkv, bias, heads)
    return torch.einsum("whqk,wkhc->wqhc", p.to(qkv.dtype), v).reshape(w, n, three_c // 3)


def window_attention_bwd_reference(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                                   dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward with K4-bwd's rounding: ``(dqkv [W, N, 3C]`` in qkv's
    dtype, ``dbias [H, N, N]`` fp32, the sum over windows of ds). p and ds are
    fp32, rounded to the operand dtype for ``dv = p^T do``, ``dq = ds k scale``
    and ``dk = ds^T q scale``; ``dp = do v^T`` and ``D = sum(dp p)`` in fp32."""
    w, n, three_c = qkv.shape
    dt = qkv.dtype
    q, k, v = (t.float() for t in _split(qkv, heads))
    scale = q.shape[-1] ** -0.5
    p, _ = _probs(qkv, bias, heads)
    do = dout.to(dt).reshape(w, n, heads, -1).float()
    dv = torch.einsum("whqk,wqhc->wkhc", p.to(dt).float(), do)
    dp = torch.einsum("wqhc,wkhc->whqk", do, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsr = ds.to(dt).float()
    dq = torch.einsum("whqk,wkhc->wqhc", dsr, k) * scale
    dk = torch.einsum("whqk,wqhc->wkhc", dsr, q) * scale
    dqkv = torch.cat([t.to(dt).reshape(w, n, three_c // 3) for t in (dq, dk, dv)], dim=-1)
    return dqkv, ds.sum(dim=0)


# (qkv, bias, out), (windows, n, heads, nbias), scale, stream
_FWD_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p)
# (qkv, bias, dout, dqkv, dbias_part), (windows, n, heads, nbias, groups), scale, stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_void_p)
_GROUPS_ARGTYPES = (ctypes.c_int,) * 3


def _check_cuda_args(name: str, qkv: torch.Tensor, bias: torch.Tensor, heads: int) -> None:
    if (qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or qkv.data_ptr() % 16):
        raise ValueError(f"{name}: qkv must be a contiguous, 16-byte aligned [W, N, 3C] "
                         f"bfloat16 tensor, got {tuple(qkv.shape)} {qkv.dtype}")
    w, n, three_c = qkv.shape
    if three_c % (3 * heads) or three_c // (3 * heads) != HEAD_DIM:
        raise ValueError(f"{name}: head_dim must be {HEAD_DIM} (3C={three_c}, heads={heads})")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: needs 1 <= N <= {MAX_N}, got N={n}")
    if (bias.dim() != 4 or bias.shape[1:] != (heads, n, n) or w % bias.shape[0]
            or bias.dtype != torch.float32 or bias.device != qkv.device
            or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous [nbias, {heads}, {n}, {n}] float32 "
                         f"tensor on {qkv.device} with nbias dividing W={w}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")


@counted("launches")
def window_attention_fwd(qkv: torch.Tensor, bias: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention over each window of ``qkv [W, N, 3C]`` with the fp32 additive
    ``bias [nbias, H, N, N]`` (window w takes ``bias[w % nbias]``) ->
    ``[W, N, C]``."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_fwd: unsupported device {qkv.device}")
    _check_cuda_args("window_attention_fwd", qkv, bias, heads)
    w, n, three_c = qkv.shape
    out = torch.empty((w, n, three_c // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        fn = _build.kernel("window_attention_fwd", _FWD_ARGTYPES)
        status = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), w, n, heads,
                    bias.shape[0], HEAD_DIM ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "window_attention_fwd")
    window_attention_fwd.launches += 1
    return out


@counted("launches")
def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                         dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dqkv [W, N, 3C], dbias [H, N, N] fp32)`` of :func:`window_attention_fwd`
    for the output gradient ``dout [W, N, C]``. On the card each block sums
    its windows' ds in a fixed order and writes one ``[H, N, N]`` partial; the
    partials are summed here, so two calls agree bit for bit."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, heads, dout)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: unsupported device {qkv.device}")
    _check_cuda_args("window_attention_bwd", qkv, bias, heads)
    w, n, three_c = qkv.shape
    if (dout.shape != (w, n, three_c // 3) or dout.dtype != qkv.dtype
            or dout.device != qkv.device or not dout.is_contiguous() or dout.data_ptr() % 16):
        raise ValueError(f"window_attention_bwd: dout must be a contiguous, 16-byte aligned "
                         f"[{w}, {n}, {three_c // 3}] {qkv.dtype} tensor on {qkv.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        groups = _build.kernel("window_attention_bwd_groups", _GROUPS_ARGTYPES)(w, n, heads)
        if groups < 1:
            raise RuntimeError(f"window_attention_bwd: no launch shape for W={w} N={n} "
                               f"heads={heads}")
        part = torch.empty((groups, heads, n, n), dtype=torch.float32, device=qkv.device)
        fn = _build.kernel("window_attention_bwd", _BWD_ARGTYPES)
        status = fn(qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                    part.data_ptr(), w, n, heads, bias.shape[0], groups, HEAD_DIM ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "window_attention_bwd")
    window_attention_bwd.launches += 1
    return dqkv, part.sum(dim=0)


class WindowAttentionFn(torch.autograd.Function):
    """``apply(qkv, rel_bias, mask, heads)``: K4-fwd forward, K4-bwd backward.
    ``rel_bias [H, N, N]`` gets the fp32 sum of ds over the windows; the
    constant ``mask [nW, N, N]`` (or None) gets none."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, mask, heads):
        bias = combined_bias(rel_bias, mask)
        ctx.save_for_backward(qkv, bias)
        ctx.heads = heads
        return window_attention_fwd(qkv, bias, heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, ctx.heads, g.to(qkv.dtype).contiguous())
        return dqkv, dbias, None, None


def _diagonals(ws: int, device) -> torch.Tensor:
    """``[ws, ws, 2 ws - 1]`` fp32: 1 where ``a - b + ws - 1 == d``."""
    a = torch.arange(ws, device=device)
    return torch.nn.functional.one_hot(a[:, None] - a[None, :] + ws - 1, 2 * ws - 1).float()


class RelativePositionBias(torch.autograd.Function):
    """``apply(table [(2 ws - 1)^2, H], index [N, N], ws) -> [H, N, N]`` fp32.

    The backward sums each head's ``[N, N]`` gradient over the pairs that
    share a table row, (dy, dx) = (yq - yk, xq - xk): two contractions with
    the 0/1 diagonal matrix of :func:`_diagonals`, one per axis."""

    @staticmethod
    def forward(ctx, table, index, ws):
        ctx.ws = ws
        n = index.shape[0]
        return table.float()[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        ws = ctx.ws
        heads = g.shape[0]
        d = _diagonals(ws, g.device)
        grad = torch.einsum("hyxzw,yza,xwb->abh", g.float().reshape(heads, ws, ws, ws, ws), d, d)
        return grad.reshape((2 * ws - 1) ** 2, heads), None, None
