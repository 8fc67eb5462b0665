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
  in ``.launches`` and the bias slices its launches staged in ``.stagings``.
- :func:`walk_plan` partitions a launch's windows among its blocks: a block
  owns one head and one bias slice (``w % nbias``), stages that slice once
  and walks its windows (:func:`block_windows`); windows x heads over
  ``.stagings`` is the walk's reuse of a staged slice.
- The cosine form (Swin V2): given ``scale [H]`` (fp32, on the device), the
  logits are ``scale[h] * cos(q_i, k_j)`` in place of ``q_i . k_j / sqrt(32)``,
  the rows normalised as ``q / (|q| + 1e-12)``. Its wrappers
  :func:`window_attention_cos_fwd` / :func:`window_attention_cos_bwd` launch
  the kernels' cosine entries and count in their own ``.launches`` and
  ``.stagings``; the backward also gives the scale's gradient, summed over
  the windows.
- :class:`WindowAttentionFn` is the ``autograd.Function`` over them;
  :class:`RelativePositionBias` gathers the ``[H, N, N]`` bias from the
  ``[(2 ws - 1)^2, H]`` table and reduces its gradient back onto the table
  by two small contractions with 0/1 diagonal matrices, no float atomics
  (``index_put`` with accumulation would take them on the card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

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


def _inverse_norms(x: torch.Tensor) -> torch.Tensor:
    """``1 / (|x| + 1e-12)`` over the last axis, kept for broadcasting."""
    return 1.0 / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def _logits(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
            scale: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """fp32 ``(logits [W, H, N, N], q, k, v, rq, rk)``: the dot-product form's
    ``q k^T / sqrt(32)``, or with ``scale [H]`` the cosine form's ``scale[h]
    (q k^T) rq rk`` (rq, rk the rows' inverse norms ``[W, N, H, 1]``, None
    in the dot-product form), plus the bias."""
    q, k, v = (t.float() for t in _split(qkv, heads))
    logits = torch.einsum("wqhc,wkhc->whqk", q, k)
    if scale is None:
        logits = logits * q.shape[-1] ** -0.5
        rq = rk = None
    else:
        rq, rk = _inverse_norms(q), _inverse_norms(k)
        rq_t, rk_t = rq[..., 0].transpose(1, 2), rk[..., 0].transpose(1, 2)  # [W, H, N]
        logits = logits * rq_t[..., None] * rk_t[:, :, None] * scale.float()[:, None, None]
    return logits + _per_window(bias, qkv.shape[0]), q, k, v, rq, rk


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain window attention: ``qkv [W, N, 3C]`` (q | k | v column blocks,
    bias added), ``bias [nbias, H, N, N]`` fp32 -> ``[W, N, C]`` in qkv's
    dtype: fp32 logits (the cosine form's with ``scale [H]``), bias and
    softmax, p rounded to the operand dtype for ``p v``."""
    w, n, three_c = qkv.shape
    logits, *_, v, _, _ = _logits(qkv, bias, heads, scale)
    p = torch.softmax(logits, dim=-1).to(qkv.dtype)
    return torch.einsum("whqk,wkhc->wqhc", p, v.to(qkv.dtype)).reshape(w, n, three_c // 3)


def _unit_grad(acc: torch.Tensor, x: torch.Tensor, r: torch.Tensor):
    """``(r (acc - xhat (xhat . acc)), xhat . acc)`` for ``acc`` the gradient
    of the unit rows ``xhat = x r`` (the 1e-12 left out of the Jacobian)."""
    unit = x * r
    dot = (unit * acc).sum(dim=-1, keepdim=True)
    return r * (acc - unit * dot), dot


def window_attention_bwd_reference(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                                   dout: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """Plain backward with K4-bwd's rounding: ``(dqkv [W, N, 3C]`` in qkv's
    dtype, ``dbias [H, N, N]`` fp32, the sum over windows of ds``)``, and with
    ``scale`` a third item, ``dscale [H]`` fp32. p and ds are fp32, rounded
    to the operand dtype for ``dv = p^T do``, ``dq = ds k scale`` and
    ``dk = ds^T q scale``; ``dp = do v^T`` and ``D = sum(dp p)`` in fp32.
    The cosine form rounds ``ds rk`` (for dq) and ``rq ds`` (for dk) instead
    of ds, takes each product back through its rows' normalisation, and sums
    ``qhat_i . (sum_j ds_ij khat_j)`` over the rows and windows for dscale."""
    w, n, three_c = qkv.shape
    dt = qkv.dtype
    logits, q, k, v, rq, rk = _logits(qkv, bias, heads, scale)
    p = torch.softmax(logits, dim=-1)
    do = dout.to(dt).reshape(w, n, heads, -1).float()
    dv = torch.einsum("whqk,wqhc->wkhc", p.to(dt).float(), do)
    dp = torch.einsum("wqhc,wkhc->whqk", do, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if scale is None:
        mul = q.shape[-1] ** -0.5
        dsr = ds.to(dt).float()
        dq = torch.einsum("whqk,wkhc->wqhc", dsr, k) * mul
        dk = torch.einsum("whqk,wqhc->wkhc", dsr, q) * mul
    else:
        mul = scale.float()[:, None]  # [H, 1] against [W, N, H, C]
        rq_t, rk_t = rq[..., 0].transpose(1, 2), rk[..., 0].transpose(1, 2)  # [W, H, N]
        dsq = (ds * rk_t[:, :, None]).to(dt).float()
        dsk = (ds * rq_t[..., None]).to(dt).float()
        dq, dot = _unit_grad(torch.einsum("whqk,wkhc->wqhc", dsq, k), q, rq)
        dk, _ = _unit_grad(torch.einsum("whqk,wqhc->wkhc", dsk, q), k, rk)
        dq, dk = dq * mul, dk * mul
    dqkv = torch.cat([t.to(dt).reshape(w, n, three_c // 3) for t in (dq, dk, dv)], dim=-1)
    if scale is None:
        return dqkv, ds.sum(dim=0)
    return dqkv, ds.sum(dim=0), dot[..., 0].sum(dim=(0, 1))


class WalkPlan(NamedTuple):
    """How a K4 launch's blocks walk its windows."""
    per: int     # blocks of each (bias slice, head)
    blocks: int  # blocks of the launch, nbias * per * heads: the bias slices it stages
    walk: int    # the most windows a block walks


def walk_plan(windows: int, heads: int, nbias: int, sms: int, per_sm: int) -> WalkPlan:
    """The blocks of a launch over ``windows`` windows of ``heads`` heads,
    window w taking bias slice ``w % nbias``, on a card of ``sms`` SMs that
    each hold ``per_sm`` of the kernel's blocks at once. Each (slice, head)
    gets an equal share of the blocks the card holds, at least one; its
    windows go to them as evenly as they divide, and the fewest blocks that
    keep the longest walk that short take them. So a launch that fits the
    card takes one window a block."""
    if min(windows, heads, nbias, sms, per_sm) < 1 or windows % nbias:
        raise ValueError(f"walk_plan: no plan for windows={windows} heads={heads} "
                         f"nbias={nbias} sms={sms} per_sm={per_sm}")
    slice_windows = windows // nbias
    room = max(1, sms * per_sm // (nbias * heads))
    walk = -(-slice_windows // min(room, slice_windows))
    per = -(-slice_windows // walk)
    return WalkPlan(per, nbias * per * heads, walk)


def block_windows(block: int, windows: int, nbias: int, per: int) -> List[int]:
    """The windows block ``block`` (its index along the launch's first axis)
    walks, in the kernels' order (``window_attention.cuh`` ``walk_window``):
    the bias slice ``s = block % nbias``'s windows ``s + nbias k`` for
    ``k = block // nbias, + per, ...``. The block's partial of the bias
    gradient sits at ``block`` along the first axis."""
    first, s = divmod(block, nbias)
    return [s + nbias * k for k in range(first, windows // nbias, per)]


@functools.lru_cache(maxsize=None)
def _occupancy(entry: str, n: int, cosine: bool, device: int) -> Tuple[int, int]:
    """(SMs, blocks an SM holds) of a K4 kernel at N = n on ``device``."""
    per_sm = _build.kernel(entry, _OCCUPANCY_ARGTYPES)(n, int(cosine))
    if per_sm < 1:
        raise RuntimeError(f"{entry}: no launch shape for N={n}")
    return torch.cuda.get_device_properties(device).multi_processor_count, per_sm


def launch_plan(kind: str, qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                cosine: bool) -> WalkPlan:
    """The walk of a ``kind`` (``"fwd"`` or ``"bwd"``) launch over ``qkv`` on
    its card, from what the card reports."""
    w, n, _ = qkv.shape
    sms, per_sm = _occupancy(f"window_attention_{kind}_blocks_per_sm", n, cosine,
                             qkv.device.index if qkv.device.index is not None
                             else torch.cuda.current_device())
    return walk_plan(w, heads, bias.shape[0], sms, per_sm)


# (qkv, bias, out), (windows, n, heads, nbias, per), scale, stream
_FWD_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_void_p)
# (qkv, bias, dout, dqkv, dbias_part), (windows, n, heads, nbias, per), scale, stream
_BWD_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_void_p)
# n, cosine
_OCCUPANCY_ARGTYPES = (ctypes.c_int,) * 2
# (qkv, bias, scales, out), (windows, n, heads, nbias, per), stream
_COS_FWD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# (qkv, bias, scales, dout, dqkv, dbias_part, dscale_part),
# (windows, n, heads, nbias, per), stream
_COS_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


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


@counted("stagings")
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
        plan = launch_plan("fwd", qkv, bias, heads, cosine=False)
        fn = _build.kernel("window_attention_fwd", _FWD_ARGTYPES)
        status = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), w, n, heads,
                    bias.shape[0], plan.per, HEAD_DIM ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "window_attention_fwd")
    window_attention_fwd.launches += 1
    window_attention_fwd.stagings += plan.blocks
    return out


@counted("stagings")
@counted("launches")
def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
                         dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dqkv [W, N, 3C], dbias [H, N, N] fp32)`` of :func:`window_attention_fwd`
    for the output gradient ``dout [W, N, C]``. On the card each block sums
    its windows' ds in a fixed order and writes one ``[N, N]`` partial; the
    partials are summed here, so two calls agree bit for bit."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, heads, dout)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: unsupported device {qkv.device}")
    _check_cuda_args("window_attention_bwd", qkv, bias, heads)
    _check_dout("window_attention_bwd", qkv, dout)
    w, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    nbias = bias.shape[0]
    with torch.cuda.device(qkv.device):
        plan = launch_plan("bwd", qkv, bias, heads, cosine=False)
        part = torch.empty((nbias * plan.per, heads, n, n), dtype=torch.float32,
                           device=qkv.device)
        fn = _build.kernel("window_attention_bwd", _BWD_ARGTYPES)
        status = fn(qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                    part.data_ptr(), w, n, heads, nbias, plan.per, HEAD_DIM ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
    _build.check(status, "window_attention_bwd")
    window_attention_bwd.launches += 1
    window_attention_bwd.stagings += plan.blocks
    return dqkv, part.sum(dim=0)


def _check_scale(name: str, qkv: torch.Tensor, scale: torch.Tensor, heads: int) -> None:
    if (scale.shape != (heads,) or scale.dtype != torch.float32 or scale.device != qkv.device
            or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must be a contiguous [{heads}] float32 tensor on "
                         f"{qkv.device}, got {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device}")


def _check_dout(name: str, qkv: torch.Tensor, dout: torch.Tensor) -> None:
    w, n, three_c = qkv.shape
    if (dout.shape != (w, n, three_c // 3) or dout.dtype != qkv.dtype
            or dout.device != qkv.device or not dout.is_contiguous() or dout.data_ptr() % 16):
        raise ValueError(f"{name}: dout must be a contiguous, 16-byte aligned "
                         f"[{w}, {n}, {three_c // 3}] {qkv.dtype} tensor on {qkv.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")


@counted("stagings")
@counted("launches")
def window_attention_cos_fwd(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """The cosine form of :func:`window_attention_fwd`: head h's logits are
    ``scale[h]`` times the cosines of the q and k rows (``scale [H]`` fp32)."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_cos_fwd: unsupported device {qkv.device}")
    _check_cuda_args("window_attention_cos_fwd", qkv, bias, heads)
    _check_scale("window_attention_cos_fwd", qkv, scale, heads)
    w, n, three_c = qkv.shape
    out = torch.empty((w, n, three_c // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        plan = launch_plan("fwd", qkv, bias, heads, cosine=True)
        fn = _build.kernel("window_attention_cos_fwd", _COS_FWD_ARGTYPES)
        status = fn(qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(), out.data_ptr(), w, n,
                    heads, bias.shape[0], plan.per, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "window_attention_cos_fwd")
    window_attention_cos_fwd.launches += 1
    window_attention_cos_fwd.stagings += plan.blocks
    return out


@counted("stagings")
@counted("launches")
def window_attention_cos_bwd(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                             heads: int, dout: torch.Tensor):
    """``(dqkv, dbias [H, N, N], dscale [H])`` of :func:`window_attention_cos_fwd`:
    dqkv the gradient of the raw q, k and v, dbias and dscale fp32, each
    summed over the windows from per-block partials, as
    :func:`window_attention_bwd` sums dbias."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, heads, dout, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_cos_bwd: unsupported device {qkv.device}")
    _check_cuda_args("window_attention_cos_bwd", qkv, bias, heads)
    _check_scale("window_attention_cos_bwd", qkv, scale, heads)
    _check_dout("window_attention_cos_bwd", qkv, dout)
    w, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    nbias = bias.shape[0]
    with torch.cuda.device(qkv.device):
        plan = launch_plan("bwd", qkv, bias, heads, cosine=True)
        part = torch.empty((nbias * plan.per, heads, n, n), dtype=torch.float32,
                           device=qkv.device)
        scale_part = torch.empty((nbias * plan.per, heads), dtype=torch.float32,
                                 device=qkv.device)
        fn = _build.kernel("window_attention_cos_bwd", _COS_BWD_ARGTYPES)
        status = fn(qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(), dout.data_ptr(),
                    dqkv.data_ptr(), part.data_ptr(), scale_part.data_ptr(), w, n, heads,
                    nbias, plan.per, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "window_attention_cos_bwd")
    window_attention_cos_bwd.launches += 1
    window_attention_cos_bwd.stagings += plan.blocks
    return dqkv, part.sum(dim=0), scale_part.sum(dim=0)


class WindowAttentionFn(torch.autograd.Function):
    """``apply(qkv, rel_bias, mask, heads, scale=None)``: K4-fwd forward, K4-bwd
    backward. ``rel_bias [H, N, N]`` gets the fp32 sum of ds over the
    windows; the constant ``mask [nW, N, N]`` (or None) gets none. With
    ``scale [H]`` (fp32) the cosine form runs, and ``scale`` gets its
    gradient."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, mask, heads, scale=None):
        bias = combined_bias(rel_bias, mask)
        ctx.heads = heads
        if scale is None:
            ctx.save_for_backward(qkv, bias)
            return window_attention_fwd(qkv, bias, heads)
        scale = scale.float().contiguous()
        ctx.save_for_backward(qkv, bias, scale)
        return window_attention_cos_fwd(qkv, bias, scale, heads)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.saved_tensors[0].dtype).contiguous()
        if len(ctx.saved_tensors) == 2:
            qkv, bias = ctx.saved_tensors
            dqkv, dbias = window_attention_bwd(qkv, bias, ctx.heads, g)
            return dqkv, dbias, None, None, None
        qkv, bias, scale = ctx.saved_tensors
        dqkv, dbias, dscale = window_attention_cos_bwd(qkv, bias, scale, ctx.heads, g)
        return dqkv, dbias, None, None, dscale


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
