"""Swin Transformer image towers: v1 with sparse experts (Swin-MoE), and v2.

Counterpart of ``iterated_learning_for_vlm_tpu/models/swin.py`` for the
configurations ``clip_swinMoE_B``, ``clip_swinB_v2`` and
``clip_fdt_swinB_v2`` build:

- v1 (:class:`WindowAttention`): pre-norm blocks, ``x + attn(norm1(x))``,
  scaled dot-product window attention with a learned relative-position-bias
  table per block; patch merging takes the LayerNorm, then a bias-free
  reduction. The MLP of the listed blocks may be a top-1 mixture of experts
  (:class:`MoEMlp`), whose load-balancing term the tower returns as
  ``moe_aux``.
- v2 (:class:`WindowAttentionV2`): res-post-norm blocks, ``x + norm1(attn(x))``;
  cosine window attention (q and k rows L2-normalised, a learned per-head
  ``logit_scale`` clamped at ln 100 inside the exp) with a continuous
  position bias: a 2 -> 512 -> H MLP (``cpb_mlp``) over log-spaced relative
  offsets, ``16 sigmoid`` of its output; patch merging takes the reduction,
  then the LayerNorm.

Both: cyclic shifts on odd blocks with the -100 shift mask, the final
LayerNorm, a mean pool and the projection. The Swin-MLP token mix is not
ported.

Module names follow the Microsoft Swin layout (``patch_embed.proj``,
``layers.{s}.blocks.{b}.attn.qkv``, ``attn.logit_scale``, ``attn.cpb_mlp.{0,2}``,
``layers.{s}.downsample.reduction``, ``norm``), and
``tools/torch_checkpoint.py`` maps each onto its flax path
(``stage{s}_block{b}/...``, ``merge{s}/...``). Parameters are fp32; each
layer computes in the tower's ``dtype``, as the flax modules do, but the
position-bias MLP, which the JAX module computes in fp32 whatever the dtype.

Window attention takes K4 (``ops/window_attention.py``; the v2 blocks its
cosine form) on any device but the CPU; K4 raises on a call it cannot take
(it takes bf16, head width 32 and N <= 144). On the CPU it is the plain
route, the JAX formulation op for op. Window partition, reverse and the
cyclic shift are torch reshapes and rolls.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import window_attention as wa
from ..utils.profiling import span
from .initializers import scaled_normal, torch_kaiming_uniform
from .layers import LayerNorm, Linear


@dataclass(frozen=True)
class SwinConfig:
    input_resolution: int = 224
    patch_size: int = 4
    window_size: int = 7
    embed_dim: int = 128  # stage-0 channels
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: float = 4.0
    v2: bool = False
    output_dim: int = 512  # CLIP projection dim
    num_experts: int = 0
    moe_stages: Tuple[int, ...] = (2, 3)
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    mlp_mix: bool = False
    # explicit per-stage MoE block indices; overrides the odd-block rule
    moe_blocks: Optional[Tuple[Tuple[int, ...], ...]] = None

    def is_moe(self, stage: int, block: int) -> bool:
        if self.num_experts <= 0:
            return False
        if self.moe_blocks is not None:
            return block in self.moe_blocks[stage]
        return stage in self.moe_stages and block % 2 == 1


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B * H/ws * W/ws, ws^2, C]``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class LinearNoBias(nn.Module):
    """A bias-free flax ``nn.Dense``: fp32 ``weight [out, in]``, product in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))

    def init_weights(self, generator=None):
        torch_kaiming_uniform(self.weight, generator)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class WindowAttention(nn.Module):
    """Multi-head attention inside each ws x ws window with a learned
    relative-position bias per head (a ``[(2 ws - 1)^2, H]`` table)."""

    def __init__(self, dim: int, heads: int, window_size: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads = heads
        self.window_size = window_size
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, heads, device=device))
        self.proj = Linear(dim, dim, dtype=dtype, device=device)
        index = torch.from_numpy(wa.relative_position_index(window_size)).to(device)
        self.register_buffer("relative_position_index", index, persistent=False)

    def init_weights(self, generator=None):
        torch_kaiming_uniform(self.qkv.weight, generator)
        scaled_normal(self.relative_position_bias_table, 0.02, generator)
        torch_kaiming_uniform(self.proj.weight, generator)
        with torch.no_grad():
            self.qkv.bias.zero_()
            self.proj.bias.zero_()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [nW * B, N, C]``, ``mask [nW, N, N]`` fp32 or None -> ``[nW * B, N, C]``."""
        qkv = self.qkv(x)
        rel_bias = wa.RelativePositionBias.apply(self.relative_position_bias_table,
                                                 self.relative_position_index, self.window_size)
        if x.device.type == "cpu":
            out = self._plain(qkv, rel_bias, mask)
        else:
            out = wa.WindowAttentionFn.apply(qkv.contiguous(), rel_bias, mask, self.heads)
        return self.proj(out)

    def _plain(self, qkv, rel_bias, mask):
        """The JAX formulation: fp32 logits + bias (+ mask), fp32 softmax cast
        to ``dtype``, the value product in ``dtype``."""
        w, n, three_c = qkv.shape
        h = self.heads
        q, k, v = (t.reshape(w, n, h, -1) for t in qkv.split(three_c // 3, dim=-1))
        attn = torch.einsum("wqhc,wkhc->whqk", q.float(), k.float()) * q.shape[-1] ** -0.5
        attn = attn + rel_bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(-1, nw, h, n, n) + mask[None, :, None]).reshape(w, h, n, n)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        return torch.einsum("whqk,wkhc->wqhc", attn, v).reshape(w, n, three_c // 3)


LOGIT_SCALE_MAX = math.log(100.0)  # the v2 attention's clamp of its logit scale
CPB_HIDDEN = 512  # the position-bias MLP's hidden width


def cpb_coords(ws: int) -> np.ndarray:
    """``[(2 ws - 1)^2, 2]`` fp32: the log-spaced offsets ``sign(d) ln(1 + |d|)
    / ln 8`` of each relative-position table row (dy, dx), in the row order of
    :func:`ops.window_attention.relative_position_index` (the JAX module's
    input, taken per table row instead of per pair)."""
    d = np.arange(-(ws - 1), ws, dtype=np.float64)
    grid = np.stack(np.meshgrid(d, d, indexing="ij"), axis=-1).reshape(-1, 2)
    return (np.sign(grid) * np.log1p(np.abs(grid)) / np.log(8.0)).astype(np.float32)


class WindowAttentionV2(nn.Module):
    """Swin V2 window attention: cosine logits times the head's
    ``exp(min(logit_scale, ln 100))``, plus ``16 sigmoid(cpb_mlp(offsets))``.

    The MLP runs on the ``(2 ws - 1)^2`` table of offsets, and the
    ``[H, N, N]`` bias is gathered from it by ``RelativePositionBias``: the
    JAX module's per-pair MLP computes the same value for every pair of a
    row, at ``N^2 / (2 ws - 1)^2`` times the rows (39 at ws 12)."""

    def __init__(self, dim: int, heads: int, window_size: int, dtype=torch.float32,
                 device=None, stage: int = 0, block: int = 0):
        super().__init__()
        self.heads = heads
        self.window_size = window_size
        self.dtype = dtype
        self.stage, self.block = stage, block
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.logit_scale = nn.Parameter(torch.full((heads, 1, 1), math.log(10.0), device=device))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN, device=device), nn.ReLU(),
                                     nn.Linear(CPB_HIDDEN, heads, bias=False, device=device))
        self.proj = Linear(dim, dim, dtype=dtype, device=device)
        index = torch.from_numpy(wa.relative_position_index(window_size)).to(device)
        self.register_buffer("relative_position_index", index, persistent=False)
        coords = torch.from_numpy(cpb_coords(window_size)).to(device)
        self.register_buffer("cpb_coords", coords, persistent=False)

    def init_weights(self, generator=None):
        torch_kaiming_uniform(self.qkv.weight, generator)
        torch_kaiming_uniform(self.proj.weight, generator)
        for fc in (self.cpb_mlp[0], self.cpb_mlp[2]):
            torch_kaiming_uniform(fc.weight, generator)
        with torch.no_grad():
            self.qkv.bias.zero_()
            self.proj.bias.zero_()
            self.cpb_mlp[0].bias.zero_()
            self.logit_scale.fill_(math.log(10.0))

    def position_bias(self) -> torch.Tensor:
        """``[H, N, N]`` fp32: ``16 sigmoid`` of the MLP over the offsets."""
        with span("swin.cpb", stage=self.stage, block=self.block,
                  rows=self.cpb_coords.shape[0], heads=self.heads):
            table = 16.0 * torch.sigmoid(self.cpb_mlp(self.cpb_coords))
            return wa.RelativePositionBias.apply(table, self.relative_position_index,
                                                 self.window_size)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [nW * B, N, C]``, ``mask [nW, N, N]`` fp32 or None -> ``[nW * B, N, C]``."""
        qkv = self.qkv(x)
        rel_bias = self.position_bias()
        scale = torch.exp(torch.clamp_max(self.logit_scale, LOGIT_SCALE_MAX))
        if x.device.type == "cpu":
            out = self._plain(qkv, rel_bias, mask, scale)
        else:
            out = wa.WindowAttentionFn.apply(qkv.contiguous(), rel_bias, mask, self.heads,
                                             scale.reshape(-1))
        return self.proj(out)

    def _plain(self, qkv, rel_bias, mask, scale):
        """The JAX formulation: q and k normalised in ``dtype``, their fp32
        product times the scale, + bias (+ mask), fp32 softmax cast to
        ``dtype``, the value product in ``dtype``."""
        w, n, three_c = qkv.shape
        h = self.heads
        q, k, v = (t.reshape(w, n, h, -1) for t in qkv.split(three_c // 3, dim=-1))
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.einsum("wqhc,wkhc->whqk", q.float(), k.float()) * scale
        attn = attn + rel_bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(-1, nw, h, n, n) + mask[None, :, None]).reshape(w, h, n, n)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        return torch.einsum("whqk,wkhc->wqhc", attn, v).reshape(w, n, three_c // 3)


class Mlp(nn.Module):
    """The dense block MLP: fc1, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Linear(hidden, dim, dtype=dtype, device=device)

    def init_weights(self, generator=None):
        for fc in (self.fc1, self.fc2):
            torch_kaiming_uniform(fc.weight, generator)
            with torch.no_grad():
                fc.bias.zero_()

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class MoEMlp(nn.Module):
    """Top-1 gated mixture of experts (JAX ``MoEMlp``, GShard/Switch).

    The gate is an fp32 bias-free product and softmax; each token goes to
    its most probable expert, weighted by that probability. Each expert takes
    ``capacity = max(1, ceil(cf * T / E))`` tokens of the ``T`` in the call,
    in token order; the rest are dropped (their output is 0, so the residual
    carries them). ``aux = E * sum(mean(probs) * share routed)`` over the
    experts, from the routing before the capacity.

    Dispatch and combine are index ops: each kept token's slot
    ``expert * capacity + position`` in a zero-padded ``[E * capacity, d]``
    buffer, filled by one ``index_put`` and read back by one ``index_select``
    (whose backward adds each kept token's row once, into distinct rows), so no
    ``[T, E, capacity]`` one-hot tensor is built. The experts run as one
    capacity-padded batched product over ``[E, capacity, d]`` (``baddbmm``,
    expert kernels stacked ``[E, d, h]`` as in JAX).

    ``counters`` is a device int64 tensor of four running sums, updated
    without a host sync: tokens routed, tokens kept, capacity slots computed,
    and the largest expert's load (tokens routed to it, before the capacity)."""

    def __init__(self, dim: int, hidden: int, num_experts: int, capacity_factor: float = 1.25,
                 dtype=torch.float32, device=None, layer: int = 0):
        super().__init__()
        self.dim, self.hidden, self.num_experts = dim, hidden, num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.layer = layer
        e = num_experts
        self.gate = nn.Linear(dim, e, bias=False, device=device)
        self.w1 = nn.Parameter(torch.empty(e, dim, hidden, device=device))
        self.b1 = nn.Parameter(torch.zeros(e, 1, hidden, device=device))
        self.w2 = nn.Parameter(torch.empty(e, hidden, dim, device=device))
        self.b2 = nn.Parameter(torch.zeros(e, 1, dim, device=device))
        self.counters: Optional[torch.Tensor] = None

    def init_weights(self, generator=None):
        # the JAX initializer's fan-in of a stacked [E, in, out] kernel is E * in
        scaled_normal(self.gate.weight, 0.02, generator)
        with torch.no_grad():
            for w in (self.w1, self.w2):
                bound = 1.0 / math.sqrt(w.shape[0] * w.shape[1])
                w.uniform_(-bound, bound, generator=generator)
            self.b1.zero_()
            self.b2.zero_()

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(self.capacity_factor * tokens / self.num_experts))

    def forward(self, x: torch.Tensor):
        b, l, d = x.shape
        e, dt = self.num_experts, self.dtype
        tokens = x.reshape(b * l, d)
        t = tokens.shape[0]
        cap = self.capacity(t)
        attrs = dict(layer=self.layer, tokens=t, capacity=cap)
        with span("moe.route", **attrs):
            probs = torch.softmax(F.linear(tokens.float(), self.gate.weight), dim=-1)  # [T, E]
            gate, expert = probs.max(dim=-1)
            # [E, T]: the running count along the tokens is an inner-axis scan
            onehot = (torch.arange(e, device=x.device)[:, None] == expert[None, :]).int()
            load = onehot.sum(dim=1)
            aux = e * torch.sum(probs.mean(dim=0) * (load.float() / t))
            position = onehot.cumsum(dim=1).gather(0, expert[None]).squeeze(0) - 1  # its place
            keep = position < cap
            # a dropped token's slot is the spare row e * cap, never read back
            slot = torch.where(keep, expert * cap + position, e * cap)
        with span("moe.dispatch", **attrs):
            expert_in = tokens.new_zeros(e * cap + 1, d, dtype=dt).index_put(
                (slot,), tokens.to(dt))[:-1]
        with span("moe.experts", **attrs):
            h = torch.baddbmm(self.b1.to(dt), expert_in.reshape(e, cap, d), self.w1.to(dt))
            out = torch.baddbmm(self.b2.to(dt), F.gelu(h), self.w2.to(dt)).reshape(e * cap, d)
        with span("moe.combine", **attrs):
            out = torch.cat([out, out.new_zeros(1, d)])
            y = out.index_select(0, slot) * gate.to(dt)[:, None]
        self._count(t, e * cap, keep, load)
        return y.reshape(b, l, d), aux

    @torch.no_grad()
    def _count(self, routed: int, slots: int, keep: torch.Tensor, load: torch.Tensor) -> None:
        """Add to ``counters`` on the device (three launches, no host sync)."""
        if self.counters is None or self.counters.device != keep.device:
            self.counters = torch.zeros(4, dtype=torch.int64, device=keep.device)
        self.counters[0] += routed
        self.counters[2] += slots
        self.counters[1::2] += torch.stack((keep.sum(), load.max()))


class SwinBlock(nn.Module):
    """Pre-norm v1 block: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``;
    res-post-norm v2 block (``v2``): ``x + norm1(attn(x))``, then
    ``x + norm2(mlp(x))``. Odd blocks shift the windows by ws // 2 (none when
    one window covers the map)."""

    def __init__(self, dim: int, heads: int, resolution: int, window_size: int, shift: int,
                 mlp_ratio: float, dtype=torch.float32, device=None, num_experts: int = 0,
                 capacity_factor: float = 1.25, stage: int = 0, layer: int = 0,
                 v2: bool = False, block: int = 0):
        super().__init__()
        self.resolution = resolution
        self.window_size = ws = min(window_size, resolution)
        self.shift = shift if ws < resolution else 0
        self.stage = stage
        self.v2 = v2
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = (WindowAttentionV2(dim, heads, ws, dtype=dtype, device=device, stage=stage,
                                       block=block)
                     if v2 else WindowAttention(dim, heads, ws, dtype=dtype, device=device))
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.moe = num_experts > 0
        self.mlp = (MoEMlp(dim, hidden, num_experts, capacity_factor, dtype=dtype, device=device,
                           layer=layer)
                    if self.moe else Mlp(dim, hidden, dtype=dtype, device=device))
        mask = (torch.from_numpy(wa.shift_mask(resolution, ws, self.shift)).to(device)
                if self.shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        hw, ws, shift = self.resolution, self.window_size, self.shift
        img = x.reshape(b, hw, hw, c)
        if shift:
            img = torch.roll(img, (-shift, -shift), dims=(1, 2))
        wins = window_partition(img, ws)
        with span("swin.window_attn", stage=self.stage, windows=wins.shape[0], n=ws * ws,
                  form="cosine" if self.v2 else "dot"):
            wins = self.attn(wins, self.attn_mask)
        img = window_reverse(wins, ws, hw, hw)
        if shift:
            img = torch.roll(img, (shift, shift), dims=(1, 2))
        return img.reshape(b, l, c)

    def _mlp(self, x: torch.Tensor):
        if self.moe:
            return self.mlp(x)
        return self.mlp(x), None

    def forward(self, x: torch.Tensor):
        if self.v2:
            x = x + self.norm1(self._attend(x))
            y, aux = self._mlp(x)
            return x + self.norm2(y), aux
        x = x + self._attend(self.norm1(x))
        y, aux = self._mlp(self.norm2(x))
        return x + y, aux


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated (x0, x1, x2, x3 as Swin orders them), then
    a LayerNorm and a bias-free reduction to twice the channels (v1), or the
    reduction and then a LayerNorm of its output (v2)."""

    def __init__(self, dim: int, resolution: int, dtype=torch.float32, device=None,
                 v2: bool = False):
        super().__init__()
        self.resolution = resolution
        self.v2 = v2
        self.norm = LayerNorm(2 * dim if v2 else 4 * dim, dtype=dtype, device=device)
        self.reduction = LinearNoBias(4 * dim, 2 * dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        hw = self.resolution
        img = x.reshape(b, hw // 2, 2, hw // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        img = img.reshape(b, (hw // 2) ** 2, 4 * c)
        if self.v2:
            return self.norm(self.reduction(img))
        return self.reduction(self.norm(img))


class PatchEmbed(nn.Module):
    """Conv patch embed with a bias (trained, unlike the ViT's ``conv1``), then
    LayerNorm. ``proj.weight`` is OIHW; images arrive NHWC."""

    def __init__(self, dim: int, patch_size: int, dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size, device=device)
        self.norm = LayerNorm(dim, dtype=dtype, device=device)

    def init_weights(self, generator=None):
        torch_kaiming_uniform(self.proj.weight, generator)
        with torch.no_grad():
            self.proj.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(images.to(dt).permute(0, 3, 1, 2), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.patch_size)
        b, c = y.shape[:2]
        return self.norm(y.reshape(b, c, -1).transpose(1, 2))


class BasicLayer(nn.Module):
    """One stage: its blocks, then the patch merging (all but the last stage)."""

    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """The tower: ``forward(images [B, H, W, 3])`` -> ``embed`` [B, E],
    ``patches`` [B, res^2, C] (after the final norm), ``pooled_raw`` [B, C]
    and, with experts, ``moe_aux`` (fp32, summed over the MoE blocks)."""

    def __init__(self, cfg: SwinConfig, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.mlp_mix:
            raise NotImplementedError("the Swin-MLP token mix is not ported to the PyTorch "
                                      "package; ported: Swin v1, Swin-MoE and Swin v2")
        if cfg.num_experts > 0 and cfg.moe_top_k != 1:
            raise NotImplementedError(f"moe_top_k={cfg.moe_top_k}: the port routes top-1")
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size, dtype=dtype, device=device)
        res = cfg.input_resolution // cfg.patch_size
        dim = cfg.embed_dim
        layers, moe_layer = [], 0
        for stage, depth in enumerate(cfg.depths):
            blocks = []
            for blk in range(depth):
                moe = cfg.is_moe(stage, blk)
                blocks.append(SwinBlock(
                    dim, cfg.num_heads[stage], res, cfg.window_size,
                    0 if blk % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio, dtype=dtype,
                    device=device, num_experts=cfg.num_experts if moe else 0,
                    capacity_factor=cfg.capacity_factor, stage=stage, layer=moe_layer,
                    v2=cfg.v2, block=blk))
                moe_layer += moe
            last = stage == len(cfg.depths) - 1
            layers.append(BasicLayer(
                blocks, None if last else PatchMerging(dim, res, dtype=dtype, device=device,
                                                       v2=cfg.v2)))
            if not last:
                res //= 2
                dim *= 2
        self.layers = nn.ModuleList(layers)
        self.num_features = dim
        self.norm = LayerNorm(dim, dtype=dtype, device=device)
        self.proj = nn.Parameter(torch.empty(dim, cfg.output_dim, device=device))

    def init_weights(self, generator=None):
        scaled_normal(self.proj, self.num_features ** -0.5, generator)

    def moe_layers(self):
        return [m for m in self.modules() if isinstance(m, MoEMlp)]

    def forward(self, images: torch.Tensor) -> dict:
        x = self.patch_embed(images)
        moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            for block in layer.blocks:
                x, aux = block(x)
                if aux is not None:
                    moe_aux = moe_aux + aux
            if layer.downsample is not None:
                x = layer.downsample(x)
        x = self.norm(x)
        pooled = x.float().mean(dim=1).to(self.dtype)
        out = {"embed": pooled @ self.proj.to(self.dtype), "patches": x, "pooled_raw": pooled}
        if self.cfg.num_experts > 0:
            out["moe_aux"] = moe_aux
        return out


def _override(cfg: SwinConfig, kw) -> SwinConfig:
    """Structural overrides from the ``image_encode`` block (JAX ``_override``):
    any :class:`SwinConfig` field but ``embed_dim`` / ``output_dim``, which
    keep the factory's meaning (the CLIP embed dim); other keys, such as the
    towers' shared attention knobs, are ignored."""
    valid = {f.name for f in fields(SwinConfig)} - {"embed_dim", "output_dim"}
    over = {}
    for k, v in kw.items():
        if k not in valid:
            continue
        if k == "moe_blocks" and v is not None:
            v = tuple(tuple(b for b in stage if b >= 0) for stage in v)
        over[k] = tuple(v) if isinstance(v, list) else v
    return replace(cfg, **over) if over else cfg


def swin_moe_b(embed_dim=512, num_experts=8, moe_top_k=1, capacity_factor=1.25,
               moe_stages=(2, 3), **kw) -> SwinConfig:
    """Swin-MoE base (JAX ``swin_moe_b``): embed 128, depths (2, 2, 18, 2),
    heads (4, 8, 16, 32), pre-norm; experts on the odd blocks of stages 2
    and 3 unless ``moe_blocks`` places them."""
    return _override(
        SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                   v2=False, output_dim=embed_dim, num_experts=num_experts,
                   moe_top_k=moe_top_k, capacity_factor=capacity_factor,
                   moe_stages=tuple(moe_stages)), kw)


def swin_b_v2(embed_dim=512, **kw) -> SwinConfig:
    """Swin V2-B (JAX ``swin_b_v2``): embed 128, depths (2, 2, 18, 2), heads
    (4, 8, 16, 32), res-post-norm blocks with cosine attention."""
    return _override(SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                                v2=True, output_dim=embed_dim), kw)
