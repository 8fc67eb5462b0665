"""Transformer primitives of the CLIP towers.

Counterpart of ``iterated_learning_for_vlm_tpu/models/layers.py``, with the
module names of the reference PyTorch layout (``attn.in_proj_weight``,
``mlp.c_fc``, ``ln_1`` ...) so a ``state_dict`` maps onto the JAX param tree
through ``tools/torch_checkpoint.py``. Parameters are fp32; each layer
computes in its ``dtype`` (bf16 for serving), as the flax modules do.

- ``LayerNorm`` normalises in fp32 and casts back (eps 1e-5).
- ``MultiheadAttention`` has three routes, with the JAX precedence:
  ``use_flash`` takes flash attention (``ops/flash_attention.py``, K3-fwd and
  K3-bwd through ``FlashAttention``; fp32 value product; the causal mask as a
  flag, no bias tensor) and turns the fused route off; else ``fused_attn`` at
  S <= 128 takes the tiny-sequence kernels (``ops/fused_attention.py``, K2-fwd
  and K2-bwd through ``TinyAttention``, which gives ``in_proj_bias`` its
  gradient); else the plain path. The fused and plain routes have the same
  numerics (fp32 logits and softmax, value product in the operand dtype).
  :func:`attention_route` decides from the input's dtype and shape: on a CUDA
  device a kernel route needs bf16 and head width 64 (and S <= 1024 for K3),
  else the call takes the plain path and ``attention_route.plain_routes``
  counts it. A call that asks for the attention probabilities
  (``return_weights``) takes the plain path, as in JAX, and is not counted:
  no kernel route was refused.
- ``Transformer`` is a plain ``nn.ModuleList``: the JAX scan, remat and unroll
  are XLA compile strategies, so their knobs are accepted and ignored, as are
  the TPU tiling knobs of the fused attention kernel. It can also return each
  layer's output and head-averaged attention probabilities, stacked.

Every module with parameters of its own has ``init_weights(generator)``;
``init_module_tree`` runs them in registration order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fl
from ..ops import fused_attention as fa
from ..ops.flash_attention import flash_attention
from ..ops.fused_attention import attention_reference, causal_bias, fused_tiny_attention
from .initializers import scaled_normal, torch_bias_uniform


def init_module_tree(root: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every parameter of ``root`` from ``generator``, in module order."""
    for m in root.modules():
        init = getattr(m, "init_weights", None)
        if init is not None:
            init(generator)
    return root


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 whatever the activation dtype, cast to ``dtype``."""

    def __init__(self, width: int, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))

    def init_weights(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class Linear(nn.Module):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)`` in torch layout:
    fp32 ``weight [out, in]`` and ``bias``, product in ``dtype``. The owning
    module draws its weights."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def packed_in_proj(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype,
                   add_bias: bool = True):
    """The packed QKV projection (JAX ``PackedInProj``): ``x @ weight.T`` in
    ``dtype`` (``weight`` is torch's ``in_proj_weight [3D, D]``). With
    ``add_bias=False`` it returns the pre-bias product, for the fused kernel to
    add the bias itself. Returns ``(y, bias)``."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    if add_bias:
        y = y + bias.to(dtype)
    return y, bias


def attention_route(use_flash: bool, fused_attn: bool, seq: int, head_dim: int, dtype,
                    device) -> str:
    """The route of one attention call: "flash" (K3), "fused" (K2) or "plain".

    ``fused_attn`` keeps the JAX rule, S <= 128 on every device
    (``iterated_learning_for_vlm_tpu/models/layers.py:124``). On a CUDA
    device a kernel also needs what it can take: bf16 and head width 64, and
    S <= 1024 for K3 (a CPU tensor takes the kernels' plain versions, which
    take anything). A knob that asked for a kernel and got the plain path
    adds one to ``attention_route.plain_routes``."""
    on_cpu = torch.device(device).type == "cpu"
    if use_flash:
        route = "flash"
        takes = on_cpu or (dtype == torch.bfloat16 and head_dim == fl.HEAD_DIM
                           and seq <= fl.MAX_SEQ)
    elif fused_attn:
        route = "fused"
        takes = seq <= fa.MAX_SEQ and (on_cpu or (dtype == torch.bfloat16
                                                  and head_dim == fa.HEAD_DIM))
    else:
        return "plain"
    if takes:
        return route
    attention_route.plain_routes += 1
    return "plain"


attention_route.plain_routes = 0


class MultiheadAttention(nn.Module):
    """Packed-QKV self-attention with torch ``nn.MultiheadAttention``'s
    parameter names. ``use_flash`` selects flash attention (K3) over the
    fused tiny-sequence route (K2)."""

    def __init__(self, width: int, heads: int, attn_std: float = 0.02,
                 proj_std: float = 0.02, dtype=torch.float32, use_flash: bool = False,
                 fused_attn: bool = False, device=None):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of heads {heads}")
        self.heads = heads
        self.attn_std = attn_std
        self.proj_std = proj_std
        self.dtype = dtype
        self.use_flash = use_flash
        self.fused_attn = fused_attn
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = Linear(width, width, dtype=dtype, device=device)

    def init_weights(self, generator=None):
        scaled_normal(self.in_proj_weight, self.attn_std, generator)
        scaled_normal(self.out_proj.weight, self.proj_std, generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor, causal: bool = False, return_weights: bool = False):
        """``x [B, S, D]`` -> ``[B, S, D]``; with ``return_weights``, the pair
        ``(out, weights)``: the plain path's fp32 probabilities averaged over
        heads, ``[B, S, S]``."""
        b, s, d = x.shape
        if return_weights:  # the plain path, as in JAX; no kernel route was refused
            qkv, _ = packed_in_proj(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
            out, weights = attention_reference(qkv, self.heads,
                                               causal_bias(s, x.device) if causal else None,
                                               return_weights=True)
            return self.out_proj(out), weights
        route = attention_route(self.use_flash, self.fused_attn, s, d // self.heads,
                                self.dtype, x.device)
        qkv, in_bias = packed_in_proj(x, self.in_proj_weight, self.in_proj_bias,
                                      self.dtype, add_bias=route != "fused")
        if route == "fused":
            out = fused_tiny_attention(qkv, self.heads, causal=causal,
                                       qkv_bias=in_bias.to(qkv.dtype))
        elif route == "flash":  # [B, S, H, hd] views of the packed columns, no copy
            q, k, v = (t.reshape(b, s, self.heads, d // self.heads)
                       for t in qkv.split(d, dim=-1))
            out = flash_attention(q, k, v, causal=causal)
            out = out.reshape(b, s, d)
        else:
            out = attention_reference(qkv, self.heads,
                                      causal_bias(s, x.device) if causal else None)
        return self.out_proj(out)


class MLP(nn.Module):
    """The 4x QuickGELU MLP."""

    def __init__(self, width: int, fc_std: float, proj_std: float, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.width = width
        self.fc_std = fc_std
        self.proj_std = proj_std
        self.c_fc = Linear(width, 4 * width, dtype=dtype, device=device)
        self.c_proj = Linear(4 * width, width, dtype=dtype, device=device)

    def init_weights(self, generator=None):
        scaled_normal(self.c_fc.weight, self.fc_std, generator)
        torch_bias_uniform(self.c_fc.bias, self.width, generator)
        scaled_normal(self.c_proj.weight, self.proj_std, generator)
        torch_bias_uniform(self.c_proj.bias, 4 * self.width, generator)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + pre-LN MLP; ``causal`` masks keys above the diagonal."""

    def __init__(self, width: int, heads: int, attn_std: float, proj_std: float,
                 fc_std: float, causal: bool = False, dtype=torch.float32,
                 use_flash: bool = False, fused_attn: bool = False, device=None):
        super().__init__()
        self.causal = causal
        self.ln_1 = LayerNorm(width, dtype=dtype, device=device)
        self.attn = MultiheadAttention(width, heads, attn_std, proj_std, dtype=dtype,
                                       use_flash=use_flash, fused_attn=fused_attn,
                                       device=device)
        self.ln_2 = LayerNorm(width, dtype=dtype, device=device)
        self.mlp = MLP(width, fc_std, proj_std, dtype=dtype, device=device)

    def forward(self, x, return_weights: bool = False):
        """``x`` -> the block's output; with ``return_weights``, the pair
        ``(output, head-averaged attention probabilities [B, S, S])``."""
        attn = self.attn(self.ln_1(x), causal=self.causal, return_weights=return_weights)
        if return_weights:
            attn, weights = attn
        x = x + attn
        x = x + self.mlp(self.ln_2(x))
        return (x, weights) if return_weights else x


class Transformer(nn.Module):
    """A stack of residual attention blocks with the CLIP init schedule:
    ``attn_std = width**-0.5``, ``proj_std = width**-0.5 * (2*layers)**-0.5``,
    ``fc_std = (2*width)**-0.5``."""

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False,
                 remat: bool = False, dtype=torch.float32, use_flash: bool = False,
                 fused_attn: bool = False, fused_attn_group: int = 2,
                 fused_attn_sample_group: int = 2, fused_attn_bwd_fuse3: bool = False,
                 fused_attn_group_bwd: Optional[int] = None,
                 fused_attn_sample_group_bwd: Optional[int] = None,
                 attn_layout: str = "bhqk", unroll: bool = False, device=None):
        super().__init__()
        # XLA compile strategies and TPU kernel tilings: no meaning here
        del remat, unroll, attn_layout, fused_attn_group, fused_attn_sample_group
        del fused_attn_bwd_fuse3, fused_attn_group_bwd, fused_attn_sample_group_bwd
        attn_std = width ** -0.5
        proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
        fc_std = (2 * width) ** -0.5
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(width, heads, attn_std, proj_std, fc_std, causal=causal,
                                   dtype=dtype, use_flash=use_flash, fused_attn=fused_attn,
                                   device=device)
            for _ in range(layers)])

    def forward(self, x, return_hidden_states: bool = False,
                return_attn_weights: bool = False):
        """``return_hidden_states`` also returns each layer's output stacked
        as ``[L, B, S, D]``; ``return_attn_weights`` each layer's
        head-averaged attention probabilities as ``[L, B, S, S]``, and then
        the call returns the triple ``(x, hidden_or_None, attn)`` (JAX
        ``Transformer.__call__``)."""
        if not (return_hidden_states or return_attn_weights):
            for block in self.resblocks:
                x = block(x)
            return x
        hidden, attn = [], []
        for block in self.resblocks:
            if return_attn_weights:
                x, w = block(x, return_weights=True)
                attn.append(w)
            else:
                x = block(x)
            hidden.append(x)
        hidden = torch.stack(hidden) if return_hidden_states else None
        if return_attn_weights:
            return x, hidden, torch.stack(attn)
        return x, hidden
