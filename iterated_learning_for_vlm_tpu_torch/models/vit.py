"""Vision transformer tower (CLIP-style).

Counterpart of ``iterated_learning_for_vlm_tpu/models/vit.py``: frozen
bias-free conv patch embed, class token, learned positional embedding,
pre/post LN, linear projection. Images arrive NHWC as in the JAX package; the
conv runs NCHW/OIHW, torch's layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import scaled_normal, torch_kaiming_uniform
from .layers import LayerNorm, Transformer


@dataclass(frozen=True)
class VisionConfig:
    input_resolution: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512
    remat: bool = False
    use_flash: bool = False
    fused_attn: bool = False
    fused_attn_group: int = 2
    fused_attn_sample_group: int = 2
    fused_attn_bwd_fuse3: bool = False
    fused_attn_group_bwd: int | None = None
    fused_attn_sample_group_bwd: int | None = None
    attn_layout: str = "bhqk"
    unroll: bool = False


class FrozenPatchEmbed(nn.Module):
    """Bias-free conv patch embed, permanently frozen (``requires_grad=False``,
    the reference's ``freeze_conv1=True``). ``weight`` is OIHW."""

    def __init__(self, features: int, patch_size: int, dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(  # RGB input
            torch.empty(features, 3, patch_size, patch_size, device=device),
            requires_grad=False)

    def init_weights(self, generator=None):
        torch_kaiming_uniform(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, H/p, W/p, features] (NHWC in and out)."""
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), self.weight.to(self.dtype),
                     stride=self.patch_size)
        return y.permute(0, 2, 3, 1)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        w = cfg.width
        self.conv1 = FrozenPatchEmbed(w, cfg.patch_size, dtype=dtype, device=device)
        self.class_embedding = nn.Parameter(torch.empty(w, device=device))
        grid = cfg.input_resolution // cfg.patch_size
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, w, device=device))
        self.ln_pre = LayerNorm(w, dtype=dtype, device=device)
        self.transformer = Transformer(
            width=w, layers=cfg.layers, heads=cfg.heads, causal=False, remat=cfg.remat,
            dtype=dtype, use_flash=cfg.use_flash, fused_attn=cfg.fused_attn,
            fused_attn_group=cfg.fused_attn_group,
            fused_attn_sample_group=cfg.fused_attn_sample_group,
            fused_attn_bwd_fuse3=cfg.fused_attn_bwd_fuse3,
            fused_attn_group_bwd=cfg.fused_attn_group_bwd,
            fused_attn_sample_group_bwd=cfg.fused_attn_sample_group_bwd,
            attn_layout=cfg.attn_layout, unroll=cfg.unroll, device=device)
        self.ln_post = LayerNorm(w, dtype=dtype, device=device)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim, device=device))

    def init_weights(self, generator=None):
        scale = self.cfg.width ** -0.5
        scaled_normal(self.class_embedding, scale, generator)
        scaled_normal(self.positional_embedding, 0.01, generator)
        scaled_normal(self.proj, scale, generator)

    def tokens(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] NHWC -> transformer output [B, grid^2 + 1, W]. Eager
        PyTorch runs every output it is asked for, so the codebook path calls
        this and skips ln_post and the projections ``forward`` adds."""
        dt = self.dtype
        x = self.conv1(images)
        b, gh, gw, w = x.shape
        x = x.reshape(b, gh * gw, w)
        cls = self.class_embedding.to(dt).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        return self.transformer(self.ln_pre(x))

    def forward(self, images: torch.Tensor) -> dict:
        """images: [B, H, W, 3] NHWC. Returns ``embed`` [B, E], ``patches``
        [B, grid^2, W] (dense tokens BEFORE ln_post, what FDT consumes),
        ``pooled_raw`` [B, W] (CLS after ln_post) and ``patches_proj``."""
        x = self.tokens(images)
        patches = x[:, 1:, :]
        ln_all = self.ln_post(x)
        pooled_raw = ln_all[:, 0, :]
        proj = self.proj.to(self.dtype)
        return {"embed": pooled_raw @ proj, "patches": patches, "pooled_raw": pooled_raw,
                "patches_proj": ln_all[:, 1:, :] @ proj}


# Factory configs mirroring the reference factory dims.
def vit_b32(embed_dim=512, **kw) -> VisionConfig:
    return VisionConfig(**{**dict(patch_size=32, width=768, layers=12, heads=12,
                                  embed_dim=embed_dim), **kw})


def vit_b16(embed_dim=512, **kw) -> VisionConfig:
    """ViT-B/16: 197 tokens at 224 px, past the tiny-sequence kernels' 128, so
    ``use_flash`` is this tower's only kernel route."""
    return VisionConfig(**{**dict(patch_size=16, width=768, layers=12, heads=12,
                                  embed_dim=embed_dim), **kw})
