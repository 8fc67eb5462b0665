"""CLIP dual-encoder model, and the constants and helpers CLIP-FDT shares.

Counterpart of ``iterated_learning_for_vlm_tpu/models/clip.py`` (ViT and
Swin towers): the logit-scale init and clamp, ``l2_normalize``, the
vision-tower dispatch and the baseline :class:`CLIP`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .swin import SwinConfig, SwinTransformer
from .text import TextConfig, TextTransformer
from .vit import VisionConfig, VisionTransformer

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)
LOGIT_SCALE_MAX = 100.0


def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def build_vision_tower(cfg, dtype, device=None):
    if isinstance(cfg, SwinConfig):
        return SwinTransformer(cfg, dtype=dtype, device=device)
    if not isinstance(cfg, VisionConfig):
        raise NotImplementedError(f"vision tower {type(cfg).__name__} is not ported to "
                                  "the PyTorch package yet (ViT and Swin only)")
    return VisionTransformer(cfg, dtype=dtype, device=device)


class CLIP(nn.Module):
    """Dual encoder with L2-normalised embeddings (the image norm without an
    eps, the text norm with 1e-10) and a learnable ``logit_scale``
    (``ln(1/0.07)``, its exponential clamped to <= 100).

    Module names follow the reference checkpoints: ``visual``,
    ``encode_text`` (the text tower) and ``logit_scale``. The text tower's
    name takes the place of the JAX method ``encode_text(tokens, pad_mask)``:
    text embeddings are ``model.encode_text(tokens, pad_mask)["embed"]``, and
    image embeddings ``model.encode_image(images)``. A Swin-MoE tower's
    ``moe_aux`` is passed on in the forward's output; ResNet towers and the
    Swin-MLP blocks are not ported."""

    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg
        self.dtype = dtype
        self.visual = build_vision_tower(vision_cfg, dtype, device)
        self.encode_text = TextTransformer(text_cfg, dtype=dtype, device=device)
        self.logit_scale = nn.Parameter(torch.full((1,), LOGIT_SCALE_INIT, device=device))

    def init_weights(self, generator=None):
        with torch.no_grad():
            self.logit_scale.fill_(LOGIT_SCALE_INIT)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] NHWC -> [B, embed_dim] in the model's dtype."""
        return self.visual(images)["embed"]

    def extract_patch_ft(self, images: torch.Tensor) -> torch.Tensor:
        """Projected patch tokens [B, grid^2, E]: ln_post and ``proj`` applied
        to each patch token (reference ``CLIP.extract_patch_ft``)."""
        return self.visual(images)["patches_proj"]

    def extract_word_ft(self, tokens: torch.Tensor, pad_mask=None):
        """Projected word tokens [B, ctx, E] and the pad mask (reference
        ``CLIP.extract_word_ft``)."""
        return self.encode_text(tokens, pad_mask)["words_proj"], pad_mask

    def forward(self, images, tokens, pad_mask=None):
        vis = self.visual(images)
        text = self.encode_text(tokens, pad_mask)["embed"]
        out = {
            "image_embed": l2_normalize(vis["embed"].float()),
            "text_embed": l2_normalize(text.float(), eps=1e-10),
            "logit_scale": torch.clamp_max(self.logit_scale[0].exp(), LOGIT_SCALE_MAX),
        }
        if "moe_aux" in vis:  # Swin-MoE's load-balancing term, for the loss
            out["moe_aux"] = vis["moe_aux"]
        return out
