"""CLIP constants and helpers shared by the CLIP-FDT model.

Counterpart of the parts of ``iterated_learning_for_vlm_tpu/models/clip.py``
the FDT serving path uses: the logit-scale init and clamp, ``l2_normalize``
and the vision-tower dispatch (ViT only so far). The baseline ``CLIP`` model
is not ported yet.
"""
from __future__ import annotations

import math

import torch

from .vit import VisionConfig, VisionTransformer

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)
LOGIT_SCALE_MAX = 100.0


def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def build_vision_tower(cfg, dtype, device=None):
    if not isinstance(cfg, VisionConfig):
        raise NotImplementedError(f"vision tower {type(cfg).__name__} is not ported to "
                                  "the PyTorch package yet (ViT only)")
    return VisionTransformer(cfg, dtype=dtype, device=device)
