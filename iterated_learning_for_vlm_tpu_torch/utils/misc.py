"""Misc training utilities.

A copy of ``iterated_learning_for_vlm_tpu/utils/misc.py`` (reference
``prototype/utils/misc.py``: ``count_params`` 167-188, an analytic transformer
FLOP estimate in place of ``count_flops`` 190-280, ``accuracy`` 464-478,
``mixup`` / ``cutmix`` 536-590, the key-prefix stripping of
``load_state_model`` 490-508). ``count_params`` takes an ``nn.Module`` (its
parameters) or a state dict; the rest works on numpy arrays and is the JAX
package's code unchanged.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
from torch import nn


def count_params(params: Union[nn.Module, Mapping]) -> Dict[str, float]:
    """Total elements and tensor count of a module's parameters or of the
    values of a state dict (tensors or arrays)."""
    leaves = list(params.parameters() if isinstance(params, nn.Module) else params.values())
    total = sum(int(np.prod(tuple(leaf.shape))) for leaf in leaves)
    return {"total": total, "total_M": total / 1e6, "num_tensors": len(leaves)}


def count_transformer_flops(
    seq_len: int, width: int, layers: int, batch: int = 1, causal: bool = False
) -> float:
    """Analytic forward FLOPs of one tower (matmuls only, x2 mul-add)."""
    per_layer = (
        4 * seq_len * width * width * 2  # qkv + out proj
        + 2 * seq_len * seq_len * width * 2  # logits + weighted sum
        + 2 * seq_len * width * 4 * width * 2  # mlp
    )
    return batch * layers * per_layer


def clip_b32_flops_per_pair() -> float:
    """Forward FLOPs per image-text pair for CLIP ViT-B/32 (+ FDT codebook)."""
    vision = count_transformer_flops(50, 768, 12) + 50 * 3 * 32 * 32 * 768 * 2
    text = count_transformer_flops(77, 512, 12, causal=True)
    codebook = (49 + 77) * 512 * 4096 * 2
    return vision + text + codebook


def accuracy(logits: np.ndarray, labels: np.ndarray, topk=(1, 5)) -> Tuple[float, ...]:
    """Top-k accuracy in percent (reference ``accuracy``)."""
    order = np.argsort(-logits, axis=-1)
    out = []
    for k in topk:
        kk = min(k, logits.shape[-1])
        out.append(100.0 * float(np.mean((order[:, :kk] == labels[:, None]).any(1))))
    return tuple(out)


def mixup(images: np.ndarray, labels: np.ndarray, alpha: float,
          rng: np.random.Generator):
    """Batch mixup (reference misc.py:536-560). labels: int -> returns pairs."""
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    perm = rng.permutation(len(images))
    mixed = lam * images + (1 - lam) * images[perm]
    return mixed, labels, labels[perm], lam


def cutmix(images: np.ndarray, labels: np.ndarray, alpha: float,
           rng: np.random.Generator):
    """Batch cutmix (reference misc.py:562-590), NHWC."""
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    perm = rng.permutation(len(images))
    h, w = images.shape[1:3]
    cut_rat = np.sqrt(1.0 - lam)
    ch, cw = int(h * cut_rat), int(w * cut_rat)
    cy, cx = int(rng.integers(h)), int(rng.integers(w))
    y1, y2 = np.clip(cy - ch // 2, 0, h), np.clip(cy + ch // 2, 0, h)
    x1, x2 = np.clip(cx - cw // 2, 0, w), np.clip(cx + cw // 2, 0, w)
    out = images.copy()
    out[:, y1:y2, x1:x2] = images[perm][:, y1:y2, x1:x2]
    lam_adj = 1 - ((y2 - y1) * (x2 - x1) / (h * w))
    return out, labels, labels[perm], lam_adj


def strip_prefix(state: Dict, prefix_strip: str = "module.") -> Dict:
    """Strip checkpoint key prefixes (reference ``load_state_model``; the
    selective-drop ``modify_state`` lives in ``train/checkpoint.py``)."""
    return {
        (k[len(prefix_strip):] if k.startswith(prefix_strip) else k): v
        for k, v in state.items()
    }
