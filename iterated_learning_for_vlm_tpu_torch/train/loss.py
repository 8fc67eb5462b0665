"""Contrastive loss: symmetric InfoNCE over the global batch.

Counterpart of ``iterated_learning_for_vlm_tpu/train/loss.py``
``clip_info_nce`` (reference ``ClipInfoCELoss``): image->text and
text->image cross entropy against ``arange(B)`` labels, averaged, divided by
``reference_scale`` (``world_size`` reproduces the reference's gradient
scale), with the image->text top-1/top-5 accuracy. The explicit-collective
form ``clip_info_nce_sharded`` waits for data parallelism.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def topk_acc(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Share of rows whose label ranks in the top-k logits, in [0, 100].

    Ties count AGAINST the label (JAX ``_topk_acc``): under representation
    collapse every logit is equal, and a tie-friendly rank would report 100%
    accuracy on garbage."""
    label_logit = logits.gather(-1, labels[:, None])
    is_label = F.one_hot(labels, logits.shape[-1]).bool()
    rank = (logits > label_logit).sum(-1) + ((logits == label_logit) & ~is_label).sum(-1)
    return 100.0 * (rank < k).float().mean()


def clip_info_nce(image_embed: torch.Tensor, text_embed: torch.Tensor,
                  logit_scale: torch.Tensor, reference_scale: float = 1.0):
    """``(loss, {"acc1", "acc5"})`` for L2-normalised ``[B, D]`` embeddings
    and the (exp'd, clamped) scalar ``logit_scale``."""
    b = image_embed.shape[0]
    logits_i = (image_embed @ text_embed.t()) * logit_scale
    logits_t = (text_embed @ image_embed.t()) * logit_scale
    labels = torch.arange(b, device=image_embed.device)
    loss_i = F.cross_entropy(logits_i.float(), labels)
    loss_t = F.cross_entropy(logits_t.float(), labels)
    loss = 0.5 * (loss_i + loss_t) / reference_scale
    with torch.no_grad():
        metrics = {"acc1": topk_acc(logits_i, labels, 1), "acc5": topk_acc(logits_i, labels, 5)}
    return loss, metrics
