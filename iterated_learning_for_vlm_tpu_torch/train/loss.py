"""Contrastive loss: symmetric InfoNCE over the global batch.

Counterpart of ``iterated_learning_for_vlm_tpu/train/loss.py``
``clip_info_nce`` (reference ``ClipInfoCELoss``): image->text and
text->image cross entropy against ``arange(B)`` labels, averaged, divided by
``reference_scale`` (``world_size`` reproduces the reference's gradient
scale), with the image->text top-1/top-5 accuracy; and its data-parallel
form ``clip_info_nce_sharded`` over the embeddings of every rank, gathered
by :class:`AllGather`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
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


class AllGather(torch.autograd.Function):
    """``[b, D]`` on every rank of ``group`` -> ``[W * b, D]``, rank order, with
    a gradient (the reference's ``AllGather``, ``clip.py:22-42``).

    Forward: one ``all_gather_into_tensor`` into the ``[W * b, D]`` output
    (one collective, no copy). Backward: ``all_reduce(SUM)`` of the incoming
    gradient, then this rank's ``b`` rows: the transpose of the gather, since
    every rank's loss reads every rank's rows (JAX ``clip_info_nce_sharded``:
    "allreduce + slice == transpose of all_gather"). Written here, not taken
    from ``torch.distributed.nn``, whose backward off NCCL needs
    ``all_to_all``, which Gloo lacks. Gloo takes CUDA tensors for both
    collectives, staging them through the host; over NCCL both run inside
    the train step's CUDA graph (``train/step.py``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)  # reduced in place
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        b = grad.shape[0] // dist.get_world_size(ctx.group)
        return grad[ctx.rank * b:(ctx.rank + 1) * b], None


def clip_info_nce_sharded(image_embed: torch.Tensor, text_embed: torch.Tensor,
                          logit_scale: torch.Tensor, group=None, reference_scale: float = 1.0):
    """Data-parallel InfoNCE over the global batch (JAX ``clip_info_nce_sharded``,
    reference ``loss.py:42``): ``(loss, {"loss", "acc1", "acc5"})`` for this
    rank's ``[b, D]`` rows of a global batch of ``W * b`` (``group``: the
    ranks, default the whole group).

    Logits are this rank's rows against every rank's columns, gathered by
    :class:`AllGather`; the labels are ``rank * b + arange(b)``. The first
    ``loss`` is this rank's mean, the one to call ``backward()`` on. Under
    data parallelism, where the train step averages the parameter gradients
    over the W ranks (``train/step.py`` ``GradientAverage``, the average
    ``DistributedDataParallel`` takes), its gradient is exactly that of the
    global-mean loss: each
    rank's backward sums, through the gather, every rank's loss's gradient
    on its own rows, so the average is
    (1/W) Σ_r Σ_s ∂L_s/∂e_r · ∂e_r/∂θ = ∂((1/W) Σ_s L_s)/∂θ.
    The metrics' ``loss``, ``acc1`` and ``acc5`` are means over the ranks
    (JAX's ``pmean``), detached."""
    b = image_embed.shape[0]
    gathered_txt = AllGather.apply(text_embed, group)
    gathered_img = AllGather.apply(image_embed, group)
    logits_i = (image_embed @ gathered_txt.t()) * logit_scale
    logits_t = (text_embed @ gathered_img.t()) * logit_scale
    labels = dist.get_rank(group) * b + torch.arange(b, device=image_embed.device)
    loss_i = F.cross_entropy(logits_i.float(), labels)
    loss_t = F.cross_entropy(logits_t.float(), labels)
    loss = 0.5 * (loss_i + loss_t) / reference_scale
    with torch.no_grad():
        metrics = torch.stack([loss.detach().float(), topk_acc(logits_i, labels, 1),
                               topk_acc(logits_i, labels, 5)])
        dist.all_reduce(metrics, op=dist.ReduceOp.SUM, group=group)
        metrics = metrics / dist.get_world_size(group)
    return loss, {"loss": metrics[0], "acc1": metrics[1], "acc5": metrics[2]}
