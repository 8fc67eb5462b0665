"""The train step and the eval step.

Counterpart of ``iterated_learning_for_vlm_tpu/train/step.py``. One step is,
in the JAX step's order: forward (CLIP-FDT with its temperature, or the
baseline CLIP), global-batch InfoNCE, backward, gradient clipping, the
logit-scale clamp before the update, ``lr = schedule(step + 1)``, masked
AdamW, the clamp after, the ``logit_scale_param`` delta / EMA / ``constant``
clamps, the codebook hold (CLIP-FDT only), ``step + 1``. Every IL
phase is driven by the state (trainable flags, hold flag) and the
temperature argument, so nothing is rebuilt at a phase change.

PyTorch runs it eagerly and updates in place: the model's parameters, their
``.grad``, and the state's moments, counts and EMA buffer change under
``torch.no_grad``; the step returns only the metrics. During the codebook
hold ``space_dict`` stays trainable (its moments and count advance) and only
its value is overwritten by the snapshot.

Data parallel: given a ``DistributedDataParallel`` wrapper, the step runs
the forward through it (DDP averages the gradients over the ranks during
the backward) and the InfoNCE over the global batch,
``clip_info_nce_sharded``; every rank then takes the same update. The
parameters are read from the wrapped module, so their names (the weight
decay tree, ``state.trainable``, the checkpoint keys) carry no ``module.``
prefix.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from torch.nn.parallel import DistributedDataParallel

from .loss import clip_info_nce, clip_info_nce_sharded
from .optim import adamw_update, clamp_logit_scale, clip_grads
from .train_state import TrainState


def make_train_step(model: torch.nn.Module, schedule: Callable[[int], float],
                    wd_tree: Mapping[str, float], *, is_fdt: bool,
                    grad_clip_type: str = "logit_scale_param_value",
                    grad_clip_value: float = 3.0, grad_clip_max_value: float = 6.0,
                    b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
                    reference_scale: float = 1.0, spectral_norm: bool = False,
                    lipreg_lambda: float = 0.0, group=None):
    """Build ``step(state, batch, sd_temperature) -> metrics`` for ``model``,
    a model or its ``DistributedDataParallel`` wrapper (then ``batch`` holds
    this rank's rows, and ``group`` names the ranks of the loss's gather:
    None, the whole group).

    ``batch``: ``image`` [B, H, W, 3], ``tokens`` int [B, ctx], ``pad_mask``
    [B, ctx] (0 real / -inf pad), on the model's device; ``sd_temperature``
    a float, which only a CLIP-FDT model (``is_fdt``) reads. ``metrics``:
    ``loss``, ``logit_scale``, ``acc1``, ``acc5`` as 0-d device tensors and
    ``lr`` as a float; under DDP ``loss``, ``acc1`` and ``acc5`` are means
    over the ranks."""
    if spectral_norm or lipreg_lambda > 0.0:
        raise NotImplementedError("spectral_norm and lipreg are not ported")
    data_parallel = isinstance(model, DistributedDataParallel)
    params = dict((model.module if data_parallel else model).named_parameters())

    def step(state: TrainState, batch: Dict[str, Any], sd_temperature: float):
        for p in params.values():
            p.grad = None
        kwargs = {"sd_temperature": sd_temperature} if is_fdt else {}
        out = model(batch["image"], batch["tokens"], batch.get("pad_mask"), **kwargs)
        if data_parallel:
            loss, metrics = clip_info_nce_sharded(out["image_embed"], out["text_embed"],
                                                  out["logit_scale"], group=group,
                                                  reference_scale=reference_scale)
            loss.backward()  # this rank's loss; DDP averages the gradients
            loss = metrics.pop("loss")
        else:
            loss, metrics = clip_info_nce(out["image_embed"], out["text_embed"],
                                          out["logit_scale"], reference_scale=reference_scale)
            loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        clip_grads(grads, grad_clip_type, grad_clip_value)

        lr = schedule(state.step + 1)
        ls = params["logit_scale"]
        with torch.no_grad():
            clamp_logit_scale(params, grad_clip_type, grad_clip_value, grad_clip_max_value)
            before_ls = ls.detach().clone()
            adamw_update(grads, state.opt_state, params, lr=lr, wd_tree=wd_tree,
                         trainable=state.trainable, b1=b1, b2=b2, eps=eps)
            clamp_logit_scale(params, grad_clip_type, grad_clip_value, grad_clip_max_value)
            if grad_clip_type == "logit_scale_param":  # bound the change per step
                ls.copy_(torch.clamp(ls, before_ls - grad_clip_value,
                                     before_ls + grad_clip_value))
            elif grad_clip_type == "logit_scale_param_ema":
                buf = state.ema_buffer
                clipped = torch.clamp(ls, buf - grad_clip_value, buf + grad_clip_value)
                state.ema_clip_count = state.ema_clip_count + (clipped != ls).float().sum()
                ls.copy_(clipped)
                state.ema_buffer = 0.9 * buf + 0.1 * ls.mean()
            elif grad_clip_type == "constant":
                ls.copy_(before_ls)
            if is_fdt and state.hold_codebook:
                params["space_dict"].copy_(state.stored_codebook)
        state.step += 1
        return {"loss": loss.detach(), "lr": lr, "logit_scale": ls.detach().mean(), **metrics}

    return step


def make_eval_step(model: torch.nn.Module, *, is_fdt: bool):
    """``eval_step(batch) -> (image_embed, text_embed)``, L2-normalised
    (eps 1e-10) in fp32, for in-training eval and benchmarks: the codebook
    features of CLIP-FDT (``is_fdt``), the tower embeddings of CLIP."""

    @torch.no_grad()
    def eval_step(batch):
        if is_fdt:
            _, img = model.extract_img_sd_ft(batch["image"])
            _, txt = model.extract_txt_sd_ft(batch["tokens"], batch["pad_mask"])
        else:
            img = model.encode_image(batch["image"])
            txt = model.encode_text(batch["tokens"], batch["pad_mask"])["embed"]
        img = img.float()
        txt = txt.float()
        img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-10)
        txt = txt / (torch.linalg.vector_norm(txt, dim=-1, keepdim=True) + 1e-10)
        return img, txt

    return eval_step
