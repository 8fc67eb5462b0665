"""The train step and the eval step.

Counterpart of ``iterated_learning_for_vlm_tpu/train/step.py``. One step is,
in the JAX step's order: forward (CLIP-FDT with its temperature, or the
baseline CLIP), global-batch InfoNCE (plus ``0.01 * moe_aux`` when the
forward returns a Swin-MoE tower's load-balancing term), backward, gradient clipping, the
logit-scale clamp before the update, ``lr = schedule(step + 1)``, masked
AdamW, the clamp after, the ``logit_scale_param`` delta / EMA / ``constant``
clamps, the codebook hold (CLIP-FDT only), ``step + 1``. Every IL
phase is driven by the state (trainable flags, hold flag) and the
temperature argument, so nothing is rebuilt at a phase change.

PyTorch updates in place: the model's parameters, their ``.grad``, and the
state's moments, counts, EMA buffer and clip count change under
``torch.no_grad``; the step returns only the metrics. During the codebook
hold ``space_dict`` stays trainable (its moments and count advance) and only
its value is overwritten by the snapshot. The host's part of a step comes
first: ``lr``, the AdamW counts and their bias corrections
(``optim.adamw_scalars``), copied to the device in one transfer from pinned
memory, from which the device's part reads them.

On a CUDA device, unless the model is a ``DistributedDataParallel`` wrapper,
the device's part replays through ``step.graphs``, a ``GraphCache``
(``ops/graphs.py``), one graph per :func:`graph_key`. What a replay reads
before it writes (parameters, moments, the scalars, the EMA tensors, the
snapshot, the missing gradients' zeros a key's eager call made) lives
outside the graphs' pool; after a replay each ``.grad`` is a buffer of the
graph. On the CPU, and under DDP, every call runs eagerly.

Data parallel: given a ``DistributedDataParallel`` wrapper, the step runs
the forward through it (DDP averages the gradients over the ranks during
the backward) and the InfoNCE over the global batch,
``clip_info_nce_sharded``; every rank then takes the same update. The
parameters are read from the wrapped module, so their names (the weight
decay tree, ``state.trainable``, the checkpoint keys) carry no ``module.``
prefix.

Under a running ``torch.profiler`` the step opens the span ``train.step``
(attrs ``step``, ``ctx``), over ``train.forward`` (the model and the loss),
``train.backward`` and ``train.update`` (clipping through the codebook hold)
when it runs eagerly or captures, and over ``train.replay`` when it replays,
so every caller of the step gets them (``utils/profiling.py``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping

import torch

from torch.nn.parallel import DistributedDataParallel

from ..ops.graphs import GraphCache
from ..utils.profiling import span
from .loss import clip_info_nce, clip_info_nce_sharded
from .optim import adamw_scalars, adamw_update, clamp_logit_scale, clip_grads
from .train_state import TrainState

MOE_AUX_WEIGHT = 0.01  # Swin-MoE's load-balancing weight (JAX train/step.py)
INPUTS = ("image", "tokens", "pad_mask")  # what the step reads of a batch


def graph_key(state: TrainState, inputs: Mapping[str, torch.Tensor], sd_temperature,
              classes) -> tuple:
    """What a captured step depends on besides the tensors it updates in place:
    the inputs' shapes and dtypes, ``classes`` (the trainable names grouped
    by AdamW count: the trainable mask, and the groups an IL reset of some
    counts makes), the hold flag, the address of the codebook snapshot (which
    ``il.snapshot_codebook`` rebinds), the FDT temperature (None for CLIP),
    the AdamW state's identity, and the addresses of the EMA clamp's tensors
    (which a checkpoint restore rebinds)."""
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()), classes,
            state.hold_codebook, state.stored_codebook.data_ptr(), sd_temperature,
            id(state.opt_state), state.ema_buffer.data_ptr(), state.ema_clip_count.data_ptr())


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
    ``loss``, ``logit_scale``, ``acc1``, ``acc5`` as 0-d device tensors of
    their own and ``lr`` as a float; under DDP ``loss``, ``acc1`` and
    ``acc5`` are means over the ranks."""
    if spectral_norm or lipreg_lambda > 0.0:
        raise NotImplementedError("spectral_norm and lipreg are not ported")
    data_parallel = isinstance(model, DistributedDataParallel)
    params = dict((model.module if data_parallel else model).named_parameters())
    names = tuple(params)
    zeros: Dict[str, torch.Tensor] = {}  # the missing gradients' zeros, by name
    graphs = GraphCache()
    # lr and each class's bias corrections, on the parameters' device
    scalars_buffer = torch.empty(1 + 2 * len(names), dtype=torch.float32,
                                 device=next(iter(params.values())).device)

    def step(state: TrainState, batch: Dict[str, Any], sd_temperature: float):
        with span("train.step", step=state.step + 1, ctx=batch["tokens"].shape[1]):
            lr = schedule(state.step + 1)
            classes, values = adamw_scalars(state.opt_state, names, state.trainable, lr, b1, b2)
            inputs = {k: batch[k] for k in INPUTS if batch.get(k) is not None}
            scalars = scalars_buffer[:len(values)]
            host = torch.tensor(values, dtype=torch.float32)
            # from pinned memory, which the host allocator keeps until the
            # copy has run (a pageable copy may wait for the stream)
            scalars.copy_(host.pin_memory() if scalars.is_cuda else host, non_blocking=True)

            def run(inputs):
                return _device_step(state, inputs, sd_temperature, classes, scalars)

            temperature = sd_temperature if is_fdt else None
            key = None if data_parallel else graph_key(state, inputs, temperature, classes)
            with span("train.replay") if graphs.captured(key) else contextlib.nullcontext():
                out = graphs(run, inputs, key, held=(state.opt_state, state.stored_codebook,
                                                     state.ema_buffer, state.ema_clip_count))
            state.step += 1
            return {"loss": out.pop("loss"), "lr": lr, **out}

    def _device_step(state, inputs, sd_temperature, classes, scalars):
        """The device's part of a step: what a graph captures."""
        for p in params.values():
            p.grad = None
        kwargs = {"sd_temperature": sd_temperature} if is_fdt else {}
        with span("train.forward"):
            out = model(inputs["image"], inputs["tokens"], inputs.get("pad_mask"), **kwargs)
            if data_parallel:
                loss, metrics = clip_info_nce_sharded(out["image_embed"], out["text_embed"],
                                                      out["logit_scale"], group=group,
                                                      reference_scale=reference_scale)
            else:
                loss, metrics = clip_info_nce(out["image_embed"], out["text_embed"],
                                              out["logit_scale"],
                                              reference_scale=reference_scale)
            aux = out.get("moe_aux")
            if aux is not None:
                loss = loss + MOE_AUX_WEIGHT * aux
        with span("train.backward"):
            loss.backward()  # under DDP this rank's loss; DDP averages the gradients
        if data_parallel:
            loss = metrics.pop("loss")
            if aux is not None:  # this rank's own term beside the ranks' mean InfoNCE
                loss = loss + MOE_AUX_WEIGHT * aux.detach()
        with span("train.update"):
            grads = {n: p.grad for n, p in params.items()}
            clip_grads(grads, grad_clip_type, grad_clip_value)

            ls = params["logit_scale"]
            with torch.no_grad():
                clamp_logit_scale(params, grad_clip_type, grad_clip_value, grad_clip_max_value)
                before_ls = ls.detach().clone()
                adamw_update(grads, state.opt_state, params, lr=scalars, wd_tree=wd_tree,
                             trainable=state.trainable, b1=b1, b2=b2, eps=eps,
                             classes=classes, zeros=zeros)
                clamp_logit_scale(params, grad_clip_type, grad_clip_value, grad_clip_max_value)
                if grad_clip_type == "logit_scale_param":  # bound the change per step
                    ls.copy_(torch.clamp(ls, before_ls - grad_clip_value,
                                         before_ls + grad_clip_value))
                elif grad_clip_type == "logit_scale_param_ema":
                    buf = state.ema_buffer
                    clipped = torch.clamp(ls, buf - grad_clip_value, buf + grad_clip_value)
                    state.ema_clip_count.add_((clipped != ls).float().sum())
                    ls.copy_(clipped)
                    buf.copy_(0.9 * buf + 0.1 * ls.mean())
                elif grad_clip_type == "constant":
                    ls.copy_(before_ls)
                if is_fdt and state.hold_codebook:
                    params["space_dict"].copy_(state.stored_codebook)
        return {"loss": loss.detach(), "logit_scale": ls.detach().mean(), **metrics}

    step.graphs = graphs
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
