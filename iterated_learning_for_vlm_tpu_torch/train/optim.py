"""Optimizer: masked AdamW with per-parameter step counts, and param grouping.

Counterpart of ``iterated_learning_for_vlm_tpu/train/optim.py``. Parameters
are a mapping from the port's names to tensors (``dict(model.named_parameters())``);
the gradients, moments, weight decays and trainable flags are mappings keyed
by the same names. Every decision the JAX package takes on a flax path
(``param_category``, ``is_always_frozen``, the tower roots) is taken here on
the JAX path of the port name, from the weight bridge
(``tools/torch_checkpoint.py:jax_path``): the port's names differ (a
LayerNorm weight is ``weight``, not ``scale``, and the query heads' norms are
``q_map.0`` / ``q_map.3``), so rules on them would decide otherwise.

Semantics kept from JAX, where ``torch.optim.AdamW`` differs:

- a trainable parameter whose gradient is ``None`` (one the FDT forward never
  reads: ``visual.ln_post``, ``visual.proj``, ``encode_text.text_projection``,
  ``logit_scale_sd``) still takes a step with a zero gradient: weight decay,
  moment decay and a count advance;
- a frozen parameter takes no update of any kind: no decay, no moment
  update, no count advance;
- ``clip_grads("norm")`` sums over every gradient, frozen parameters' included.

Updates are in place under ``torch.no_grad``; counts live on the host (they
are known without reading the device). The host half of a step
(:func:`adamw_scalars`) turns them into the bias corrections, which the
device half (:func:`adamw_update`) reads from a tensor. Moments are fp32;
bf16 moments with stochastic rounding, AdamW_SGD and LARS are not ported.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import torch

from ..tools.torch_checkpoint import jax_path

VISION_ROOTS = ("visual", "img_query")  # JAX roots of the port's visual, img_query_model
TEXT_ROOTS = ("text", "txt_query")      # ... of encode_text, txt_query_model

Params = Mapping[str, torch.Tensor]


# -- parameter classification ------------------------------------------------
def param_category(path: Tuple[str, ...]) -> str:
    """The reference's pconfig bucket of a JAX param path."""
    leaf = path[-1]
    if "logit_scale" in path[0] or leaf.startswith("logit_scale"):
        return "logit_scale"
    if leaf == "space_dict" or path[0] == "space_dict":
        return "space_dict"
    in_layernorm = any(p.startswith("ln_") or p == "norm" for p in path)
    if in_layernorm and leaf == "scale":
        return "ln_w"
    if in_layernorm and leaf == "bias":
        return "ln_b"
    if leaf == "bias":
        return "bias"
    return "default"


def is_always_frozen(path: Tuple[str, ...]) -> bool:
    """conv1 is permanently frozen in the reference (never trained)."""
    return "conv1" in path


def build_wd_tree(params: Params, base_wd: float,
                  pconfig: Optional[Mapping[str, Mapping]]) -> Dict[str, float]:
    """Per-parameter weight decay from the pconfig overrides."""
    pconfig = pconfig or {}
    out = {}
    for name in params:
        cat = param_category(jax_path(name))
        out[name] = float(pconfig.get(cat, {}).get("weight_decay", base_wd))
    return out


def trainable_mask_tree(params: Params,
                        frozen_groups: FrozenSet[str] = frozenset()) -> Dict[str, bool]:
    """Which parameters take updates. ``frozen_groups`` from {"vision",
    "text", "logit_scale", "codebook"}; conv1 is always frozen."""
    out = {}
    for name in params:
        p = jax_path(name)
        cat = param_category(p)
        frozen = (is_always_frozen(p)
                  or ("vision" in frozen_groups and p[0] in VISION_ROOTS)
                  or ("text" in frozen_groups and p[0] in TEXT_ROOTS)
                  or ("logit_scale" in frozen_groups and cat == "logit_scale")
                  or ("codebook" in frozen_groups and cat == "space_dict"))
        out[name] = not frozen
    return out


# -- masked AdamW ------------------------------------------------------------
def adamw_init(params: Params, moment_dtype=None) -> Dict[str, Dict]:
    """Zero AdamW state: ``{"mu", "nu"}`` fp32 tensors beside each parameter
    and ``"count"``, a host float per parameter."""
    if moment_dtype not in (None, torch.float32):
        raise NotImplementedError("AdamW moments in bf16 with stochastic rounding are not "
                                  "ported to the PyTorch package; moments are fp32")
    return {"mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "count": {n: 0.0 for n in params}}


def adamw_scalars(state: Dict[str, Dict], names, trainable: Mapping[str, bool], lr: float,
                  b1: float = 0.9, b2: float = 0.98) -> Tuple[Tuple[Tuple[str, ...], ...], list]:
    """The host half of one AdamW step: ``count += 1`` for each trainable
    parameter (``names`` in order), then the trainable names grouped by
    their count, in order of first appearance (``classes``), and the step's
    scalars as host floats: ``lr``, then each class's ``1 - b1^count`` and
    ``1 - b2^count``. A device copy rounds them to float32, as a Python
    scalar is rounded where a kernel reads it."""
    by_count: Dict[float, list] = {}
    for n in names:
        if trainable[n]:
            state["count"][n] += 1.0
            by_count.setdefault(state["count"][n], []).append(n)
    values = [lr]
    for c in by_count:
        values += [1 - b1 ** c, 1 - b2 ** c]
    return tuple(tuple(v) for v in by_count.values()), values


@torch.no_grad()
def adamw_update(grads: Mapping[str, Optional[torch.Tensor]], state: Dict[str, Dict],
                 params: Params, *, lr: torch.Tensor, classes, wd_tree: Mapping[str, float],
                 trainable: Mapping[str, bool], b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, zeros: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """One AdamW step on the trainable parameters, in place:

        mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2;  count += 1
        p -= lr (mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count)) + eps) + wd p)

    ``lr`` is the float32 tensor on the parameters' device that the values
    of an :func:`adamw_scalars` call were copied into, and ``classes`` that
    call's (the counts have advanced already): the device reads ``lr`` and
    the bias corrections from a tensor, so a CUDA graph of the step can
    replay it. A missing gradient counts as zero (read from ``zeros``, a
    cache of zero tensors by name, when given); frozen parameters are left
    alone. The arithmetic runs as multi-tensor (``torch._foreach_*``)
    kernels."""
    names = [n for cls in classes for n in cls]
    if not names:
        return
    ps = [params[n] for n in names]
    zeros = {} if zeros is None else zeros
    gs = []
    for n in names:
        g = grads.get(n)
        if g is None:
            if n not in zeros:
                zeros[n] = torch.zeros_like(params[n])
            g = zeros[n]
        gs.append(g.float())
    mus = [state["mu"][n] for n in names]
    nus = [state["nu"][n] for n in names]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, gs, alpha=1 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
    denom, step, at = [], [], 0
    for k, cls in enumerate(classes):  # per class: one bias correction each
        part = slice(at, at + len(cls))
        at += len(cls)
        denom += torch._foreach_div(nus[part], lr[2 + 2 * k])
        step += torch._foreach_div(mus[part], lr[1 + 2 * k])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(step, denom)
    torch._foreach_add_(step, torch._foreach_mul(ps, [wd_tree[n] for n in names]))
    torch._foreach_mul_(step, lr[0])
    torch._foreach_sub_(ps, step)


@torch.no_grad()
def reset_opt_state_for(state: Dict[str, Dict], reset_mask: Mapping[str, bool]) -> Dict[str, Dict]:
    """Zero the moments and counts of the parameters the mask marks (the IL
    engine re-drew them: fresh weights must not inherit stale moments)."""
    for name, reset in reset_mask.items():
        if reset:
            state["mu"][name].zero_()
            state["nu"][name].zero_()
            state["count"][name] = 0.0
    return state


# -- gradient clipping and logit-scale clamps ---------------------------------
@torch.no_grad()
def clip_grads(grads: Mapping[str, Optional[torch.Tensor]], mode: str, value: float):
    """Pre-step gradient clipping, in place. 'norm': scale every gradient by
    ``min(1, value / (global_norm + 1e-6))``; 'value': clamp each to
    ``[-value, value]``; 'logit_scale_grad': clamp only the logit-scale
    gradients; anything else: no-op. A missing gradient counts as zero."""
    live = {n: g for n, g in grads.items() if g is not None}
    if mode == "norm" and live:
        gs = list(live.values())
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)).float())
        torch._foreach_mul_(gs, torch.clamp(value / (norm + 1e-6), max=1.0))
    elif mode == "value":
        for g in live.values():
            g.clamp_(-value, value)
    elif mode == "logit_scale_grad":
        for name, g in live.items():
            if param_category(jax_path(name)) == "logit_scale":
                g.clamp_(-value, value)
    return grads


@torch.no_grad()
def clamp_logit_scale(params: Params, mode: str, value: float, max_value: float) -> None:
    """Param clamping around the update, in place, on ``logit_scale`` only
    (not ``logit_scale_sd``). 'logit_scale_param_value': clamp to
    ``[value, max_value]``; 'logit_scale_param_abs_min': clamp below at
    ``value``; other modes: no-op."""
    ls = params["logit_scale"]
    if mode == "logit_scale_param_value":
        ls.clamp_(value, max_value)
    elif mode == "logit_scale_param_abs_min":
        ls.clamp_(min=value)
