"""Learning-rate schedules: plain Python functions of the (1-based) step.

Counterpart of ``iterated_learning_for_vlm_tpu/train/schedule.py`` (reference
``prototype/lr_scheduler/scheduler.py``): linear warmup, then the decay, with
the iterated-learning re-warmup after each reset boundary for ``cosine``.
The step is a host integer in the port, so each schedule returns a float and
costs no device work.
"""
from __future__ import annotations

import bisect
import math
from typing import Callable

Schedule = Callable[[int], float]


def _warmup_line(step, base_lr, warmup_lr, warmup_steps):
    # the reference's line (scheduler.py:83-84): through base_lr at step 1
    return (warmup_lr - base_lr) / (warmup_steps - 1) * (step - 1.0) + base_lr


def cosine(base_lr: float, warmup_lr: float, min_lr: float, warmup_steps: int,
           max_iter: int, reset_steps: int = 0) -> Schedule:
    """Cosine anneal with warmup and IL re-warmup (reference ``Cosine``).

    - step < warmup_steps: linear base_lr -> warmup_lr;
    - else cosine from warmup_lr to min_lr over [warmup_steps, max_iter];
    - with reset_steps > 0 and (step % reset_steps) < warmup_steps: the warmup
      line again, scaled by the current cosine value (``outer_lr_scale``).
    Never below 0 (the re-warm line can dip below at a reset boundary)."""

    def fn(step):
        ratio = (step - warmup_steps) / max(max_iter - warmup_steps, 1)
        cos_lr = min_lr + (warmup_lr - min_lr) * (1 + math.cos(math.pi * ratio)) / 2
        lr = cos_lr
        if warmup_steps >= 2:
            if step < warmup_steps:
                lr = _warmup_line(step, base_lr, warmup_lr, warmup_steps)
            elif reset_steps > 0 and step % reset_steps < warmup_steps:
                line = _warmup_line(step % reset_steps, base_lr, warmup_lr, warmup_steps)
                lr = cos_lr * (line / warmup_lr)
        return max(lr, 0.0)

    return fn


def step_schedule(base_lr: float, warmup_lr: float, warmup_steps: int, lr_steps: list,
                  lr_mults: list, max_iter: int, reset_steps: int = 0) -> Schedule:
    """Piecewise-constant decay (reference ``StepLRScheduler``)."""
    mults = [1.0]
    for m in lr_mults:
        mults.append(mults[-1] * m)

    def fn(step):
        if warmup_steps >= 2 and step < warmup_steps:
            return _warmup_line(step, base_lr, warmup_lr, warmup_steps)
        return warmup_lr * mults[bisect.bisect_right(lr_steps, step)]

    return fn


def step_decay(base_lr: float, warmup_lr: float, warmup_steps: int, step_size: int,
               decay: float, max_iter: int, reset_steps: int = 0) -> Schedule:
    """Exponential stair decay (reference ``StepDecayLRScheduler``)."""

    def fn(step):
        if warmup_steps >= 2 and step < warmup_steps:
            return _warmup_line(step, base_lr, warmup_lr, warmup_steps)
        return decay ** math.floor((step - warmup_steps) / step_size) * warmup_lr

    return fn


def polynomial(base_lr: float, warmup_lr: float, warmup_steps: int, power: float,
               max_iter: int, reset_steps: int = 0) -> Schedule:
    """Polynomial decay (reference ``PolynomialLRScheduler``)."""

    def fn(step):
        if warmup_steps >= 2 and step < warmup_steps:
            return _warmup_line(step, base_lr, warmup_lr, warmup_steps)
        return (1 - (step - warmup_steps) / float(max_iter)) ** power * warmup_lr

    return fn


_REGISTRY = {"Cosine": cosine, "Step": step_schedule, "StepDecay": step_decay,
             "Poly": polynomial}


def epoch_to_iter(kwargs: dict) -> dict:
    """Epoch kwargs -> iteration kwargs (reference ``lr_scheduler/__init__.py``):
    ``lr_epochs`` -> ``lr_steps`` and ``warmup_epoch`` -> ``warmup_steps``
    (at least 2), scaled by ``max_iter / max_epoch``."""
    kwargs = dict(kwargs)
    ratio = kwargs["max_iter"] / kwargs.pop("max_epoch")
    if "lr_epochs" in kwargs:
        kwargs["lr_steps"] = [round(e * ratio) for e in kwargs.pop("lr_epochs")]
    if "warmup_epoch" in kwargs:
        kwargs["warmup_steps"] = max(round(kwargs.pop("warmup_epoch") * ratio), 2)
    return kwargs


def scheduler_entry(config) -> Schedule:
    """A schedule from the reference YAML block (``lr_scheduler: {type,
    kwargs}``); the torch API's ``optimizer`` / ``last_iter`` kwargs are
    dropped. ``StepEpoch`` / ``CosineEpoch`` convert epochs first."""
    kwargs = dict(config["kwargs"])
    for dead in ("optimizer", "last_iter"):
        kwargs.pop(dead, None)
    stype = config["type"]
    if stype in ("StepEpoch", "CosineEpoch"):
        stype = stype.replace("Epoch", "")
        kwargs = epoch_to_iter(kwargs)
    return _REGISTRY[stype](**kwargs)
