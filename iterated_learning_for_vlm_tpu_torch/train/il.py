"""Iterated-learning engine: periodic resets, codebook holding, freezes.

Counterpart of ``iterated_learning_for_vlm_tpu/train/il.py`` (reference
``example/clip_fdt/train_solver.py:545-557`` and
``prototype/model/clip_fdt.py:256-321``), with the JAX package's fixes of the
reference: every reset is seeded deterministically, and the codebook is
snapshotted at every reset boundary.

``weight_reset_tree`` semantics. ``"reference"``: what torch's
``module.apply(weight_reset)`` does to the reference model, which resets only
Conv / Linear / LayerNorm modules. Redrawn: the Linears ``out_proj``,
``c_fc``, ``c_proj``, ``text_projection`` and the query heads' ``q_map.1`` /
``q_map.4`` (JAX ``fc_1`` / ``fc_2``), weight and bias from torch's default
U(+-1/sqrt(fan_in)), and conv1 the same way; LayerNorms go back to (1, 0).
Kept: the packed ``in_proj_*`` (bare parameters of ``nn.MultiheadAttention``),
the embeddings, ``proj``, the logit scales and ``space_dict``. ``"full"``:
every parameter under the roots from a freshly initialised model
(``init_fn``). The rules are applied to the JAX path of each port name
(``tools/torch_checkpoint.py:jax_path``).

Random draws come from a ``torch.Generator`` seeded from (seed, step, what,
parameter name), so a reset at the same step of the same run reproduces bit
for bit. The JAX and torch random streams differ, so parity with the JAX
package is structural: the same parameters are redrawn from the same
distributions, their moments and counts are zeroed, the held codebook is
bit-equal to the snapshot.

In a process group every rank draws the same values from the same keys,
so the ranks' parameters stay equal through every reset, snapshot and hold
with no broadcast (``DistributedDataParallel`` broadcasts only when it is
built, and the step averages only gradients).

The controller updates the model's parameters and the state in place and
returns the state, so it is used as in JAX: ``state = il.on_step(state, step)``
after every optimizer step.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..tools.torch_checkpoint import jax_path
from .optim import TEXT_ROOTS, VISION_ROOTS, reset_opt_state_for, trainable_mask_tree
from .train_state import TrainState

# Dense submodules whose reference counterparts are nn.Linear (reset by
# ``weight_reset``); ``in_proj`` is MHA's bare parameters (kept).
_RESET_DENSE = {"out_proj", "c_fc", "c_proj", "fc_1", "fc_2", "text_projection"}


def seeded_generator(device, *key) -> torch.Generator:
    """A generator on ``device`` seeded from a hash of ``key``."""
    digest = hashlib.sha256(repr(key).encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def _reference_reset(name: str, p: torch.Tensor, params, key) -> bool:
    """Redraw ``p`` in place if the reference reset touches it."""
    path = jax_path(name)
    if "norm" in path:  # LayerNorm scale / bias
        p.fill_(1.0 if path[-1] == "scale" else 0.0)
        return True
    if path[-2] in _RESET_DENSE or path[-2] == "conv1":
        weight = p if p.dim() > 1 else params[name[:-len("bias")] + "weight"]
        bound = 1.0 / math.sqrt(math.prod(weight.shape[1:]))  # torch layout: [out, in, ...]
        p.uniform_(-bound, bound, generator=seeded_generator(p.device, *key, name))
        return True
    return False


@torch.no_grad()
def weight_reset_tree(params: Mapping[str, torch.Tensor], roots: Tuple[str, ...], key: tuple,
                      semantics: str = "reference",
                      fresh_params: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Dict[str, bool]:
    """Re-initialise, in place, the parameters under the JAX ``roots``.
    Returns the reset mask (name -> redrawn), for zeroing their moments."""
    if semantics == "full" and fresh_params is None:
        raise ValueError("full semantics needs freshly initialised params")
    mask = {}
    for name, p in params.items():
        if jax_path(name)[0] not in roots:
            mask[name] = False
        elif semantics == "full":
            p.copy_(fresh_params[name])
            mask[name] = True
        else:
            mask[name] = _reference_reset(name, p, params, key)
    return mask


@dataclasses.dataclass
class ResetConfig:
    """Reference ``config_cc3m.yaml:88-94`` ``reset`` block."""

    enable: bool = True
    reset_steps: int = 6000
    reset_nums: int = 12
    smooth_steps: int = 1500
    # extensions (documented divergences / knobs)
    semantics: str = "reference"  # "reference" | "full"
    reset_optimizer_state: bool = True  # False == keep stale Adam moments
    freeze_vision_during_smooth: bool = True  # False == the shipped reference code


class ILController:
    """Host-side phase controller over ``model`` and a :class:`TrainState`.

    ``init_fn(generator) -> {name: tensor}`` gives freshly initialised
    parameters for ``semantics="full"``."""

    def __init__(self, cfg: ResetConfig, seed: int, model: torch.nn.Module,
                 init_fn: Optional[Callable[[torch.Generator], Mapping]] = None, logger=None):
        self.cfg = cfg
        self.seed = seed
        self.params = dict(model.named_parameters())
        self.init_fn = init_fn
        self.logger = logger
        self.stored_vision: Optional[Dict[str, torch.Tensor]] = None  # swap_vision_encoder

    def _reset(self, state: TrainState, roots, step: int, what: str) -> TrainState:
        key = (self.seed, int(step), what)
        fresh = None
        if self.cfg.semantics == "full":
            device = self.params["space_dict"].device
            fresh = self.init_fn(seeded_generator(device, *key, "full"))
        mask = weight_reset_tree(self.params, roots, key, self.cfg.semantics, fresh)
        if self.cfg.reset_optimizer_state:
            reset_opt_state_for(state.opt_state, mask)
        return state

    # -- primitive operations ----------------------------------------------
    def reset_text_encoder(self, state: TrainState, step: int) -> TrainState:
        """Reference ``clip_fdt.py:256-261`` with deterministic seeding."""
        return self._reset(state, TEXT_ROOTS, step, "text")

    def reset_vision_encoder(self, state: TrainState, step: int) -> TrainState:
        """Reference ``clip_fdt.py:264-266``."""
        return self._reset(state, VISION_ROOTS, step, "vision")

    @torch.no_grad()
    def reset_codebook(self, state: TrainState, step: int) -> TrainState:
        """Reference ``clip_fdt.py:281-283``: space_dict ~ N(0, 1)."""
        sd = self.params["space_dict"]
        sd.normal_(0.0, 1.0, generator=seeded_generator(sd.device, self.seed, int(step),
                                                         "codebook"))
        return state

    @torch.no_grad()
    def swap_vision_encoder(self, state: TrainState, step: int) -> TrainState:
        """Reference ``clip_fdt.py:268-278``: exchange the vision weights with
        the stored set (a fresh reset if none is stored yet)."""
        vision = {n: p for n, p in self.params.items() if jax_path(n)[0] in VISION_ROOTS}
        current = {n: p.detach().clone() for n, p in vision.items()}
        if self.stored_vision is None:
            state = self.reset_vision_encoder(state, step)
        else:
            for n, p in vision.items():
                p.copy_(self.stored_vision[n])
        self.stored_vision = current
        return state

    def set_frozen(self, state: TrainState, frozen_groups: frozenset) -> TrainState:
        state.trainable = trainable_mask_tree(self.params, frozen_groups)
        return state

    def snapshot_codebook(self, state: TrainState) -> TrainState:
        state.stored_codebook = self.params["space_dict"].detach().clone()
        state.hold_codebook = True
        return state

    def release_codebook(self, state: TrainState) -> TrainState:
        state.hold_codebook = False
        return state

    # -- the schedule --------------------------------------------------------
    def on_step(self, state: TrainState, step: int) -> TrainState:
        """Phase transitions *after* optimizer step ``step`` (1-based), at the
        reference loop's position (train_solver.py:545-557)."""
        cfg = self.cfg
        if not cfg.enable:
            return state
        if not cfg.reset_steps < step < cfg.reset_steps * cfg.reset_nums:
            if step == cfg.reset_steps * cfg.reset_nums:  # window over: nothing held
                state = self.release_codebook(state)
                state = self.set_frozen(state, frozenset())
            return state
        if step % cfg.reset_steps == 0:
            self._log(f"step {step}: IL reset - snapshot codebook, reset text encoder")
            state = self.snapshot_codebook(state)
            state = self.reset_text_encoder(state, step)
            if cfg.freeze_vision_during_smooth:
                state = self.set_frozen(state, frozenset({"vision"}))
        elif step % cfg.reset_steps == cfg.smooth_steps:
            self._log(f"step {step}: IL smooth end - unfreeze vision, release codebook")
            state = self.release_codebook(state)
            state = self.set_frozen(state, frozenset())
        return state

    def _log(self, msg):
        if self.logger is not None:
            self.logger.info(msg)
