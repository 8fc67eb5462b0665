"""Training state.

Counterpart of ``iterated_learning_for_vlm_tpu/train/train_state.py``. The
JAX state is an immutable pytree that also carries the params; here the
parameters live in the model (``nn.Module``) and are updated in place, and
this dataclass carries the rest of what a step reads and writes: the step,
the trainable flags, the AdamW state, the IL codebook snapshot and hold flag
and the EMA logit-scale clamp state. The step and the flags are host values;
the tensors live on the parameters' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import torch


@dataclass
class TrainState:
    step: int
    # {"mu": {name: fp32 tensor}, "nu": {...}, "count": {name: float}}
    opt_state: Dict[str, Dict]
    # which parameters take updates (train/optim.py:trainable_mask_tree)
    trainable: Dict[str, bool]
    # IL: codebook snapshot written into space_dict after every step while held
    stored_codebook: torch.Tensor
    hold_codebook: bool
    # EMA logit-scale clamp state (reference EMA_logit_scale)
    ema_buffer: torch.Tensor
    ema_clip_count: torch.Tensor

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor], opt_state, trainable,
               stored_codebook=None, spectral_u=None, batch_stats=None):
        """``stored_codebook`` is copied, never aliased: the step overwrites
        ``space_dict`` from it. Spectral-norm power vectors and BatchNorm
        statistics belong to models the port does not build yet."""
        if spectral_u is not None or batch_stats is not None:
            raise NotImplementedError("spectral_u / batch_stats (spectral-norm and "
                                      "BatchNorm models) are not ported")
        device = next(iter(params.values())).device
        if stored_codebook is None:
            stored = torch.zeros((1, 1), device=device)
        else:
            stored = stored_codebook.detach().clone()
        return cls(step=0, opt_state=opt_state, trainable=dict(trainable),
                   stored_codebook=stored, hold_codebook=False,
                   ema_buffer=torch.tensor(3.125, device=device),
                   ema_clip_count=torch.zeros((), device=device))

    @property
    def spectral_u(self):
        raise NotImplementedError("spectral_u (the _sp model variants) is not ported")

    @property
    def batch_stats(self):
        raise NotImplementedError("batch_stats (BatchNorm models) is not ported")
