"""Parameter initializers matching the reference's PyTorch distributions.

Counterpart of ``iterated_learning_for_vlm_tpu/models/initializers.py``; the
distributions are the same, the layout is torch's (``[out, in, ...]``). Each
fills a tensor in place from an explicit ``torch.Generator`` (which must live
on the tensor's device) and returns it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


@torch.no_grad()
def torch_kaiming_uniform(t: torch.Tensor,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch's default Linear/Conv weight init, U(+-1/sqrt(fan_in)), with
    fan_in the product of every dim but the first (the output dim)."""
    bound = 1.0 / math.sqrt(math.prod(t.shape[1:]))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def torch_bias_uniform(t: torch.Tensor, fan_in: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch's default bias init, U(+-1/sqrt(fan_in)) with the weight's fan_in."""
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def scaled_normal(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.normal_(0.0, std, generator=generator)
