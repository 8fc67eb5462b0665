"""Sparsemax (Martins & Astudillo 2016) over the last axis, forward.

Counterpart of ``iterated_learning_for_vlm_tpu/models/sparsemax.py``; both
stay plain framework ops, as they are XLA (not Pallas) in the JAX package.

- :func:`sparsemax`: the sort-based projection, exact.
- :func:`sparsemax_bisect`: the threshold ``tau`` solving
  ``sum(relu(z - tau)) = 1`` by exactly ``n_iter`` (40) bisection steps from
  ``[-1, 0]`` after the max shift, then an exact renormalisation to the
  simplex. The fused codebook path always uses it.

The JAX functions carry a custom VJP (the exact sparsemax gradient); the
training slice will port it as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    z = z.float()
    z = z - z.amax(dim=-1, keepdim=True).detach()
    n = z.shape[-1]
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    rng = torch.arange(1, n + 1, dtype=z.dtype, device=z.device)
    cumsum = torch.cumsum(z_sorted, dim=-1)
    in_support = 1.0 + rng * z_sorted > cumsum
    k = torch.where(in_support, rng, 0.0).amax(dim=-1, keepdim=True)
    support_sum = torch.where(in_support, z_sorted, 0.0).sum(dim=-1, keepdim=True)
    tau = (support_sum - 1.0) / k
    return torch.clamp_min(z - tau, 0.0)


def sparsemax_bisect(z: torch.Tensor, n_iter: int = 40) -> torch.Tensor:
    z = z.float()
    z = z - z.amax(dim=-1, keepdim=True).detach()
    # after the shift max(z) = 0, so tau lies in [-1, 0]
    lo = torch.full(z.shape[:-1] + (1,), -1.0, dtype=z.dtype, device=z.device)
    hi = torch.zeros_like(lo)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        f = torch.clamp_min(z - mid, 0.0).sum(dim=-1, keepdim=True) - 1.0
        up = f > 0  # f falls as tau grows: f > 0 means tau is too small
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    out = torch.clamp_min(z - 0.5 * (lo + hi), 0.0)
    return out / torch.clamp_min(out.sum(dim=-1, keepdim=True), 1e-12)
