"""Operation and byte counts of CLIP Swin-MoE and of K4, for ``mfu_swinmoe.*`` and ``k4_roofline.*``.

Counts come from the configuration's shapes alone (``reference/swin_moe.py``'s
``stages``), as ``flops.py``'s do:

- model FLOPs of a step: every product as 2 x multiply-adds; each token
  through one expert (top-1), so the capacity's padded slots and the
  dropped tokens' absence are not counted; the backward as twice the
  forward of every product, but the patch embed, whose input is data, as
  once (its weight's gradient alone). Elementwise work, LayerNorm, softmax,
  the router's top-1 and the dispatch are not counted.
- K4's bound: the larger of its bytes over the HBM bandwidth and its bf16
  operations over the bf16 peak, each input read once and each output
  written once.
"""
from __future__ import annotations

from typing import List, Tuple

import flops
from flops import BF16, BF16_FLOPS, F32, HBM_BPS, bound_s  # noqa: F401
from reference.swin_moe import stages, swin_sizes

HEAD_DIM = 32  # every Swin-B stage's head width


def image_fwd_flops(config: dict, batch: int) -> Tuple[float, float]:
    """``(forward FLOPs of the image tower, the patch embed's share of them)``
    at ``batch`` images."""
    s = swin_sizes(config)
    g, p = s["resolution"] // s["patch"], s["patch"]
    patch = 2.0 * batch * g * g * 3 * p * p * s["channels"]
    fwd = patch
    st = stages(config)
    for i, stage in enumerate(st):
        t = batch * stage["res"] ** 2  # tokens
        d, n = stage["dim"], stage["window"] ** 2
        hidden = int(d * s["mlp_ratio"])
        for blk in range(stage["depth"]):
            fwd += 2.0 * t * d * 3 * d      # qkv
            fwd += 2.0 * 2 * t * n * d      # q k^T and p v in every window and head
            fwd += 2.0 * t * d * d          # proj
            if blk in stage["moe"]:
                fwd += 2.0 * t * d * s["experts"]  # the gate
            fwd += 2.0 * 2 * t * d * hidden  # fc1, fc2 (or one expert's w1, w2)
        if i < len(st) - 1:
            fwd += 2.0 * (t // 4) * 4 * d * 2 * d  # patch merging's reduction
    fwd += 2.0 * batch * st[-1]["dim"] * s["embed_dim"]  # visual.proj on the pooled token
    return fwd, patch


def train_step_flops(config: dict, batch: int, ctx: int) -> float:
    """Model FLOPs of one training step at ``batch`` pairs and text context
    ``ctx``: 3 x the forward of every product (2 x for the patch embed), the
    text tower and both InfoNCE logit matrices included."""
    txt = config["model"]["kwargs"]["text_encode"]
    width, embed = txt["width"], txt["embed_dim"]
    image, patch = image_fwd_flops(config, batch)
    fwd = image - patch
    fwd += flops._tower_fwd(batch, ctx, width, txt["layers"], True)
    fwd += 2.0 * batch * width * embed      # text_projection on the EOT token
    fwd += 2 * 2.0 * batch * embed * batch  # both InfoNCE logit matrices
    return 2.0 * patch + 3.0 * fwd


def k4_calls(config: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """``(windows, n, heads, nbias)`` of every block's window attention at
    ``batch`` images: nbias is the shift mask's windows, 1 unshifted."""
    out = []
    for stage in stages(config):
        ws = stage["window"]
        nw = (stage["res"] // ws) ** 2
        for blk in range(stage["depth"]):
            shifted = blk % 2 == 1 and stage["shift"] > 0
            out.append((batch * nw, ws * ws, stage["heads"], nw if shifted else 1))
    return out


def k4_fwd_bound_s(windows: int, n: int, heads: int, nbias: int) -> float:
    """K4-fwd: reads qkv [W, N, 3C] (bf16) and the bias [nbias, H, N, N]
    (fp32), writes out [W, N, C] (bf16); two products of 32-wide heads."""
    c = heads * HEAD_DIM
    nbytes = BF16 * (windows * n * 3 * c + windows * n * c) + F32 * nbias * heads * n * n
    return bound_s(nbytes, 2.0 * 2 * windows * heads * n * n * HEAD_DIM)


def k4_bwd_bound_s(windows: int, n: int, heads: int, nbias: int) -> float:
    """K4-bwd: reads qkv, the bias and dout, writes dqkv and the bias's
    gradient [H, N, N] (fp32); five products (the recomputed logits
    included)."""
    c = heads * HEAD_DIM
    nbytes = (BF16 * (2 * windows * n * 3 * c + windows * n * c)
              + F32 * (nbias * heads * n * n + heads * n * n))
    return bound_s(nbytes, 2.0 * 5 * windows * heads * n * n * HEAD_DIM)
