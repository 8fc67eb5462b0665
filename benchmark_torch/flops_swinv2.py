"""Operation and byte counts of CLIP-FDT Swin V2 and of K4's cosine form, for
``mfu_fdt_swinv2.*``, ``k4cos_roofline.*`` and ``k1_roofline_swinv2.*``.

Counts come from the configuration's shapes alone (``reference/fdt_swinv2.py``'s
``stages``), as ``flops.py``'s and ``flops_swin.py``'s do:

- model FLOPs of a step: every product as 2 x multiply-adds; the backward as
  twice the forward of every product, but the patch embed, whose input is
  data, as once (its weight's gradient alone). Each block's position-bias
  MLP runs on its ``(2 ws - 1)^2`` table rows. The tower's ``visual.proj``,
  which no FDT loss reads, is not counted. Elementwise work, the rows'
  normalisation, LayerNorm, softmax and sparsemax are not counted.
- K4-cosine's bound: the larger of its bytes over the HBM bandwidth and its
  bf16 operations over the bf16 peak, each input read once and each output
  written once: the dot-product form's (``flops_swin.py``), plus the [H]
  fp32 scales read and, backward, the [H] scale gradient written; the
  operations are the same products (the rows' norms, 2 N 32 per head and
  window, are not counted).
- K1's calls at the Swin tower's last-stage grid (``k1_calls``).
"""
from __future__ import annotations

from typing import List, Tuple

import flops
from flops import BF16, BF16_FLOPS, F32, bound_s  # noqa: F401
from flops_swin import HEAD_DIM
from reference.fdt_swinv2 import CPB_HIDDEN, stages, swin_sizes


def image_fwd_flops(config: dict, batch: int) -> Tuple[float, float]:
    """``(forward FLOPs of the image tower up to its last-stage tokens, the
    patch embed's share of them)`` at ``batch`` images."""
    s = swin_sizes(config)
    g, p = s["resolution"] // s["patch"], s["patch"]
    patch = 2.0 * batch * g * g * 3 * p * p * s["channels"]
    fwd = patch
    st = stages(config)
    for i, stage in enumerate(st):
        t = batch * stage["res"] ** 2  # tokens
        d, n, heads = stage["dim"], stage["window"] ** 2, stage["heads"]
        rows = (2 * stage["window"] - 1) ** 2
        hidden = int(d * s["mlp_ratio"])
        for _ in range(stage["depth"]):
            fwd += 2.0 * t * d * 3 * d       # qkv
            fwd += 2.0 * 2 * t * n * d       # q k^T and p v in every window and head
            fwd += 2.0 * t * d * d           # proj
            fwd += 2.0 * rows * (2 * CPB_HIDDEN + CPB_HIDDEN * heads)  # the bias MLP
            fwd += 2.0 * 2 * t * d * hidden  # fc1, fc2
        if i < len(st) - 1:
            fwd += 2.0 * (t // 4) * 4 * d * 2 * d  # patch merging's reduction
    return fwd, patch


def image_tokens(config: dict) -> int:
    """The last stage's tokens an image: what the image query head reads."""
    return stages(config)[-1]["res"] ** 2


def train_step_flops(config: dict, batch: int, ctx: int) -> float:
    """Model FLOPs of one training step at ``batch`` pairs and text context
    ``ctx``: 3 x the forward of every product (2 x for the patch embed): the
    image tower, the text tower, both query heads and codebook products, and
    both InfoNCE logit matrices."""
    m = config["model"]["kwargs"]
    txt, fdt = m["text_encode"], m["fdt"]
    image, patch = image_fwd_flops(config, batch)
    fwd = image - patch
    fwd += flops._tower_fwd(batch, ctx, txt["width"], txt["layers"], True)
    n, d = fdt["sd_num"], fdt["sd_dim"]
    for tokens, ft in ((image_tokens(config), fdt["raw_img_ft_dim"]),
                       (ctx, fdt["raw_txt_ft_dim"])):
        fwd += flops._linear(batch, tokens, ft, d) + flops._linear(batch, tokens, d, d)  # q_map
        fwd += flops._linear(batch, tokens, d, n)  # tokens x codebook
        fwd += flops._linear(batch, 1, n, d)       # sparse weights x codebook
    fwd += 2 * flops._linear(batch, 1, d, batch)  # both InfoNCE logit matrices
    return 2.0 * patch + 3.0 * fwd


def k4cos_calls(config: dict, batch: int) -> List[Tuple[int, int, int, int]]:
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


def k4cos_fwd_bound_s(windows: int, n: int, heads: int, nbias: int) -> float:
    """K4-cosine-fwd: reads qkv [W, N, 3C] (bf16), the bias [nbias, H, N, N]
    and the scales [H] (fp32), writes out [W, N, C] (bf16); two products of
    32-wide heads."""
    c = heads * HEAD_DIM
    nbytes = (BF16 * (windows * n * 3 * c + windows * n * c)
              + F32 * (nbias * heads * n * n + heads))
    return bound_s(nbytes, 2.0 * 2 * windows * heads * n * n * HEAD_DIM)


def k4cos_bwd_bound_s(windows: int, n: int, heads: int, nbias: int) -> float:
    """K4-cosine-bwd: reads qkv, dout, the bias and the scales, writes dqkv,
    the bias's gradient [H, N, N] and the scales' [H] (fp32); five products
    (the recomputed logits included)."""
    c = heads * HEAD_DIM
    nbytes = (BF16 * (2 * windows * n * 3 * c + windows * n * c)
              + F32 * (nbias * heads * n * n + heads * n * n + 2 * heads))
    return bound_s(nbytes, 2.0 * 5 * windows * heads * n * n * HEAD_DIM)


def k1_calls(config: dict, ctx: int) -> List[Tuple[int, int, bool]]:
    """``(tokens, depth, masked)`` of a step's two K1 towers: the image query
    head over the last stage's grid (no pads), the text over ``ctx`` (pads)."""
    d = config["model"]["kwargs"]["fdt"]["sd_dim"]
    return [(image_tokens(config), d, False), (ctx, d, True)]
