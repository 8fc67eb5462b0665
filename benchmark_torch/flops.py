"""Operation and byte counts of the benchmark's models and kernels, and the card's peaks.

The yardstick for ``mfu.*`` and ``*_roofline`` metrics. Counts come from the
configuration's shapes alone, never from the program:

- model FLOPs of a CLIP / CLIP-FDT step: every product as 2 x multiply-adds,
  the backward as twice the forward of every trainable product, nothing that
  is recomputed counted. The frozen patch embed (``conv1``) takes no backward
  (its weight is frozen and its input is data), so it counts once. Elementwise
  work, LayerNorm, softmax and sparsemax are not counted.
- a kernel's bound (from ``chip_smoke.py``'s ``bound_ms``): the larger of its
  bytes over the HBM bandwidth and its bf16 operations over the bf16 peak,
  each input read once and each output written once.
"""
from __future__ import annotations

from reference.clip import sizes

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS = 989e12
HBM_BPS = 3.35e12
HEAD_DIM = 64  # every tower's attention head width

BF16, F32, I32 = 2, 4, 4


def _tower_fwd(batch: int, seq: int, width: int, layers: int, causal: bool) -> float:
    """Forward FLOPs of ``layers`` pre-LN transformer blocks over ``seq`` tokens:
    the packed QKV, the two attention products over the pairs the mask keeps,
    the output projection and the 4x MLP."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    per_layer = (2 * seq * width * 3 * width      # in_proj
                 + 2 * 2 * pairs * width          # q k^T and p v over every head
                 + 2 * seq * width * width        # out_proj
                 + 2 * 2 * seq * width * 4 * width)  # c_fc, c_proj
    return float(batch) * layers * per_layer


def _linear(batch: int, rows: int, n_in: int, n_out: int) -> float:
    return 2.0 * batch * rows * n_in * n_out


def train_step_flops(config: dict, batch: int, ctx: int) -> float:
    """Model FLOPs of one training step of ``config['model']`` at ``batch``
    pairs and text context ``ctx``: forward + 2 x forward of the trainable
    products, the InfoNCE logits included."""
    m = config["model"]["kwargs"]
    tower = sizes(config)
    img, txt = tower["image"], tower["text"]
    grid = (img["resolution"] // img["patch"]) ** 2
    patch_in = 3 * img["patch"] ** 2
    frozen = _linear(batch, grid, patch_in, img["width"])  # conv1
    fwd = _tower_fwd(batch, grid + 1, img["width"], img["layers"], False)
    fwd += _tower_fwd(batch, ctx, txt["width"], txt["layers"], True)
    if "fdt" in m:
        fdt = m["fdt"]
        n, d = fdt["sd_num"], fdt["sd_dim"]
        for tokens, ft in ((grid, img["width"]), (ctx, txt["width"])):
            fwd += _linear(batch, tokens, ft, d) + _linear(batch, tokens, d, d)  # q_map
            fwd += _linear(batch, tokens, d, n)  # tokens x codebook
            fwd += _linear(batch, 1, n, d)       # sparse weights x codebook
        embed = d
    else:
        embed = img["embed_dim"]
        fwd += _linear(batch, 1, img["width"], embed)   # visual.proj on the class token
        fwd += _linear(batch, 1, txt["width"], embed)   # text_projection on the EOT token
    fwd += 2 * _linear(batch, 1, embed, batch)  # both InfoNCE logit matrices
    return frozen + 3.0 * fwd


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    bandwidth and the bf16 operations over the peak."""
    return max(nbytes / HBM_BPS, ops / BF16_FLOPS)


def attention_ops(batch: int, seq: int, heads: int, causal: bool, products: int) -> float:
    """bf16 operations of ``products`` [S, S] x [S, 64] products over B*H heads,
    counting only the (query, key) pairs the causal mask keeps."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    return 2.0 * products * batch * heads * pairs * HEAD_DIM


def k2_fwd_bound_s(batch: int, seq: int, heads: int, causal: bool) -> float:
    """K2-fwd: reads the packed pre-bias qkv [B, S, 3D] and the bias [3D],
    writes out [B, S, D], all bf16; two products."""
    d = heads * HEAD_DIM
    nbytes = BF16 * (batch * seq * 3 * d + 3 * d + batch * seq * d)
    return bound_s(nbytes, attention_ops(batch, seq, heads, causal, 2))


def k2_bwd_bound_s(batch: int, seq: int, heads: int, causal: bool) -> float:
    """K2-bwd: reads qkv [B, S, 3D], the bias [3D] and dout [B, S, D], writes
    dqkv [B, S, 3D], all bf16; five products (the recomputed logits included)."""
    d = heads * HEAD_DIM
    nbytes = BF16 * (batch * seq * 3 * d + 3 * d + batch * seq * d + batch * seq * 3 * d)
    return bound_s(nbytes, attention_ops(batch, seq, heads, causal, 5))


def k1_fwd_bound_s(batch: int, tokens: int, codes: int, depth: int, masked: bool) -> float:
    """K1-fwd: reads q [B, T, D] and the codebook [N, D] (bf16) and the fp32
    keep mask [B, T] when the tower pads, writes the fp32 pooled logits and
    the int32 argmax [B, N]; operations: the [B*T, D] x [D, N] product."""
    nbytes = (BF16 * (batch * tokens * depth + codes * depth)
              + (F32 * batch * tokens if masked else 0) + (F32 + I32) * batch * codes)
    return bound_s(nbytes, 2.0 * batch * tokens * codes * depth)


def k1_dq_bound_s(batch: int, tokens: int, codes: int, depth: int, masked: bool) -> float:
    """K1-bwd dq: reads the codebook, the keep mask, the argmax and the fp32
    gradient [B, N], writes dq [B, T, D]; operations: one routed [N, D] row
    per (sample, code)."""
    nbytes = (BF16 * codes * depth + (F32 * batch * tokens if masked else 0)
              + (I32 + F32) * batch * codes + BF16 * batch * tokens * depth)
    return bound_s(nbytes, 2.0 * batch * codes * depth)


def k1_dsd_bound_s(batch: int, tokens: int, codes: int, depth: int, masked: bool) -> float:
    """K1-bwd dsd: reads q, the keep mask, the argmax and the gradient, writes
    dsd [N, D]; operations as dq."""
    nbytes = (BF16 * batch * tokens * depth + (F32 * batch * tokens if masked else 0)
              + (I32 + F32) * batch * codes + BF16 * codes * depth)
    return bound_s(nbytes, 2.0 * batch * codes * depth)
