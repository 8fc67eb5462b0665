"""Codebook activation visualization.

Counterpart of ``iterated_learning_for_vlm_tpu/tools/visualization.py``: the
tracker, sweeps and renderers are copies (numpy and PIL, so the same inputs
give the same PNG and JSON bytes); :func:`text_attention_maps` and
:func:`dump_text_attention` take a port text tower (or a CLIP / CLIP-FDT,
whose text tower is ``encode_text``) in place of a flax module and its
variables, and run it on the tower's device.

Parity target: reference ``example/clip_fdt/visualization.py:268-400``: sweep
a dataset keeping the top-k images/texts per codebook entry by attention
weight, and render per-code PNG grids with a bilinear-upsampled patch-level
attention heatmap overlaid on each image.
"""
from __future__ import annotations

import heapq
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
from PIL import Image

from ..data.augment import IMAGENET_MEAN, IMAGENET_STD


def _denormalize(img: np.ndarray) -> np.ndarray:
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x * 255, 0, 255).astype(np.uint8)


def heatmap_overlay(image: np.ndarray, patch_att: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """image: [H, W, 3] uint8; patch_att: [g, g] attention over patches.
    Bilinear-upsample the grid to HxW and blend a red heatmap."""
    h, w = image.shape[:2]
    att = patch_att - patch_att.min()
    att = att / (att.max() + 1e-8)
    att_img = Image.fromarray((att * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR)
    att_arr = np.asarray(att_img, dtype=np.float32)[..., None] / 255.0
    heat = np.zeros_like(image, dtype=np.float32)
    heat[..., 0] = 255.0
    out = image.astype(np.float32) * (1 - alpha * att_arr) + heat * (alpha * att_arr)
    return out.astype(np.uint8)


class TopKCodeTracker:
    """Keep per-code top-k (weight, payload) across a streaming sweep."""

    def __init__(self, num_codes: int, k: int = 20):
        self.k = k
        self.heaps: List[list] = [[] for _ in range(num_codes)]
        self._counter = 0

    def update(self, att_weight: np.ndarray, payloads: List):
        """att_weight: [B, num_codes]; payloads: list of B opaque items."""
        top_codes = np.argsort(-att_weight, axis=-1)[:, : self.k]
        for b, payload in enumerate(payloads):
            for code in top_codes[b]:
                w = float(att_weight[b, code])
                if w <= 0:
                    continue
                h = self.heaps[code]
                self._counter += 1
                entry = (w, self._counter, payload)
                if len(h) < self.k:
                    heapq.heappush(h, entry)
                elif w > h[0][0]:
                    heapq.heapreplace(h, entry)

    def top(self, code: int) -> List[Tuple[float, object]]:
        return [(w, p) for w, _, p in sorted(self.heaps[code], reverse=True)]

    def active_codes(self, min_items: int = 1) -> List[int]:
        return [i for i, h in enumerate(self.heaps) if len(h) >= min_items]


def sweep_image_codes(
    encoder_fn,
    batches: Iterable[Dict[str, np.ndarray]],
    num_codes: int,
    k: int = 20,
) -> TopKCodeTracker:
    """encoder_fn(images) -> (token_att [B, T, C], att_weight [B, C]).
    Tracks (image, patch attention map) payloads per code."""
    tracker = TopKCodeTracker(num_codes, k)
    for batch in batches:
        token_att, att_weight = encoder_fn(batch["image"])
        token_att = np.asarray(token_att)
        att_weight = np.asarray(att_weight)
        payloads = [
            (batch["image"][b], token_att[b]) for b in range(len(att_weight))
        ]
        tracker.update(att_weight, payloads)
    return tracker


def render_code_grid(
    tracker: TopKCodeTracker,
    code: int,
    out_dir: str,
    cell: int = 112,
    cols: int = 5,
) -> Optional[str]:
    """Write a PNG grid of the top images for one code with heatmap overlays."""
    entries = tracker.top(code)
    if not entries:
        return None
    os.makedirs(out_dir, exist_ok=True)
    rows = (len(entries) + cols - 1) // cols
    canvas = Image.new("RGB", (cols * cell, rows * cell), "white")
    for i, (w, (img, token_att)) in enumerate(entries):
        rgb = _denormalize(np.asarray(img))
        g = int(np.sqrt(token_att.shape[0]))
        patch_map = token_att[: g * g, code].reshape(g, g)
        tile = heatmap_overlay(rgb, patch_map)
        tile_img = Image.fromarray(tile).resize((cell, cell), Image.BILINEAR)
        canvas.paste(tile_img, ((i % cols) * cell, (i // cols) * cell))
    path = os.path.join(out_dir, f"code_{code:05d}.png")
    canvas.save(path)
    return path


def sweep_text_codes(
    encoder_fn,
    batches: Iterable[Dict[str, np.ndarray]],
    texts_per_batch: Iterable[List[str]],
    num_codes: int,
    k: int = 20,
) -> TopKCodeTracker:
    """Track the top captions per code (reference visualization.py:352-400)."""
    tracker = TopKCodeTracker(num_codes, k)
    for batch, texts in zip(batches, texts_per_batch):
        _, att_weight = encoder_fn(batch["tokens"], batch["pad_mask"])
        tracker.update(np.asarray(att_weight), list(texts))
    return tracker


def dump_text_codes(tracker: TopKCodeTracker, out_path: str, min_items: int = 3):
    import json

    out = {}
    for code in tracker.active_codes(min_items):
        out[code] = [{"weight": w, "text": t} for w, t in tracker.top(code)]
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    return out_path


# -- per-layer self-attention visualization ---------------------------------
# Parity target: reference ``prototype/tools/text_visualize.py:44-79`` — it
# registers forward hooks on every text block's MHA, encodes captions, and
# saves one attention-matrix image per (caption, layer).  Here the towers
# expose per-layer probs directly (``return_attn``), no hooks needed.

def text_attention_maps(model, tokens, pad_mask=None) -> np.ndarray:
    """Per-layer head-averaged text self-attention probs [L, B, S, S].
    ``model``: a ``TextTransformer``, or a model whose text tower is
    ``encode_text``; ``tokens`` / ``pad_mask``: arrays or tensors."""
    import torch

    tower = getattr(model, "encode_text", model)
    dev = next(tower.parameters()).device
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
    if pad_mask is not None:
        pad_mask = torch.as_tensor(np.asarray(pad_mask, np.float32), device=dev)
    with torch.inference_mode():
        out = tower(tokens, pad_mask, return_attn=True)
    return out["attn_weights"].float().cpu().numpy()


def render_attention_map(attn: np.ndarray, out_path: str,
                         cell: int = 24) -> str:
    """Save one [S, S] attention matrix as a red/blue heatmap PNG.

    Mirrors the reference's per-layer ``plt.imshow(..., 'RdBu')`` dump
    (``text_visualize.py:72-79``) including its row renormalisation by the
    causal context length (row i is a distribution over i+1 tokens; scaling
    by (i+1) makes rows comparable).
    """
    s = attn.shape[0]
    renorm = (np.arange(s, dtype=np.float32) + 1.0)[:, None]
    a = attn * renorm
    a = a / max(float(a.max()), 1e-9)  # [0, 1]
    # blue (low) -> white -> red (high)
    r = np.clip(2.0 * a, 0, 1)
    b = np.clip(2.0 * (1.0 - a), 0, 1)
    g = np.minimum(r, b)
    rgb = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    img = Image.fromarray(rgb).resize((s * cell, s * cell), Image.NEAREST)
    img.save(out_path)
    return out_path


def dump_text_attention(model, tokens, pad_mask, out_dir: str,
                        max_captions: int = 8) -> List[str]:
    """Per-(caption, layer) attention PNGs, trimmed to each caption's real
    length (reference ``text_vis_id_XXX_layer_YY.jpg`` naming)."""
    os.makedirs(out_dir, exist_ok=True)
    attn = text_attention_maps(model, tokens, pad_mask)
    n_layers, bsz = attn.shape[0], attn.shape[1]
    lengths = (
        np.asarray(pad_mask == 0).sum(-1).astype(int)
        if pad_mask is not None else [attn.shape[-1]] * bsz
    )
    paths = []
    for i in range(min(bsz, max_captions)):
        n = int(lengths[i])
        for layer in range(n_layers):
            p = os.path.join(out_dir, f"text_vis_id_{i:03d}_layer_{layer:02d}.png")
            paths.append(render_attention_map(attn[layer, i, :n, :n], p))
    return paths
