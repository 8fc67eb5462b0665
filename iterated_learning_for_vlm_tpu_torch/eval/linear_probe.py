"""Linear probing.

Parity target: reference ``CLIP_benchmark/clip_benchmark/metrics/
linear_probe.py``: cache frozen features, train a logistic-regression head
with AdamW + cosine LR, optional fewshot-k subsetting and a validation-based
weight-decay sweep; report acc1 / mean-per-class recall.

Counterpart of ``iterated_learning_for_vlm_tpu/eval/linear_probe.py``: the
feature cache, ``fewshot_subset``, the validation split, the weight-decay
sweep and the metrics are copies. The head trains as JAX ``_train_head``
does: full batch (features fit in memory at these scales), fp32, zero init,
momentum 0.9 on the raw gradient and a cosine learning rate, here in PyTorch
on the encoder's device, with the gradient in closed form.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models import resolve_device
from .zeroshot_classification import accuracy_topk, mean_per_class_recall


def probe_cache_paths(prefix: str, split: str):
    return f"{prefix}_{split}_feats.npy", f"{prefix}_{split}_labels.npy"


def probe_cache_complete(prefix: Optional[str], include_val: bool = False) -> bool:
    """True when every needed split's features are on disk (``--skip_load``);
    ``include_val`` when an explicit ``--val_split`` will also be read."""
    if not prefix:
        return False
    splits = ("train", "test", "val") if include_val else ("train", "test")
    return all(os.path.exists(p) for s in splits
               for p in probe_cache_paths(prefix, s))


def _features(encoder, images, labels, prefix: Optional[str], split: str,
              normalize: bool = True):
    """Frozen features, disk-cached under ``feature_root`` when given
    (reference linear_probe.py Featurizer cache: features + targets saved
    per model x dataset x split, reused across WD sweeps and re-runs).
    ``normalize`` mirrors the reference ``--normalize`` flag, which only
    affects the probe featurizer (linear_probe.py:36-44)."""
    labels = np.asarray(labels)
    if prefix:
        fp, lp = probe_cache_paths(prefix, split)
        if os.path.exists(fp) and os.path.exists(lp):
            return np.load(fp), np.load(lp)
    if encoder is None:
        raise ValueError(
            f"--skip_load given but the probe feature cache is incomplete "
            f"(missing {split} split under prefix {prefix!r})")
    feats = encoder.encode_images(images, normalize=normalize)
    if prefix:
        os.makedirs(os.path.dirname(os.path.abspath(fp)), exist_ok=True)
        np.save(fp, feats)
        np.save(lp, labels)
    return feats, labels


def _train_head(
    feats: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    *,
    lr: float = 0.1,
    weight_decay: float = 0.0,
    steps: int = 500,
    seed: int = 0,
    device=None,
):
    """Full-batch logistic regression on ``device`` (default: the CPU);
    returns the weights [D, C] and the bias [C] as numpy arrays. The loss is
    the mean NLL of the log-softmax plus ``weight_decay * sum(w * w)``; its
    gradient is taken in closed form: (softmax - onehot) / N through the
    product, plus 2 * weight_decay * w."""
    device = torch.device("cpu") if device is None else torch.device(device)
    # fp32 products: TF32 would round the features' mantissas to 10 bits,
    # where JAX's head computes in full fp32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.as_tensor(np.asarray(feats, np.float32), device=device)
        y = torch.as_tensor(np.asarray(labels, np.int64), device=device)
        onehot = torch.nn.functional.one_hot(y, num_classes).to(torch.float32)
        n, d = x.shape
        w = torch.zeros((d, num_classes), dtype=torch.float32, device=device)
        b = torch.zeros((num_classes,), dtype=torch.float32, device=device)
        mw, mb = torch.zeros_like(w), torch.zeros_like(b)
        for i in range(steps):
            logp = torch.log_softmax(x @ w + b, dim=-1)
            g = (logp.exp() - onehot) / n
            gw = x.T @ g + (2.0 * weight_decay) * w
            gb = g.sum(0)
            # JAX computes the cosine schedule in float32
            lr_i = np.float32(lr) * np.float32(0.5) * (
                np.float32(1) + np.cos(np.float32(np.pi) * np.float32(i) / np.float32(steps)))
            mw = 0.9 * mw + gw
            mb = 0.9 * mb + gb
            w = w - float(lr_i) * mw
            b = b - float(lr_i) * mb
        return w.cpu().numpy(), b.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def fewshot_subset(labels: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Indices of at most k examples per class (reference fewshot_k)."""
    rng = np.random.default_rng(seed)
    idxs = []
    for c in np.unique(labels):
        cand = np.where(labels == c)[0]
        rng.shuffle(cand)
        idxs.extend(cand[:k])
    return np.sort(np.asarray(idxs))


def evaluate_linear_probe(
    encoder,
    train_images,
    train_labels: np.ndarray,
    test_images,
    test_labels: np.ndarray,
    num_classes: Optional[int] = None,
    fewshot_k: int = -1,
    val_fraction: float = 0.0,
    wd_candidates=(0.0, 1e-6, 1e-4, 1e-2),
    steps: int = 500,
    seed: int = 0,
    lr: float = 0.1,
    feature_cache_prefix: Optional[str] = None,
    val_images=None,
    val_labels=None,
    normalize: bool = True,
    device=None,
) -> Dict[str, float]:
    """``device``: where the head trains; default the encoder's, else the
    CUDA card (``models.resolve_device``, which raises where there is none)."""
    if encoder is not None and device is None:
        device = encoder.device
    device = resolve_device(device)
    train_feats, train_labels = _features(encoder, train_images, train_labels,
                                          feature_cache_prefix, "train", normalize)
    test_feats, test_labels = _features(encoder, test_images, test_labels,
                                        feature_cache_prefix, "test", normalize)
    num_classes = num_classes or int(train_labels.max()) + 1

    if fewshot_k > 0:
        idx = fewshot_subset(train_labels, fewshot_k, seed)
        train_feats, train_labels = train_feats[idx], train_labels[idx]

    # WD search validation set: an explicit val split (reference --val_split)
    # beats the --val_proportion carve-out of train
    val_feats = val_lbls = None
    if val_images is not None:
        val_feats, val_lbls = _features(encoder, val_images, val_labels,
                                        feature_cache_prefix, "val", normalize)
        tr_feats, tr_labels = train_feats, train_labels
    elif val_fraction > 0:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(train_feats))
        n_val = max(1, int(len(perm) * val_fraction))
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        val_feats, val_lbls = train_feats[val_idx], train_labels[val_idx]
        tr_feats, tr_labels = train_feats[tr_idx], train_labels[tr_idx]

    best_wd = wd_candidates[0]
    if val_feats is not None and len(wd_candidates) > 1:
        best_acc = -1.0
        for wd in wd_candidates:
            w, b = _train_head(tr_feats, tr_labels, num_classes,
                               weight_decay=wd, steps=steps, seed=seed, lr=lr,
                               device=device)
            acc = float(np.mean((val_feats @ w + b).argmax(-1) == val_lbls))
            if acc > best_acc:
                best_acc, best_wd = acc, wd

    w, b = _train_head(train_feats, train_labels, num_classes,
                       weight_decay=best_wd, steps=steps, seed=seed, lr=lr,
                       device=device)
    logits = test_feats @ w + b
    metrics = accuracy_topk(logits, test_labels)
    metrics["mean_per_class_recall"] = mean_per_class_recall(logits, test_labels)
    metrics["weight_decay"] = float(best_wd)
    metrics["normalized"] = bool(normalize)  # reference linear_probe.py:307
    return metrics
