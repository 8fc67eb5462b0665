"""Captioning eval task.

A copy of ``iterated_learning_for_vlm_tpu/eval/captioning.py`` (numpy float32
scores of the encoder's embeddings, as there).

Parity target: reference ``CLIP_benchmark/clip_benchmark/metrics/captioning.py``
(dispatched at ``cli.py:405-406``): generate one caption per image, score the
corpus with BLEU/ROUGE-L/CIDEr against the references.

The reference path assumes a generative model (``model.generate`` — CoCa).
The dual-encoder models of this framework have no decoder, so the default
generator is *retrieval-based*: the caption for an image is the
highest-cosine candidate from a caption pool (by default the union of all
reference captions — the standard retrieval-captioning protocol).  Models
that do expose a ``generate_fn(images) -> List[str]`` plug straight in.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from .caption_metrics import score_captions


def retrieval_generator(encoder, candidates: Sequence[str],
                        batch_size: int = 256) -> Callable:
    """Build ``generate(images) -> captions`` that picks the best candidate
    caption per image by cosine similarity."""
    cand = list(candidates)
    cand_emb = encoder.encode_texts(cand)  # [C, D], L2-normalized

    def generate(images) -> List[str]:
        img_emb = encoder.encode_images(images)  # [B, D]
        picks = []
        for i in range(0, len(img_emb), batch_size):
            scores = img_emb[i:i + batch_size] @ cand_emb.T
            picks.extend(int(j) for j in np.argmax(scores, axis=1))
        return [cand[j] for j in picks]

    return generate


def evaluate_captioning(
    encoder,
    images,
    captions_per_image: List[List[str]],
    candidates: Optional[Sequence[str]] = None,
    generate_fn: Optional[Callable] = None,
) -> dict:
    """Returns {Bleu_1..4, ROUGE_L, CIDEr} (reference metric JSON keys)."""
    if generate_fn is None:
        if candidates is None:
            candidates = sorted({c for caps in captions_per_image for c in caps})
        generate_fn = retrieval_generator(encoder, candidates)
    generated = generate_fn(images)
    assert len(generated) == len(captions_per_image)
    return score_captions(generated, captions_per_image)
