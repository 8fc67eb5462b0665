"""Batched encoders: the serving path of the PyTorch port.

Counterpart of ``iterated_learning_for_vlm_tpu/eval/encode.py``'s
``JitEncoder`` for CLIP-FDT and CLIP models: fixed-size batches (a partial
batch is padded, its padding dropped from the result), text context buckets,
the FDT temperature as a run-time float, and L2 normalisation with eps 1e-10
in fp32. CLIP-FDT encodes to its codebook features (``extract_*_sd_ft``),
CLIP to its tower embeddings (``encode_image``, ``encode_text(...)["embed"]``).

``image_batch`` and ``text_batch`` take and return device tensors (one fixed
batch); ``encode_images`` / ``encode_texts_tokens`` take host numpy arrays of
any length. ``encode_texts`` tokenizes strings with the given tokenizer, or
with the port's own CLIP tokenizer (``data/tokenizer.py``) on first use.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def pick_context_bucket(pad_mask, buckets) -> Optional[int]:
    """The smallest bucket below the current context that holds every
    caption, or None (a copy of ``data/pipeline.py:pick_context_bucket``,
    whose module the port cannot import). Pad-mask convention: 0.0 = real
    token (incl. EOT), -inf = pad."""
    pad_mask = np.asarray(pad_mask)
    max_len = int((pad_mask == 0.0).sum(axis=1).max())
    ctx = pad_mask.shape[1]
    for b in sorted(int(x) for x in buckets):
        if max_len <= b <= ctx:
            return None if b == ctx else b
    return None


class TorchEncoder:
    """Encoder over a CLIP-FDT model (one with an FDT config) or a CLIP model,
    which has no temperature."""

    def __init__(self, model, tokenizer=None, batch_size: int = 64, normalize: bool = True,
                 text_buckets: Optional[Sequence[int]] = (16, 32),
                 sd_temperature: Optional[float] = None):
        self.model = model.eval()
        self.is_fdt = hasattr(model, "fdt_cfg")
        self.device = next(model.parameters()).device
        self.tokenizer = None if tokenizer is None else self._checked(tokenizer)
        self.batch_size = batch_size
        self.normalize = normalize
        self.context_length = model.text_cfg.context_length
        self.text_buckets = tuple(sorted(
            {int(b) for b in (text_buckets or ()) if int(b) < self.context_length}
            | {self.context_length}))
        if sd_temperature is None:
            sd_temperature = model.fdt_cfg.sd_temperature if self.is_fdt else 0.0
        self.sd_temperature = float(sd_temperature)

    def _checked(self, tokenizer):
        """An out-of-range token id gathers garbage: refuse a tokenizer whose
        vocabulary outgrows the model's embedding table."""
        vocab = getattr(tokenizer, "vocab_size", None)
        if vocab and vocab > int(self.model.text_cfg.vocab_size):
            raise ValueError(f"tokenizer vocab ({vocab}) exceeds the model's text "
                             f"embedding table ({self.model.text_cfg.vocab_size})")
        return tokenizer

    def _finish(self, emb: torch.Tensor, normalize: Optional[bool]) -> torch.Tensor:
        emb = emb.float()
        if self.normalize if normalize is None else normalize:
            emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-10)
        return emb

    @torch.inference_mode()
    def image_batch(self, images: torch.Tensor, normalize: Optional[bool] = None):
        """One batch of NHWC images on the model's device -> [B, E] fp32."""
        if self.is_fdt:
            _, emb = self.model.extract_img_sd_ft(images, temperature=self.sd_temperature)
        else:
            emb = self.model.encode_image(images)
        return self._finish(emb, normalize)

    @torch.inference_mode()
    def text_batch(self, tokens: torch.Tensor, pad_mask: torch.Tensor,
                   normalize: Optional[bool] = None):
        """One batch of token ids and pad mask on the model's device -> [B, E] fp32."""
        if self.is_fdt:
            _, emb = self.model.extract_txt_sd_ft(tokens, pad_mask,
                                                  temperature=self.sd_temperature)
        else:
            emb = self.model.encode_text(tokens, pad_mask)["embed"]
        return self._finish(emb, normalize)

    def encode_images(self, images: np.ndarray, normalize: Optional[bool] = None) -> np.ndarray:
        """images: [N, H, W, 3] float array -> [N, E] float32."""
        out = []
        bs = self.batch_size
        for i in range(0, len(images), bs):
            chunk = np.asarray(images[i:i + bs], np.float32)
            real = len(chunk)
            if real < bs:
                chunk = np.concatenate([chunk, np.zeros((bs - real,) + chunk.shape[1:],
                                                        np.float32)])
            x = torch.from_numpy(chunk).to(self.device)
            out.append(self.image_batch(x, normalize)[:real].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 1), np.float32)

    def _bucket(self, tokens: np.ndarray, pad_mask: np.ndarray):
        if len(self.text_buckets) <= 1:
            return tokens, pad_mask
        b = pick_context_bucket(pad_mask, self.text_buckets)
        if b is None:
            return tokens, pad_mask
        return tokens[:, :b], pad_mask[:, :b]

    def encode_texts_tokens(self, tokens: np.ndarray, pad_mask: np.ndarray,
                            normalize: Optional[bool] = None) -> np.ndarray:
        """tokens: int [N, ctx]; pad_mask: float [N, ctx] (0 real / -inf pad).
        Each fixed batch runs at the smallest context bucket holding all of
        its captions; a partial batch is padded with copies of its first row,
        which cannot widen the bucket."""
        out = []
        bs = self.batch_size
        for i in range(0, len(tokens), bs):
            tok = np.asarray(tokens[i:i + bs])
            pad = np.asarray(pad_mask[i:i + bs], np.float32)
            real = len(tok)
            if real < bs:
                fill = np.zeros(bs - real, np.int64)
                tok, pad = np.concatenate([tok, tok[fill]]), np.concatenate([pad, pad[fill]])
            tok, pad = self._bucket(tok, pad)
            emb = self.text_batch(torch.from_numpy(np.ascontiguousarray(tok, np.int64))
                                  .to(self.device),
                                  torch.from_numpy(np.ascontiguousarray(pad)).to(self.device),
                                  normalize)
            out.append(emb[:real].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 1), np.float32)

    def encode_texts(self, texts: Sequence[str], normalize: Optional[bool] = None) -> np.ndarray:
        if self.tokenizer is None:
            from ..data.tokenizer import get_tokenizer

            self.tokenizer = self._checked(get_tokenizer())
        tokens, pad_mask = self.tokenizer(list(texts), context_length=self.context_length)
        return self.encode_texts_tokens(np.asarray(tokens), np.asarray(pad_mask), normalize)
