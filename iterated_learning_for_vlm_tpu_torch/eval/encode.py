"""Batched encoders: the serving path of the PyTorch port.

Counterpart of ``iterated_learning_for_vlm_tpu/eval/encode.py``'s
``JitEncoder`` for CLIP-FDT and CLIP models: fixed-size batches (a partial
batch is padded, its padding dropped from the result), text context buckets,
the FDT temperature as a run-time float, and L2 normalisation with eps 1e-10
in fp32. CLIP-FDT encodes to its codebook features (``extract_*_sd_ft``),
CLIP to its tower embeddings (``encode_image``, ``encode_text(...)["embed"]``).

``image_batch`` and ``text_batch`` take and return device tensors (one fixed
batch); ``encode_images`` takes PIL images (``preprocess``: the eval
transform, ONECROP by default, on ``num_workers`` threads) or a host numpy
array, ``encode_texts_tokens`` host arrays, of any length. ``encode_texts``
tokenizes strings with the given tokenizer, or with the port's own CLIP
tokenizer (``data/tokenizer.py``) on first use.

``weight_dtype=torch.bfloat16`` is the serving cast (JAX
``serving_cast_params``): a copy of the model whose matmul weights are bf16
once, instead of at every use.

``data_parallel=True`` in a process group of W ranks (JAX ``data_parallel``
over the mesh's data axis; the reference's ``--distributed``): the fixed
batch is rounded up to a multiple of W, each rank encodes its contiguous
slice of every batch and an ``all_gather`` gives every rank the whole batch,
so every rank computes the same metrics. Every rank must then make the same
calls. With no group, or a world of 1, it is the one-device path.
"""
from __future__ import annotations

import copy
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.augment import build_common_augmentation
from ..data.pipeline import pick_context_bucket
from ..models.layers import LayerNorm
from ..parallel.mesh import data_rank_world

# parameters the towers read in fp32 (LayerNorm scales and biases, the logit
# scale, the FDT codebook): JAX ``eval/encode.py:_CAST_KEEP_FP32``
_CAST_KEEP_FP32 = ("ln_", "norm", "bn", "batch", "logit_scale", "space_dict",
                   "running_", "relative_position")


def serving_cast(model, dtype=torch.bfloat16):
    """A copy of ``model`` whose fp32 parameters are cast to ``dtype`` once,
    except those the towers read in fp32: any whose name holds one of
    ``_CAST_KEEP_FP32``, and every ``LayerNorm``'s (the query heads' are named
    ``q_map.0`` / ``q_map.3``). Bit-exact for a model that computes in
    ``dtype``, whose layers cast each such weight at every use
    (``models/layers.py:Linear``); ``model`` itself is left as it is."""
    model_dtype = getattr(model, "dtype", torch.float32)
    if model_dtype != dtype:
        raise ValueError(
            f"weight_dtype={dtype} requires a model computing in that dtype (model dtype is "
            f"{model_dtype}); build the model with dtype: bfloat16 or drop weight_dtype")
    cast = copy.deepcopy(model)
    keep = {f"{m}.{n}" if m else n for m, mod in cast.named_modules()
            if isinstance(mod, LayerNorm) for n, _ in mod.named_parameters(recurse=False)}
    with torch.no_grad():
        for name, p in cast.named_parameters():
            if (p.dtype == torch.float32 and name not in keep
                    and not any(k in name.lower() for k in _CAST_KEEP_FP32)):
                p.data = p.data.to(dtype)
    return cast


class TorchEncoder:
    """Encoder over a CLIP-FDT model (one with an FDT config) or a CLIP model,
    which has no temperature."""

    def __init__(self, model, tokenizer=None, batch_size: int = 64,
                 transform: str = "ONECROP", normalize: bool = True, num_workers: int = 4,
                 text_buckets: Optional[Sequence[int]] = (16, 32), weight_dtype=None,
                 sd_temperature: Optional[float] = None, data_parallel: bool = False):
        if weight_dtype is not None:
            model = serving_cast(model, weight_dtype)
        self.model = model.eval()
        self.is_fdt = hasattr(model, "fdt_cfg")
        self.device = next(model.parameters()).device
        self.tokenizer = None if tokenizer is None else self._checked(tokenizer)
        self.rank, self.world = data_rank_world() if data_parallel else (0, 1)
        # the fixed batch splits evenly over the ranks (JAX encode.py:124-128)
        self.batch_size = -(-batch_size // self.world) * self.world
        self.normalize = normalize
        self.num_workers = max(1, int(num_workers))
        self.context_length = model.text_cfg.context_length
        # the eval transform at the tower's resolution (ONECROP: Resize(256 /
        # 224 of it) -> CenterCrop), to host float32
        self.transform = build_common_augmentation(
            transform, image_size=model.vision_cfg.input_resolution)
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

    def _split(self, fn, *batch: torch.Tensor) -> torch.Tensor:
        """``fn`` over this rank's contiguous rows of ``batch``, its fp32
        output gathered from every rank; ``fn(*batch)`` in a world of 1."""
        if self.world == 1:
            return fn(*batch)
        n = batch[0].shape[0]
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over {self.world} ranks")
        b = n // self.world
        part = fn(*(x[self.rank * b:(self.rank + 1) * b] for x in batch)).contiguous()
        parts = [torch.empty_like(part) for _ in range(self.world)]
        dist.all_gather(parts, part)
        return torch.cat(parts)

    @torch.inference_mode()
    def image_batch(self, images: torch.Tensor, normalize: Optional[bool] = None):
        """One batch of NHWC images on the model's device -> [B, E] fp32."""
        def encode(x):
            if self.is_fdt:
                emb = self.model.extract_img_sd_ft(x, temperature=self.sd_temperature)[1]
            else:
                emb = self.model.encode_image(x)
            return self._finish(emb, normalize)
        return self._split(encode, images)

    @torch.inference_mode()
    def text_batch(self, tokens: torch.Tensor, pad_mask: torch.Tensor,
                   normalize: Optional[bool] = None):
        """One batch of token ids and pad mask on the model's device -> [B, E] fp32."""
        def encode(tok, pad):
            if self.is_fdt:
                emb = self.model.extract_txt_sd_ft(tok, pad, temperature=self.sd_temperature)[1]
            else:
                emb = self.model.encode_text(tok, pad)["embed"]
            return self._finish(emb, normalize)
        return self._split(encode, tokens, pad_mask)

    def preprocess(self, pil_images: Iterable) -> np.ndarray:
        """The eval transform of each image, on ``num_workers`` threads (the
        native augment releases the GIL) -> [N, S, S, 3] float32."""
        pil_images = list(pil_images)
        if self.num_workers > 1 and len(pil_images) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                arrays = list(pool.map(lambda im: self.transform(im, None), pil_images))
        else:
            arrays = [self.transform(im, None) for im in pil_images]
        return np.stack(arrays).astype(np.float32)

    def encode_images(self, images, normalize: Optional[bool] = None) -> np.ndarray:
        """images: a sequence of PIL images, or an [N, H, W, 3] float array
        already transformed -> [N, E] float32."""
        if not isinstance(images, np.ndarray):
            images = self.preprocess(images)
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
