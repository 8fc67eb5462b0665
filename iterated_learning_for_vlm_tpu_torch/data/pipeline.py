"""CC3M image-text training pipeline: tar shards to batches on the device.

Counterpart of ``iterated_learning_for_vlm_tpu/data/pipeline.py`` (reference
``prototype/data/datasets/clip_dataset_wsd.py:158-240``, ``get_wds_dataset``):
shard list -> deterministic (seed, epoch) shard shuffle -> per-node split ->
throwless tar expansion -> 5000-sample buffer shuffle -> decode -> augment ->
tokenize -> fixed-size batches, with the same ``with_epoch`` sizing and a
``DataInfo(set_epoch)`` handle. For the same config, seed, epoch and rank the
batches are the JAX package's, array for array.

- Decode and augment run in a thread pool (the native augment releases the
  GIL); tokenization happens here, into fixed-shape int32 batches.
- Context buckets: a batch whose captions all fit a smaller bucket is cut to
  it (:func:`bucket_context`), so the text tower runs at that length.
- :func:`prefetch_to_device` is the device half: a producer thread copies
  each batch from pinned host memory on its own CUDA stream while the step
  runs, and the consumer normalises the uint8 wire on the device
  (:func:`normalize_device_batch`).

Not ported yet: the hard-negative loader and MLM masking (ROADMAP.md Queue 1
item 6) and the multi-host synced buckets (item 5, with DDP); they raise.
"""
from __future__ import annotations

import collections
import functools
import io
import json
import queue as queue_mod
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..utils.logging import get_logger
from .augment import _NORM_OFFSET, _NORM_SCALE, build_common_augmentation
from .shards import detshuffle, expand_shard_pattern, iter_tar_samples, split_shards
from .tokenizer import get_tokenizer

logger = get_logger("data.pipeline")

SHUFFLE_BUFFER = 5000  # reference detshuffle2 buffer consts (lines 108-111)
IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")
TEXT_EXTS = ("txt", "text", "caption", "json")
# every context-length-shaped batch key
_TOKEN_KEYS = ("tokens", "pad_mask", "mlm_labels")
_IMAGE_KEYS = ("image", "image_v2")


@dataclass
class DataInfo:
    """Reference ``DataInfo(dataloader, shared_epoch)`` equivalent."""

    loader_fn: Callable[[int], Iterator[Dict[str, np.ndarray]]]
    num_batches: int
    num_samples: int

    def __post_init__(self):
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    @property
    def dataloader(self):
        return self.loader_fn(self._epoch)


def _sizing(num_samples: int, batch_size: int, world_size: int, workers: int):
    """Reference sizing math (clip_dataset_wsd.py:213-223)."""
    global_batch = batch_size * world_size
    num_batches = num_samples // global_batch
    workers = max(1, workers)
    num_worker_batches = num_batches // workers
    num_batches = num_worker_batches * workers
    return num_batches, num_batches * global_batch


# JPEG draft decode: libjpeg downscales in the DCT domain (1/2, 1/4, 1/8)
# while decoding, far cheaper than a full decode and a resize for large
# CC3M-style images. The train augment crops at 224, so asking for >= 2x the
# crop (448) keeps RandomResizedCrop's quality. No-op for non-JPEG and for
# images already smaller than the target.
_DRAFT_TARGET = 448


def _decode_image(sample: Dict[str, bytes]):
    """The sample's image as an RGB PIL image, or None if it has none or it
    does not decode."""
    from PIL import Image

    for ext in IMAGE_EXTS:
        if ext in sample:
            try:
                img = Image.open(io.BytesIO(sample[ext]))
                if img.format == "JPEG":
                    img.draft("RGB", (_DRAFT_TARGET, _DRAFT_TARGET))
                return img.convert("RGB")
            except Exception:  # noqa: BLE001 — a corrupt sample is skipped, as in JAX
                return None
    return None


def _decode_text(sample: Dict[str, bytes]) -> Optional[str]:
    for ext in TEXT_EXTS:
        if ext in sample:
            try:
                raw = sample[ext].decode("utf-8")
            except UnicodeDecodeError:
                return None
            if ext == "json":
                try:
                    obj = json.loads(raw)
                    return obj.get("caption") or obj.get("text")
                except (ValueError, AttributeError):
                    return None
            return raw
    return None


def _buffered_shuffle(it: Iterator, buffer: int, rng: random.Random) -> Iterator:
    buf: List = []
    for item in it:
        if len(buf) < buffer:
            buf.append(item)
            continue
        idx = rng.randrange(len(buf))
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


def _bucket_for_len(max_len: int, ctx: int, buckets) -> Optional[int]:
    for b in sorted(int(x) for x in buckets):
        if max_len <= b <= ctx:
            return None if b == ctx else b
    return None


def pick_context_bucket(pad_mask, buckets) -> Optional[int]:
    """The smallest bucket (< the current context) that holds every caption,
    or None when no cut applies (overflow, or only the full context fits).
    The one definition of the bucket choice, shared by the train pipeline
    (:func:`bucket_context`) and the serving encoder (``eval/encode.py``).
    Pad-mask convention: 0.0 = real token (incl. EOT), -inf = pad."""
    pad_mask = np.asarray(pad_mask)
    max_len = int((pad_mask == 0.0).sum(axis=1).max())
    return _bucket_for_len(max_len, pad_mask.shape[1], buckets)


def bucket_context(batch: Dict[str, np.ndarray], buckets) -> Dict[str, np.ndarray]:
    """Cut the batch's token keys to the smallest context bucket that holds
    every caption. Exact: under the causal mask the EOT feature depends only
    on positions <= EOT, and every other consumer of token features (the FDT
    codebook pooling) is pad-masked, so dropping all-pad tail columns changes
    no output. CC3M captions average ~12 BPE tokens, so a [32, 77] pair runs
    most batches at ctx 32."""
    if not buckets:
        return batch
    b = pick_context_bucket(batch["pad_mask"], buckets)
    if b is None:
        return batch
    out = dict(batch)
    for key in _TOKEN_KEYS:
        if key in out:
            out[key] = np.ascontiguousarray(out[key][:, :b])
    return out


@functools.lru_cache(maxsize=None)
def _norm_constants(device: torch.device):
    return (torch.from_numpy(_NORM_SCALE).to(device), torch.from_numpy(_NORM_OFFSET).to(device))


def normalize_device_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The uint8 wire's device half: ``x.float() * scale + offset`` on the
    tensor's device for the uint8 image keys (``augment._NORM_SCALE`` /
    ``_NORM_OFFSET``), the multiply and the add rounded apart as the host
    float path rounds them; the float32 wire passes through."""
    out = batch
    for k in _IMAGE_KEYS:
        v = batch.get(k)
        if v is not None and v.dtype == torch.uint8:
            if out is batch:
                out = dict(batch)
            scale, offset = _norm_constants(v.device)
            out[k] = v.float() * scale + offset
    return out


def get_wds_dataset(
    cfg,
    world_size: int = 1,
    rank: int = 0,
    tokenizer=None,
    shuffle: bool = True,
    seed: int = 0,
) -> DataInfo:
    """Build the training DataInfo from a reference-style ``data.train`` cfg
    (keys: data_path, transforms, num_samples, num_shards, workers,
    batch_size; ``config_cc3m.yaml:67-75``); ``shuffle=False`` gives the
    unshuffled visualization loader (clip_dataset_wsd.py:443-506).

    ``world_size`` / ``rank`` split the shards (and, as in JAX, turn the
    in-loader context buckets off: a bucket must then be agreed across
    processes)."""
    data_path = cfg["data_path"]
    shards = (
        expand_shard_pattern(data_path) if isinstance(data_path, str) else list(data_path)
    )
    batch_size = int(cfg["batch_size"])
    workers = int(cfg.get("workers", 4))
    num_samples = int(cfg.get("num_samples", 0))
    if not num_samples:
        # No ground truth for the epoch length: estimate 1000 samples a shard
        # (the wds convention). A wrong estimate skews epoch accounting and LR
        # schedules, so say so.
        num_samples = len(shards) * 1000
        logger.warning(
            "data.train.num_samples not set; ESTIMATING %d (= %d shards * 1000). "
            "Set num_samples to the real dataset size for correct epoch/LR accounting.",
            num_samples, len(shards),
        )
    transforms_name = cfg.get("transforms", "MOCOV2_single")
    # uint8 wire (default): augmented pixels cross to the device as uint8 and
    # are normalized there (prefetch_to_device), within 1 fp32 ulp of the
    # float32 wire at 1/4 of the bytes; wire_dtype: float32 restores the
    # host-normalized wire.
    wire_dtype = str(cfg.get("wire_dtype", "uint8"))
    if wire_dtype not in ("uint8", "float32"):
        raise ValueError(f"data.train.wire_dtype must be uint8|float32, "
                         f"got {wire_dtype!r}")
    wire_u8 = wire_dtype == "uint8"
    # two augmented views per image (the reference's TwoCropsTransform for
    # the MOCOV2 / SIMCLR / SIMSIAM recipes, which DeCLIP's SimSiam branch reads)
    two_views = bool(cfg.get("two_views",
                             transforms_name in ("MOCOV2", "SIMCLR", "SIMSIAM")))
    if two_views:
        raise NotImplementedError(
            f"two_views (transforms {transforms_name!r}: the DeCLIP recipes' second view) "
            "is not ported to the PyTorch package yet (ROADMAP.md Queue 1 item 6, recipes)")
    if cfg.get("mask_type"):
        raise NotImplementedError(
            f"mask_type {cfg.get('mask_type')!r} (MLM masking, data/mask_tokens.py) is not "
            "ported to the PyTorch package yet (ROADMAP.md Queue 1 item 6, recipes)")
    augment = build_common_augmentation(transforms_name,
                                        image_size=int(cfg.get("image_size", 0)),
                                        out_u8=wire_u8)
    tokenizer = tokenizer or get_tokenizer()
    context_length = int(cfg.get("context_length", 77))
    context_buckets = cfg.get("context_buckets") or ()
    if context_buckets and world_size > 1:
        if cfg.get("context_buckets_sync", False):
            raise NotImplementedError(
                "data.train.context_buckets_sync across processes (the per-batch bucket "
                "agreement) comes with DDP (ROADMAP.md Queue 1 item 5)")
        logger.warning(
            "data.train.context_buckets disabled: %d-way host sharding needs a per-step "
            "cross-host shape agreement", world_size)
        context_buckets = ()

    num_batches, sized_samples = _sizing(num_samples, batch_size, world_size, workers)

    def loader(epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        epoch_shards = detshuffle(shards, seed, epoch) if shuffle else list(shards)
        my_shards = split_shards(epoch_shards, rank, world_size)
        if not my_shards:
            my_shards = list(epoch_shards)
        rng = random.Random((seed + 1) * 1000003 + epoch * 101 + rank)
        aug_rng = np.random.default_rng((seed, epoch, rank, 7))

        def samples() -> Iterator:
            while True:  # loop the shards so every epoch fills num_batches
                for shard in my_shards:
                    yield from iter_tar_samples(shard)
                if not shuffle:
                    break

        def decoded() -> Iterator:
            stream = samples()
            if shuffle:
                stream = _buffered_shuffle(stream, SHUFFLE_BUFFER, rng)
            pool = ThreadPoolExecutor(max_workers=max(1, workers))

            # Per-sample seeds are drawn HERE (the submitting thread) and each
            # worker builds its own Generator: numpy Generators are not
            # thread-safe, and sharing one would make the augment stream
            # depend on thread scheduling.
            def work(sample, sample_seed):
                img = _decode_image(sample)
                txt = _decode_text(sample)
                if img is None or txt is None:
                    return None
                return augment(img, np.random.default_rng(sample_seed)), txt

            window: collections.deque = collections.deque()
            try:
                for sample in stream:
                    window.append(pool.submit(work, sample, int(aug_rng.integers(2**63))))
                    if len(window) >= workers * 2:
                        result = window.popleft().result()
                        if result is not None:
                            yield result
                while window:
                    result = window.popleft().result()
                    if result is not None:
                        yield result
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        produced = 0
        images: List[np.ndarray] = []
        texts: List[str] = []
        for img_arr, txt in decoded():
            images.append(img_arr)
            texts.append(txt)
            if len(images) == batch_size:
                tokens, pad_mask = tokenizer(texts, context_length=context_length)
                batch = {
                    "image": np.stack(images).astype(np.uint8 if wire_u8 else np.float32),
                    "tokens": tokens,
                    "pad_mask": pad_mask,
                }
                yield bucket_context(batch, context_buckets)
                images, texts = [], []
                produced += 1
                if produced >= num_batches:
                    return

    return DataInfo(loader_fn=loader, num_batches=num_batches, num_samples=sized_samples)


def get_neg_wds_dataset(cfg, world_size=1, rank=0, tokenizer=None, seed=0) -> DataInfo:
    """The hard-negative caption loader (reference ``get_neg_wds_dataset``,
    clip_dataset_wsd.py:355-436): not ported yet."""
    raise NotImplementedError(
        "the hard-negative caption loader (data/hard_negatives.py) is not ported to the "
        "PyTorch package yet (ROADMAP.md Queue 1 item 6, recipes)")


def get_unshuffled_wds_dataset(cfg, world_size=1, rank=0, tokenizer=None) -> DataInfo:
    """Unshuffled loader for visualization and analysis passes (reference
    clip_dataset_wsd.py:443-506). It defaults to the float32 wire: analysis
    consumers iterate ``DataInfo.dataloader`` without
    :func:`prefetch_to_device`, the only place the uint8 wire is normalized."""
    cfg = dict(cfg)
    cfg.setdefault("wire_dtype", "float32")
    return get_wds_dataset(cfg, world_size, rank, tokenizer, shuffle=False)


class _ProducerFailure:
    """Exception carrier from the prefetch producer thread to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(iterator: Iterator[Dict[str, np.ndarray]], device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage up to ``size`` batches of numpy arrays ahead on ``device``.

    One daemon producer thread draws from ``iterator`` (the host's decode and
    augment run there, beside the train step) and puts the batches into a
    bounded queue. On a CUDA device it copies each array into pinned host
    memory and on to the device with ``non_blocking=True`` on a stream of
    its own, and queues the tensors with an event recorded after the copies;
    the consumer makes its current stream wait on that event and calls
    ``record_stream`` on each tensor, so the allocator keeps the memory until
    the consumer's work is done. On the CPU the tensors are
    ``torch.from_numpy`` views. Then :func:`normalize_device_batch`.

    A producer exception is raised on the consumer with its traceback; a
    consumer that stops early releases the producer, which calls the
    iterator's ``close()``; the stream ends exactly where the iterator does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"prefetch_to_device({device}): no CUDA device")
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = object()
    abandoned = threading.Event()  # the consumer dropped the stream early

    def _put(item) -> bool:
        # bounded put that wakes to see whether the consumer is gone, so an
        # abandoned stream releases this thread, the loader's pool and its
        # open shards instead of blocking in q.put for the process lifetime
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            stream = torch.cuda.Stream(device) if device.type == "cuda" else None
            for batch in iterator:
                if stream is None:
                    item = ({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                            None)
                else:
                    with torch.cuda.stream(stream):
                        out = {k: torch.from_numpy(np.asarray(v)).pin_memory()
                               .to(device, non_blocking=True) for k, v in batch.items()}
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    item = (out, ready)
                if not _put(item):
                    return
            _put(stop)
        except BaseException as exc:  # noqa: BLE001 — re-raised on the consumer
            # never end the epoch silently: a swallowed loader failure would
            # shorten the run without a word
            _put(_ProducerFailure(exc))
        finally:
            if abandoned.is_set():
                close = getattr(iterator, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 — best-effort cleanup
                        logger.warning("closing the abandoned loader failed", exc_info=True)

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, _ProducerFailure):
                raise item.exc  # original traceback preserved (__traceback__)
            batch, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for t in batch.values():
                    t.record_stream(current)
            yield normalize_device_batch(batch)
    finally:
        abandoned.set()
