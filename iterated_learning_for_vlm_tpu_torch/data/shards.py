"""Tar-shard ingestion (webdataset protocol, no dependency).

A copy of ``iterated_learning_for_vlm_tpu/data/shards.py`` (reference
``prototype/data/datasets/clip_dataset_wsd.py``):

- brace-expanded shard lists (``data/cc3m/{00000..00331}.tar``),
- the deterministic shard shuffle keyed on (seed, epoch), ``detshuffle2``
  (clip_dataset_wsd.py:114-143, seed 0 + epoch),
- per-host / per-worker shard splits (``split_by_node`` / ``split_by_worker``),
- throwless tar expansion: corrupt members and samples are skipped, never
  raised (``tarfile_to_samples_nothrow`` / ``log_and_continue``, lines 45-91),
- samples grouped by key = basename up to the first dot, with extension map.

Shard reading is a plain deterministic iterator that ``data/pipeline.py``
wraps with a thread pool; no ``webdataset`` package and no DataLoader workers.
"""
from __future__ import annotations

import io
import random
import re
import tarfile
from typing import Dict, Iterator, List, Sequence

from ..utils.logging import get_logger

logger = get_logger("data.shards")

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shard_pattern(pattern: str) -> List[str]:
    """Expand ``prefix{00000..00331}suffix`` into the shard path list."""
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [
        pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
        for i in range(int(lo), int(hi) + 1)
    ]


def detshuffle(items: Sequence, seed: int, epoch: int) -> List:
    """Deterministic shuffle keyed on (seed, epoch) — reference ``detshuffle2``
    uses ``random.Random(seed + epoch)`` semantics."""
    rng = random.Random(seed + epoch)
    out = list(items)
    rng.shuffle(out)
    return out


def split_shards(shards: Sequence[str], index: int, count: int) -> List[str]:
    """Round-robin split (reference ``split_by_node``/``split_by_worker``)."""
    return list(shards)[index::count]


def sample_shard_paths(all_shards: Sequence[str], sample_factor: int, seed: int = 0) -> List[str]:
    """Random 1/``sample_factor`` subset of shards (reference
    ``sample_shard_paths``, clip_dataset_wsd.py:278-298 — without the
    hardcoded cluster base path)."""
    rng = random.Random(seed)
    n = max(1, len(all_shards) // sample_factor)
    return rng.sample(list(all_shards), n)


def iter_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Yield dicts ``{"__key__": str, ext: bytes, ...}`` grouped by key.

    Throwless: unreadable shards/members are logged and skipped.
    """
    try:
        tf = tarfile.open(path, mode="r|*")
    except (OSError, tarfile.TarError) as e:
        logger.warning("skipping unreadable shard %s: %s", path, e)
        return
    current_key = None
    sample: Dict[str, bytes] = {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            base = name.split("/")[-1]
            if "." not in base:
                continue
            key, ext = base.split(".", 1)
            try:
                data = tf.extractfile(member).read()
            except Exception as e:  # pragma: no cover - corrupt member
                logger.warning("skipping corrupt member %s in %s: %s", name, path, e)
                continue
            if key != current_key:
                if sample and current_key is not None:
                    yield sample
                current_key = key
                sample = {"__key__": key}
            sample[ext.lower()] = data
        if sample and current_key is not None:
            yield sample
    except (OSError, tarfile.TarError) as e:  # pragma: no cover
        logger.warning("shard %s truncated: %s", path, e)
    finally:
        tf.close()


def write_tar_shard(path: str, samples: Iterator[Dict[str, bytes]]):
    """Write samples to a wds-style tar (used by tests + the wds exporter)."""
    with tarfile.open(path, "w") as tf:
        for sample in samples:
            key = sample["__key__"]
            for ext, data in sample.items():
                if ext == "__key__":
                    continue
                info = tarfile.TarInfo(name=f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
