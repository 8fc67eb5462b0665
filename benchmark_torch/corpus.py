"""The eval cell's JPEG image set, made once per checkout.

Each image is a random block pattern plus noise, written with Pillow, so no
download is needed. The set depends only on the traffic's ``corpus_seed``
(never on ``--seed``), so every run of a cell reads the same bytes. It is
written in parallel (spawned processes) into ``benchmark_torch/corpus/<name>/``
and marked complete by a ``DONE`` file written last, which holds the spec it
was written from; a later run with the same spec finds it there.
"""
from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

CORPUS_DIR = Path(__file__).resolve().parent / "corpus"


def _parallel(fn, calls: list) -> None:
    """``fn(*args)`` for each of ``calls`` in spawned processes, one per core
    at most; every result is read, so a worker's failure raises here."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(len(calls), os.cpu_count() or 1), mp_context=ctx) as pool:
        for future in [pool.submit(fn, *args) for args in calls]:
            future.result()


def _complete(root: Path, spec: dict) -> bool:
    """Whether ``root`` holds a whole corpus written from this very ``spec``."""
    done = root / "DONE"
    return done.is_file() and done.read_text() == json.dumps(spec, sort_keys=True)


def _mark(root: Path, spec: dict) -> None:
    (root / "DONE").write_text(json.dumps(spec, sort_keys=True))


def write_images(spec: dict, first: int, count: int, root: str) -> None:
    """Images ``first`` .. ``first + count - 1`` of an eval image set, as
    ``<index>.jpg`` files: random block patterns plus noise at
    ``width`` x ``height``."""
    from PIL import Image

    for i in range(first, first + count):
        rng = np.random.default_rng((spec["corpus_seed"], i))
        grid = rng.standard_normal((spec["grid"], spec["grid"], 3)).astype(np.float32)
        img = np.kron(grid, np.ones((spec["height"] // spec["grid"] + 1,
                                     spec["width"] // spec["grid"] + 1, 1), np.float32))
        img = img[:spec["height"], :spec["width"]]
        img = img + spec["noise"] * rng.standard_normal(img.shape).astype(np.float32)
        pixels = np.clip((img * 0.25 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        path = os.path.join(root, f"{i:06d}.jpg")
        Image.fromarray(pixels).save(f"{path}.part", format="JPEG",
                                     quality=spec["jpeg_quality"])
        os.replace(f"{path}.part", path)


def ensure_images(spec: dict) -> list:
    """The paths of an eval image set's ``count`` JPEGs, writing the set
    first (in parallel, spawned processes) if it is not complete."""
    root = CORPUS_DIR / spec["name"]
    paths = [str(root / f"{i:06d}.jpg") for i in range(spec["count"])]
    if not _complete(root, spec):
        root.mkdir(parents=True, exist_ok=True)
        step = -(-spec["count"] // (os.cpu_count() or 1))
        _parallel(write_images, [(spec, s, min(step, spec["count"] - s), str(root))
                                 for s in range(0, spec["count"], step)])
        _mark(root, spec)
    return paths
