"""Logging and metric sinks.

Counterpart of ``iterated_learning_for_vlm_tpu/utils/logging.py`` (reference
``prototype/utils/misc.py:96-128`` and the rank-0 wandb logging of
``example/clip_fdt/train_solver.py:169-183``): a stderr + ``log.txt`` logger
and a JSON-lines metric writer, one ``{"ts": .., "step": .., "<name>": ..}``
object per line.

Where the JAX logger takes its file only on the first call in a process,
:func:`create_logger` here points the file handler at each new ``log_file``,
so every solver built in one process writes its own ``log.txt``. The logger
is named ``ilvlm_torch``, apart from the JAX package's.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Mapping

_LOGGER_NAME = "ilvlm_torch"
_FORMAT = logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s",
                            "%m-%d %H:%M:%S")


def create_logger(log_file: str | None = None, level=logging.INFO) -> logging.Logger:
    """The framework logger, writing to stderr and, from this call on, to
    ``log_file`` when one is given (replacing an earlier file)."""
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(level)
    logger.propagate = False
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(_FORMAT)
        logger.addHandler(sh)
    if log_file:
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(_FORMAT)
        logger.addHandler(fh)
    return logger


def get_logger(name: str | None = None) -> logging.Logger:
    if name:
        return logging.getLogger(_LOGGER_NAME).getChild(name)
    return logging.getLogger(_LOGGER_NAME)


class MetricsWriter:
    """Append-only JSONL metric sink (stand-in for the reference's wandb use).

    Every ``log`` call writes one JSON object with a wall-clock timestamp and
    the training step, e.g.::

        {"ts": 1699999999.5, "step": 100, "loss_all": 4.2, "lr": 1e-4}
    """

    def __init__(self, path: str | None, enabled: bool = True):
        self.path = path
        self.enabled = enabled and path is not None
        self._fh = None
        if self.enabled:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, metrics: Mapping[str, Any], step: int | None = None):
        if not self.enabled:
            return
        rec = {"ts": round(time.time(), 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            rec[k] = _to_scalar(v)
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _to_scalar(v):
    """A one-element tensor or array, or a numpy scalar, as a Python number;
    other plain values as they are, anything else as its string."""
    numel = getattr(v, "numel", None)  # torch tensors (``size`` is a method there)
    if callable(numel) and numel() == 1:
        return v.item()
    if hasattr(v, "item") and getattr(v, "size", None) == 1:  # numpy arrays and scalars
        return v.item()
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)
