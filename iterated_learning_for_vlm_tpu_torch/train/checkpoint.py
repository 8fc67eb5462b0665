"""Checkpoints of the model and the train state, in the reference's torch format.

Counterpart of ``iterated_learning_for_vlm_tpu/train/checkpoint.py`` (Orbax
there). A checkpoint is what the reference solver saves
(``example/clip_fdt/train_solver.py:521-540``)::

    torch.save({"model": model.state_dict(), "optimizer": {...}, "last_iter": step},
               "{save_dir}/ckpt_{step}.pth.tar")

so the JAX package's ``tools/torch_checkpoint.py:load_reference_checkpoint``
reads a port checkpoint unchanged, and a reference ``.pth.tar`` (DDP's
``module.`` prefixes included) loads here. ``"optimizer"`` holds the AdamW
``mu`` / ``nu`` / ``count`` keyed by the port's parameter names and the IL
state the JAX ``TrainState`` carries: ``trainable``, ``stored_codebook``,
``hold_codebook``, ``ema_buffer`` and ``ema_clip_count``. So, as in JAX, a
resume inside the codebook hold continues bit for bit.

Every ``k_times_every`` steps a copy also goes to ``{save_dir}_k_times``. An
asynchronous save copies every tensor to the host before it returns (the
train step updates the parameters in place right after) and writes on one
background thread, at most one write in flight.

In a process group (``parallel/mesh.py``) every rank holds the same state:
rank 0 alone writes, and every rank restores. A synchronous save ends at a
barrier that opens once the file is whole; after an asynchronous one, every
rank calls ``wait_for_saves`` and then ``parallel.mesh.barrier`` before any
of them reads the file (``Solver.train`` does at its end).
"""
from __future__ import annotations

import os
import re
import threading
from typing import Dict, List, Mapping, Optional, Union

import torch

from ..parallel.mesh import barrier, is_main
from ..tools.torch_checkpoint import jax_path
from .train_state import TrainState

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pth\.tar$")
# the IL and EMA state the optimizer entry carries beside the moments
_STATE_KEYS = ("trainable", "stored_codebook", "hold_codebook", "ema_buffer", "ema_clip_count")

_WRITER: Optional[threading.Thread] = None
_WRITE_ERROR: List[BaseException] = []


def _to_host(x):
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, Mapping):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def checkpoint_dict(model: torch.nn.Module, state: TrainState, step: int) -> Dict:
    """The checkpoint of ``model`` and ``state`` at ``step``, on the host."""
    optimizer = {"mu": state.opt_state["mu"], "nu": state.opt_state["nu"],
                 "count": state.opt_state["count"]}
    optimizer.update({k: getattr(state, k) for k in _STATE_KEYS})
    return {"model": _to_host(model.state_dict()), "optimizer": _to_host(optimizer),
            "last_iter": int(step)}


def _write(ckpt: Dict, targets: List[str]) -> None:
    try:
        for t in targets:
            tmp = t + ".tmp"
            torch.save(ckpt, tmp)
            os.replace(tmp, t)  # a reader never sees a half-written file
    except Exception as e:  # raised again by wait_for_saves
        _WRITE_ERROR.append(e)


def wait_for_saves() -> None:
    """Block until the write in flight is on disk; raise its error, if any."""
    global _WRITER
    if _WRITER is not None:
        _WRITER.join()
        _WRITER = None
    if _WRITE_ERROR:
        raise RuntimeError("checkpoint write failed") from _WRITE_ERROR.pop()


def save_checkpoint(save_dir: str, model: torch.nn.Module, state: TrainState, step: int,
                    k_times_every: int = 0, use_async: bool = False) -> str:
    """Save ``ckpt_{step}.pth.tar`` under ``save_dir`` (and the ``_k_times``
    copy every ``k_times_every`` steps); returns its path. Overwrites a
    checkpoint of the same step, as ``torch.save`` does in the reference.
    Every rank of a process group calls it; rank 0 writes."""
    global _WRITER
    path = os.path.join(os.path.abspath(save_dir), f"ckpt_{step}.pth.tar")
    if not is_main():
        if not use_async:
            barrier()
        return path
    targets = [path]
    if k_times_every and step % k_times_every == 0:
        arch = os.path.abspath(save_dir.rstrip("/") + "_k_times")
        os.makedirs(arch, exist_ok=True)
        targets.append(os.path.join(arch, f"ckpt_{step}.pth.tar"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ckpt = checkpoint_dict(model, state, step)
    wait_for_saves()  # at most one write in flight
    if use_async:
        _WRITER = threading.Thread(target=_write, args=(ckpt, targets), daemon=False)
        _WRITER.start()
    else:
        _write(ckpt, targets)
        wait_for_saves()
        barrier()
    return path


def load_checkpoint(path: str) -> Dict:
    """A checkpoint file as a dict on the host, DDP's ``module.`` prefixes
    stripped from the model's keys (as JAX ``tools/torch_checkpoint.py:34-41``)."""
    wait_for_saves()
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model" not in ckpt:  # a bare state dict
        ckpt = {"model": ckpt}
    ckpt["model"] = {k[len("module."):] if k.startswith("module.") else k: v
                     for k, v in ckpt["model"].items()}
    return ckpt


@torch.no_grad()
def restore_checkpoint(ckpt: Union[str, Mapping], model: torch.nn.Module,
                       state: TrainState) -> TrainState:
    """Load a checkpoint (a path, or a dict from :func:`load_checkpoint`) into
    ``model`` and ``state`` in place, on their device; returns ``state``.
    The model loads strictly. An ``"optimizer"`` entry of another format (a
    reference run's torch AdamW state) leaves the optimizer and IL state as
    they are; ``last_iter`` becomes the state's step."""
    if isinstance(ckpt, str):
        ckpt = load_checkpoint(ckpt)
    model.load_state_dict(ckpt["model"], strict=True)
    opt = ckpt.get("optimizer")
    if isinstance(opt, Mapping) and "mu" in opt:
        for key in ("mu", "nu"):
            if set(opt[key]) != set(state.opt_state[key]):
                raise KeyError(f"checkpoint {key} names differ from the model's: "
                               f"{sorted(set(opt[key]) ^ set(state.opt_state[key]))}")
            for name, t in state.opt_state[key].items():
                t.copy_(opt[key][name])
        state.opt_state["count"] = {n: float(opt["count"][n]) for n in state.opt_state["count"]}
        state.trainable = {n: bool(opt["trainable"][n]) for n in state.trainable}
        device = state.ema_buffer.device
        state.stored_codebook = opt["stored_codebook"].to(device).clone()
        state.hold_codebook = bool(opt["hold_codebook"])
        state.ema_buffer = opt["ema_buffer"].to(device).clone()
        state.ema_clip_count = opt["ema_clip_count"].to(device).clone()
    state.step = int(ckpt.get("last_iter", 0))
    return state


def modify_state(ckpt: Mapping, model: torch.nn.Module, state: TrainState, ignore) -> Dict:
    """Drop pieces of a loaded checkpoint before finetuning (reference
    ``modify_state``, prototype/utils/misc.py:520-533, driven by the
    ``saver.pretrain.ignore`` config): each dropped piece is replaced by the
    fresh ``model`` / ``state``'s, so the load stays strict. ``ignore.key``:
    ``optimizer`` -> fresh AdamW moments and counts, ``last_iter`` -> step 0,
    ``ema`` -> fresh EMA-clamp buffers; ``ignore.model`` lists top-level JAX
    param subtrees (``visual``, ``text``, ``space_dict``, ...) to keep at the
    fresh model's values. Returns the modified checkpoint."""
    keys = set((ignore or {}).get("key", ()) or ())
    ckpt = dict(ckpt)
    fresh = checkpoint_dict(model, state, state.step)
    opt = dict(ckpt.get("optimizer") or fresh["optimizer"])
    if "optimizer" in keys:
        opt.update({k: fresh["optimizer"][k] for k in ("mu", "nu", "count")})
    if "last_iter" in keys:
        ckpt["last_iter"] = 0
    if "ema" in keys:
        opt.update({k: fresh["optimizer"][k] for k in ("ema_buffer", "ema_clip_count")})
    ckpt["optimizer"] = opt
    drop = (ignore or {}).get("model", ()) or ()
    if drop:
        params = dict(ckpt["model"])
        param_names = [n for n, _ in model.named_parameters()]
        for root in drop:
            names = [n for n in param_names if jax_path(n)[0] == root]
            if not names:
                raise KeyError(f"saver.pretrain.ignore.model: no param subtree {root!r}")
            params.update({n: fresh["model"][n] for n in names})
        ckpt["model"] = params
    return ckpt


def find_last_checkpoint(save_dir: str) -> Optional[str]:
    """Auto-resume helper (reference ``prototype/solver/clip_solver.py:179-189``)."""
    if not os.path.isdir(save_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(save_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), os.path.join(save_dir, name)
    return best


def restore_params_soup(paths: List[str], load=None) -> Dict[str, torch.Tensor]:
    """The mean of several checkpoints' model weights, summed in float64
    (reference eval-side soup, ``CLIP_benchmark/models/fdt.py:28-40``), as a
    float32 state dict on the host. ``load(path)`` gives a file's state dict
    (default: :func:`load_checkpoint`'s ``"model"``)."""
    assert paths
    acc = None
    for p in paths:
        sd = load(p) if load is not None else load_checkpoint(p)["model"]
        if acc is None:
            acc = {k: v.double() for k, v in sd.items()}
        else:
            for k, v in sd.items():
                acc[k] += v.double()
    return {k: (v / len(paths)).float() for k, v in acc.items()}
