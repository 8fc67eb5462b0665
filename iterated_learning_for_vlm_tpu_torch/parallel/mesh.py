"""The data axis across processes: the process group, ranks and devices.

Counterpart of the ``data`` axis of ``iterated_learning_for_vlm_tpu/parallel/mesh.py``.
JAX runs one SPMD program over a device mesh; the port runs one process per
rank in a ``torch.distributed`` process group, each with its own device and
its own rows of the global batch, and the train step averages the
gradients (``train/step.py``; the Solver's ``DistributedDataParallel``
wrapper broadcasts rank 0's parameters once). The tensor-parallel
``model`` axis (JAX ``parallel/sharding_rules.py``) is not ported
(ROADMAP.md Queue 1 item 5, tensor parallelism).

A group is set up once per process by :func:`init_data_parallel`, from
torchrun's environment (``python -m torch.distributed.run``: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) or from an explicit ``host:port`` coordinator. Without a
group every helper here answers for a world of one process.

Backends: ``nccl`` needs one card per rank and refuses two ranks on one
device; ``gloo`` takes CPU tensors and, staging through the host, CUDA
tensors, so two ranks can share one card. Host-side agreements (the context
bucket, barriers) run over a Gloo group of CPU scalars (:func:`cpu_group`):
under NCCL a CUDA scalar would be read only after the queued step.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# a dead or stuck rank fails every other rank's next collective after this
# long, instead of hanging the run (a step, a checkpoint write or an eval
# pass of the full-size model takes seconds)
DEFAULT_TIMEOUT = timedelta(seconds=300)

_cpu_group = None  # the Gloo group beside an NCCL default group


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_data_parallel(backend: str, coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None, process_id: Optional[int] = None,
                       timeout: timedelta = DEFAULT_TIMEOUT) -> Tuple[int, int]:
    """Join the process group; returns ``(rank, world)``.

    ``coordinator`` (``host:port``) with ``num_processes`` and ``process_id``
    gives the group explicitly; without it the group comes from torchrun's
    environment. Under ``nccl`` each rank takes the card ``LOCAL_RANK``, and
    more local ranks than cards raise (NCCL refuses two ranks on one device;
    ``gloo`` shares one). One tiny collective follows at once
    (:func:`warm_collectives`)."""
    global _cpu_group
    if initialized():
        raise RuntimeError("the process group is already initialised")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist backend must be nccl or gloo, got {backend!r}")
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init_method, world, rank = f"tcp://{coordinator}", int(num_processes), int(process_id)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group: {', '.join(missing)} unset (launch with "
                               "python -m torch.distributed.run, or give a coordinator)")
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"{local_world} local ranks on {cards} CUDA device(s): NCCL refuses two ranks "
                "on one device; launch one rank per card, or share a card with "
                "--dist_backend gloo")
        device = local_device()
        if device.index is not None:
            torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    # every rank creates the Gloo group here, in the same order (new_group is
    # a collective call)
    _cpu_group = dist.new_group(backend="gloo", timeout=timeout) if backend != "gloo" else None
    warm_collectives()
    return rank, world


def default_backend(device=None) -> str:
    """``gloo`` for a CPU device, else ``nccl`` (the launchers' default)."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def data_rank_world() -> Tuple[int, int]:
    """``(rank, world)`` of this process's loader stream; ``(0, 1)`` with no
    group (JAX ``data_rank_world``; the port has no tensor parallelism, so a
    rank is a data row)."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    """Whether this process writes the run's files (rank 0, or no group)."""
    return data_rank_world()[0] == 0


def cpu_group():
    """The group for collectives of CPU tensors: the default group under
    Gloo, a Gloo group beside it under NCCL."""
    return _cpu_group


def warm_collectives() -> None:
    """One tiny ``all_reduce`` over the group and one over :func:`cpu_group`,
    right after init (JAX ``warm_collectives``): communicators start on first
    use, so a rank that is slow or gone fails here and not minutes later."""
    if not initialized():
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    dist.all_reduce(torch.ones(1, device=device))
    if _cpu_group is not None:
        dist.all_reduce(torch.ones(1), group=_cpu_group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def barrier() -> None:
    """Every rank waits here for the others (no-op with no group)."""
    if initialized():
        dist.barrier(group=_cpu_group)


def local_device(explicit=None) -> torch.device:
    """The device this process computes on: ``explicit`` when the caller names
    one; else the card ``LOCAL_RANK`` under a launcher that sets it, or
    ``models.resolve_device``'s CUDA card (each raises without one)."""
    from ..models import resolve_device

    if explicit is not None or "LOCAL_RANK" not in os.environ:
        return resolve_device(explicit)
    resolve_device(None)
    index = int(os.environ["LOCAL_RANK"])
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {index} but {torch.cuda.device_count()} CUDA "
                           "device(s): name the device (--device cuda:0) to share a card "
                           "over --dist_backend gloo")
    return torch.device("cuda", index)
