"""Console entry point of the PyTorch port: the training launcher.

Counterpart of ``iterated_learning_for_vlm_tpu/cli_entry.py`` and
``scripts/train.py``: it builds ``Solver(...)`` from a YAML config and
trains. Installed as ``ilvlm-train-torch``; also
``python -m iterated_learning_for_vlm_tpu_torch.cli_entry``::

    ilvlm-train-torch --config configs/clip_fdt_tiny_cpu_cluster.yaml \\
        --output_path out --exp_name tiny --device cpu

The model trains on the CUDA card unless ``--device`` names another device.
Data parallel, one process per rank (the JAX launcher's flags)::

    python -m torch.distributed.run --nproc_per_node 4 \
        -m iterated_learning_for_vlm_tpu_torch.cli_entry \
        --config configs/clip_fdt_cc3m.yaml --output_path out --multihost

``--multihost`` joins torchrun's process group (rank ``r`` on card
``LOCAL_RANK``); ``--coordinator host:port --num_processes N --process_id r``
gives the group explicitly. ``--dist_backend`` is ``nccl`` on CUDA and
``gloo`` on the CPU by default; two ranks on one card need ``gloo`` and
``--device cuda:0`` (NCCL refuses them). ``data.train.batch_size`` is a
rank's.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def train_main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="CLIP / CLIP-FDT trainer (PyTorch)")
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--output_path", required=True, type=str)
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--debug", default=False, action="store_true")
    parser.add_argument("--exp_name", default="run")
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the CUDA card, under "
                             "a launcher card LOCAL_RANK; 'cpu' to train on the CPU)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group: torchrun's environment, or --coordinator")
    parser.add_argument("--coordinator", default=None,
                        help="with --multihost: the group's 'host:port', for processes "
                             "started without torchrun")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="with --multihost: the process group's backend (default nccl "
                             "on CUDA, gloo on the CPU; gloo shares one card between ranks)")
    args = parser.parse_args(argv)
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        parser.error("--coordinator requires --num_processes and --process_id")
    if args.debug:  # a post-mortem debugger on an uncaught exception at a terminal
        from .utils.debug import install_crash_handler

        install_crash_handler()

    from .parallel.mesh import default_backend, init_data_parallel
    from .train.solver import Solver
    from .utils.config import load_config

    if args.multihost:
        init_data_parallel(args.dist_backend or default_backend(args.device),
                           coordinator=args.coordinator, num_processes=args.num_processes,
                           process_id=args.process_id)
    try:
        config = load_config(args.config)
        solver = Solver(config, output_path=args.output_path, exp_name=args.exp_name,
                        batch_size=args.batch_size, ckpt_path=args.ckpt_path, debug=args.debug,
                        seed=args.seed, device=args.device)
        max_iter = int(config.lr_scheduler.kwargs.get("max_iter", 0))
        if solver._last_iter >= max_iter > 0:
            solver.logger.info("Training has been completed to max_iter!")
            return solver
        solver.train()
        return solver
    finally:
        if args.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    train_main()
