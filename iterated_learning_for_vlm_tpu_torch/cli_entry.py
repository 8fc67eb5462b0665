"""Console entry point of the PyTorch port: the training launcher.

Counterpart of ``iterated_learning_for_vlm_tpu/cli_entry.py`` and
``scripts/train.py``: it builds ``Solver(...)`` from a YAML config and
trains. Installed as ``ilvlm-train-torch``; also
``python -m iterated_learning_for_vlm_tpu_torch.cli_entry``::

    ilvlm-train-torch --config configs/clip_fdt_tiny_cpu_cluster.yaml \\
        --output_path out --exp_name tiny --device cpu

The model trains on the CUDA card unless ``--device`` names another device.
One process, one device: the multi-process flags of the JAX launcher come
with DDP (ROADMAP.md Queue 1 item 5).
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
                        help="torch device to train on (default: the CUDA card; "
                             "'cpu' to train on the CPU)")
    args = parser.parse_args(argv)

    from .train.solver import Solver
    from .utils.config import load_config

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


if __name__ == "__main__":
    train_main()
