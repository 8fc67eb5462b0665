"""Checkpoint-sweep evaluation (reference ``test.sh``) of the PyTorch port.

The port's copy of ``scripts/test.py``: ``bash test.sh <model> <ckpt_dir>
<task>`` sweeps every ``ckpt_N.pth.tar`` checkpoint (the port's name; JAX's
are ``ckpt_N`` directories) under <ckpt_dir>, newest first, and runs the
requested task family (compositionality | retrieval | recognition |
probing) through the port's eval CLI, writing JSON results under
``<ckpt_dir>/../results/quantitative`` for ``eval/outtable.py``.

  python -m iterated_learning_for_vlm_tpu_torch.tools.test_sweep \\
      --model_config configs/clip_fdt_cc3m.yaml \\
      --ckpt_dir out/run/checkpoints --task compositionality \\
      --sc_data_root <jsons> --sc_image_root <coco_val2017>

The models run on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import os
import re

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pth\.tar$")


def find_checkpoints(ckpt_dir):
    out = []
    for name in sorted(os.listdir(ckpt_dir)):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out, reverse=True)  # newest first, like test.sh's ITER loop


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_config", required=True)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--task", required=True,
                   choices=["compositionality", "retrieval", "recognition", "probing"])
    p.add_argument("--output_folder", default=None)
    p.add_argument("--datasets", nargs="*", default=["dummy"],
                   help="dataset specs for retrieval/recognition/probing")
    p.add_argument("--dataset_root", default="")
    p.add_argument("--sc_data_root", default=None)
    p.add_argument("--sc_image_root", default=None)
    p.add_argument("--cola_json", default=None)
    p.add_argument("--cola_images", default=None)
    p.add_argument("--crepe_root", default=None)
    p.add_argument("--crepe_image_dirs", default="datasets/VG_100K,datasets/VG_100K_2")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--limit", type=int, default=0, help="max checkpoints to sweep")
    p.add_argument("--device", default=None,
                   help="torch device to evaluate on (default: the CUDA card)")
    args = p.parse_args(argv)

    from ..eval import cli as eval_cli
    from ..eval.outtable import render

    out_root = args.output_folder or os.path.join(
        os.path.dirname(args.ckpt_dir.rstrip("/")), "results", "quantitative"
    )
    ckpts = find_checkpoints(args.ckpt_dir)
    if args.limit:
        ckpts = ckpts[: args.limit]

    for it, path in ckpts:
        common = ["--model_config", args.model_config, "--pretrained", path,
                  "--batch_size", str(args.batch_size)]
        if args.device:
            common += ["--device", args.device]
        if args.task == "compositionality":
            if args.sc_data_root:
                eval_cli.main(["sugar_crepe", *common,
                               "--data_root", args.sc_data_root,
                               "--image_root", args.sc_image_root,
                               "--output", os.path.join(out_root, f"{it}_sugar_crepe.json")])
            if args.cola_json:
                eval_cli.main(["cola", *common, "--json_path", args.cola_json,
                               "--image_root", args.cola_images,
                               "--output", os.path.join(out_root, f"{it}_cola.json")])
            if args.crepe_root:
                eval_cli.main(["crepe", *common, "--data_root", args.crepe_root,
                               "--image_dirs", args.crepe_image_dirs,
                               "--output", os.path.join(out_root, f"{it}_crepe.json")])
        else:
            task = {"retrieval": "zeroshot_retrieval",
                    "recognition": "zeroshot_classification",
                    "probing": "linear_probe"}[args.task]
            for ds in args.datasets:
                safe = ds.replace("/", "_").replace(":", "_")
                eval_cli.main(["eval", *common, "--dataset", ds,
                               "--dataset_root", args.dataset_root, "--task", task,
                               "--output", os.path.join(out_root, f"{it}_{safe}_{task}.json")])

    print(render(out_root))


if __name__ == "__main__":
    main()
