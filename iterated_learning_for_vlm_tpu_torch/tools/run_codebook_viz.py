"""Codebook visualization sweep.

Counterpart of the top-level ``tools/run_codebook_viz.py`` (reference
``example/clip_fdt/visualization.py:405-443``) over the port: build the model
of ``--config``, load a torch checkpoint (``eval/model_loader.py``), sweep
``--batches`` batches of the UNSHUFFLED wds loader of the config's
``data.train`` block keeping per-code top-k images and captions by attention
weight, and render per-code PNG grids and ``text_codes.json``. The model runs
on the CUDA card unless ``--device`` names another device. The loader always
takes the float32 wire here (the renderer un-normalizes the images it was
given), whatever wire the config trains on. Usage::

    python -m iterated_learning_for_vlm_tpu_torch.tools.run_codebook_viz \\
        --config cfg.yaml --ckpt ckpt_N.pth.tar --out code_viz [--batches 8] [--topk 8]

or ``ilvlm-codebook-viz-torch`` with the same flags.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ilvlm-codebook-viz-torch")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--topk", type=int, default=8)
    p.add_argument("--max_codes", type=int, default=32,
                   help="render at most this many (most-active) codes")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    return p


def run(argv=None) -> dict:
    """The sweep; returns what it wrote: ``{"grids": [paths], "text_codes": path}``."""
    import torch

    from ..data.pipeline import get_unshuffled_wds_dataset
    from ..data.tokenizer import get_tokenizer
    from ..eval.model_loader import load_eval_encoder
    from ..utils.config import load_config
    from .visualization import (
        dump_text_codes, render_code_grid, sweep_image_codes, sweep_text_codes,
    )

    args = build_parser().parse_args(argv)
    config = load_config(args.config)
    encoder = load_eval_encoder(args.config, args.ckpt, device=args.device)
    model, dev = encoder.model, encoder.device
    sd_num = model.fdt_cfg.sd_num

    tok = get_tokenizer()
    dcfg = dict(config.data["train"])
    dcfg["workers"] = 0
    dcfg["wire_dtype"] = "float32"
    data = get_unshuffled_wds_dataset(dcfg, tokenizer=tok)

    batches, texts = [], []
    for i, batch in enumerate(data.dataloader):
        if i >= args.batches:
            break
        batches.append(batch)
        texts.append([tok.decode([int(t) for t in row if int(t)])
                      for row in np.asarray(batch["tokens"])])

    def host(x):
        return x.float().cpu().numpy()

    @torch.inference_mode()
    def img_fn(images):
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(dev)
        token_att, _ = model.extract_img_sd_ft(x, return_token_att=True)
        att_weight, _ = model.extract_img_sd_ft(x)
        return host(token_att), host(att_weight)

    @torch.inference_mode()
    def txt_fn(tokens, pad_mask):
        att_weight, _ = model.extract_txt_sd_ft(
            torch.from_numpy(np.asarray(tokens, np.int64)).to(dev),
            torch.from_numpy(np.asarray(pad_mask, np.float32)).to(dev))
        return None, host(att_weight)

    tracker = sweep_image_codes(img_fn, batches, num_codes=sd_num, k=args.topk)
    active = tracker.active_codes(min_items=2)
    # most-active first
    active = sorted(active, key=lambda c: -len(tracker.top(c)))[: args.max_codes]
    os.makedirs(args.out, exist_ok=True)
    grids = [p for p in (render_code_grid(tracker, code, args.out) for code in active) if p]
    print(f"rendered {len(grids)} image-code grids to {args.out}")

    ttracker = sweep_text_codes(txt_fn, batches, texts, num_codes=sd_num, k=args.topk)
    out_json = os.path.join(args.out, "text_codes.json")
    dump_text_codes(ttracker, out_json, min_items=2)
    print(f"wrote {out_json}")
    return {"grids": grids, "text_codes": out_json}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
