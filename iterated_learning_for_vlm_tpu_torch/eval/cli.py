"""Evaluation CLI of the PyTorch port.

Counterpart of ``iterated_learning_for_vlm_tpu/eval/cli.py``: the same
subcommands, flags, records and ``--output`` templates. The JAX-only
``--platform`` / ``--cpu_devices`` flags become ``--device`` (as in
``ilvlm-train-torch``): the model runs on the CUDA card unless ``--device``
names another device, and without a card it raises. ``--model_type
ja_clip/nllb_clip`` loads a local HF ``save_pretrained`` directory given as
``--pretrained`` (``eval/hf_adapter.py``). ``--distributed`` under
``python -m torch.distributed.run`` joins the launcher's process group
(``--dist_backend``: ``nccl`` on CUDA, ``gloo`` on the CPU or to share one
card) and encodes each batch data-parallel; every rank runs the task and
only rank 0 prints and writes the record. Without a launcher it is the
one-process path.

Parity target: reference ``CLIP_benchmark/clip_benchmark/cli.py`` — the
``eval`` subcommand iterating model x dataset, dispatching by task and
dumping JSON ``{dataset, model, pretrained, task, metrics, language}`` —
plus the standalone compositionality scripts behind one front-end mirroring
``test.sh`` task names (compositionality | retrieval | recognition | probing).

Usage examples::

  python -m iterated_learning_for_vlm_tpu_torch.eval.cli eval \
      --model_config configs/clip_fdt_cc3m.yaml \
      --pretrained out/checkpoints/ckpt_6000.pth.tar \
      --dataset dummy --output result.json

  python -m iterated_learning_for_vlm_tpu_torch.eval.cli sugar_crepe \
      --model_config ... --pretrained ... \
      --data_root sc_data --image_root coco/val2017 --output results/sc.json
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

from ..parallel.mesh import default_backend, init_data_parallel, initialized, is_main


def _load_encoder(args, language="en"):
    from .model_loader import load_eval_encoder

    ckpt = args.pretrained
    if ckpt and "," in ckpt:
        ckpt = ckpt.split(",")
    # NOTE: --no_normalize is NOT passed here — like the reference, the flag
    # only reaches the linear-probe featurizer (as an explicit per-call
    # normalize= override); every other metric keeps unit-norm features.
    return load_eval_encoder(args.model_config, ckpt, batch_size=args.batch_size,
                             sd_temperature=getattr(args, "sd_temperature", None),
                             model_type=getattr(args, "model_type", "cust_clip"),
                             amp=getattr(args, "amp", True),
                             num_workers=getattr(args, "num_workers", 4),
                             data_parallel=getattr(args, "distributed", False),
                             language=language, device=getattr(args, "device", None))


def _dump(args, dataset, task, metrics, language="en", extra=None):
    rec = {
        "dataset": dataset,
        "model": args.model_config,
        "pretrained": args.pretrained,
        "task": task,
        "metrics": metrics,
        "language": language,
    }
    if extra:  # --dump_classnames / --dump_templates (reference cli.py)
        rec.update(extra)
    if not is_main():  # every rank ran the task; rank 0 reports it
        return rec
    out = args.output
    if out:
        # reference cli.py --output is a template, e.g.
        # '{dataset}_{task}_{language}.json'
        out = out.format(dataset=str(dataset).replace("/", "_"), task=task,
                         language=language,
                         model=os.path.basename(str(args.model_config)),
                         pretrained=os.path.basename(str(args.pretrained)))
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
    print(json.dumps(rec))
    return rec


def _custom_override(path, dataset):
    """--custom_classname_file / --custom_template_file: JSON list, or dict
    keyed by dataset name (reference cli.py semantics)."""
    if not path:
        return None
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return data.get(dataset) or data.get(str(dataset).replace("/", "_"))
    return data


def _expand_datasets(names):
    """Reference main_eval dataset expansion (cli.py:135-145): each entry is
    a dataset name, or a FILE whose lines are dataset names
    (``webdatasets.txt`` in test.sh:34)."""
    out = []
    for name in names if isinstance(names, (list, tuple)) else [names]:
        if os.path.isfile(name) and not os.path.isdir(name):
            try:
                with open(name) as f:
                    lines = [ln.strip() for ln in f
                             if ln.strip() and not ln.startswith("#")]
                # a dataset-list file, not a data file fed to a builder style
                if lines and all(re.match(r"^[\w/@.:-]+$", ln) for ln in lines):
                    out.extend(lines)
                    continue
            except UnicodeDecodeError:
                pass
        out.append(name)
    return out


def _expand_pretrained_models(entries):
    """Reference ``--pretrained_model`` expansion (cli.py:117-133): each
    entry is ``model_config,checkpoint`` or a FILE whose lines are such
    pairs; ``--model_config``/``--pretrained`` are ignored when given."""
    pairs = []
    for entry in entries:
        if os.path.isfile(entry) and "," not in entry \
                and not entry.endswith((".yaml", ".yml")):
            with open(entry) as f:
                lines = [ln.strip() for ln in f
                         if ln.strip() and not ln.startswith("#")]
        else:
            lines = [entry]
        for ln in lines:
            mc, _, pt = ln.partition(",")
            pairs.append((mc, pt or None))
    return pairs


def cmd_eval(args):
    hf_type = getattr(args, "model_type", "cust_clip") in ("ja_clip", "nllb_clip")
    if not args.model_config and not getattr(args, "pretrained_model", None) \
            and not hf_type:  # HF types: --pretrained IS the model
        raise SystemExit("eval needs --model_config or --pretrained_model")
    if getattr(args, "pretrained_model", None):
        import copy

        recs = []
        for mc, pt in _expand_pretrained_models(args.pretrained_model):
            a = copy.copy(args)
            a.model_config, a.pretrained, a.pretrained_model = mc, pt, None
            r = cmd_eval(a)
            recs.extend(r if isinstance(r, list) else [r])
        return recs

    from .builder import apply_language, build_dataset
    from .linear_probe import probe_cache_complete
    from .zeroshot_classification import evaluate_zeroshot_classification
    from .zeroshot_retrieval import evaluate_retrieval

    if args.val_split and args.val_proportion:
        raise SystemExit("--val_split and --val_proportion are mutually "
                         "exclusive (reference cli.py:35-37)")
    encoder = None
    languages = args.language if isinstance(args.language, list) else [args.language]
    recs = []
    # reference main_eval dataset x language product (cli.py:116-195)
    for dataset, language in ((d, lg) for d in _expand_datasets(args.dataset)
                              for lg in languages):
        ds = build_dataset(dataset, root=args.dataset_root, split=args.split,
                           language=language,
                           annotation_file=getattr(args, "annotation_file", ""))
        # resolve 'auto' BEFORE formatting the skip path — the reference also
        # resolves the task first (cli.py:234-247), else an {task} template
        # checks "..._auto_..." and never matches what _dump wrote
        task = args.task if args.task != "auto" else ds.task
        if args.skip_existing and args.output:
            candidate = args.output.format(
                dataset=str(dataset).replace("/", "_"), task=task,
                language=language, model=os.path.basename(str(args.model_config)),
                pretrained=os.path.basename(str(args.pretrained)))
            if os.path.exists(candidate):  # reference cli.py --skip_existing
                print(f"skip existing {candidate}", file=sys.stderr)
                continue
        if getattr(args, "verbose", True) and is_main():  # reference --quiet: verbose=False
            print(f"Running '{task}' on '{dataset}' (language {language}) "
                  f"with model '{args.model_config}'", file=sys.stderr)
        probe_prefix = None
        if task == "linear_probe" and args.feature_root:
            # reference feature_root layout: features/<dataset>/<model tag>.
            # The tag folds in the model config, the checkpoint AND the split
            # names — different models or splits must never share cached
            # features (a sweep with two 'ckpt_final's would silently score
            # the first model's features under the second model's name).
            mc_tag = os.path.splitext(os.path.basename(str(args.model_config)))[0]
            ckpt_tag = (os.path.basename(str(args.pretrained).rstrip("/"))
                        if args.pretrained else "random_init")
            split_tag = f"{args.train_split}-{args.split}"
            if args.val_split:
                split_tag += f"-{args.val_split}"
            if not getattr(args, "normalize", True):
                split_tag += "-nonorm"  # raw features must not share the cache
            probe_prefix = os.path.join(
                args.feature_root, str(dataset).replace("/", "_"),
                f"{mc_tag}__{ckpt_tag}__{split_tag}")
        skip_model = (task == "linear_probe" and args.skip_load
                      and probe_cache_complete(probe_prefix,
                                               include_val=bool(args.val_split)))
        if encoder is None and not skip_model:
            encoder = _load_encoder(args, language=language)
        if encoder is not None and hasattr(encoder, "set_language"):
            encoder.set_language(language)  # nllb_clip src-lang per language
        ds = apply_language(ds, language, lang_root=args.language_root or None)
        custom_names = _custom_override(args.custom_classname_file, dataset)
        if custom_names:
            ds.classnames = custom_names
        custom_templates = _custom_override(args.custom_template_file, dataset)
        if custom_templates:
            ds.templates = custom_templates
        if args.template_set:  # reference prompt files (imagenet.py:43-49)
            from .prompts import get_prompt_set

            ds.templates = get_prompt_set(args.template_set)
        if task == "zeroshot_classification":
            save_clf = args.save_clf
            if save_clf and len(languages) > 1:
                # one classifier per language, not a silent overwrite
                root, ext = os.path.splitext(save_clf)
                save_clf = f"{root}_{language}{ext or '.npy'}"
            metrics = evaluate_zeroshot_classification(
                encoder, ds.images, ds.labels, ds.classnames, ds.templates,
                # [N, C] multihot targets -> mAP (reference infers the same
                # way, zeroshot_classification.py:212-214)
                multilabel=getattr(ds.labels, "ndim", 1) == 2,
                save_clf=save_clf, load_clfs=args.load_clfs or (),
            )
        elif task == "zeroshot_retrieval":
            metrics = evaluate_retrieval(encoder, ds.images, ds.captions_per_image,
                                         recall_ks=tuple(args.recall_k))
        elif task == "image_caption_selection":
            from .caption_selection import evaluate_caption_selection

            metrics = evaluate_caption_selection(encoder, ds.images,
                                                 ds.captions_per_image)
        elif task == "captioning":
            from .captioning import evaluate_captioning

            metrics = evaluate_captioning(encoder, ds.images, ds.captions_per_image)
        elif task == "linear_probe":
            from .linear_probe import evaluate_linear_probe

            if skip_model:  # features fully cached; datasets only give labels
                train_ds = ds
            else:
                train_ds = build_dataset(dataset, root=args.dataset_root,
                                         split=args.train_split)
            val_kw = {}
            if args.val_split:  # explicit val split for the WD search
                val_ds = build_dataset(dataset, root=args.dataset_root,
                                       split=args.val_split)
                val_kw = dict(val_images=val_ds.images, val_labels=val_ds.labels)
            metrics = evaluate_linear_probe(
                encoder, train_ds.images, train_ds.labels, ds.images, ds.labels,
                feature_cache_prefix=probe_prefix, **val_kw,
                fewshot_k=args.fewshot_k,
                val_fraction=args.val_proportion,
                # the reference's epoch knob maps to full-batch steps here
                # (50 steps per "epoch"; default 10 epochs == 500 steps)
                steps=max(1, args.fewshot_epochs) * 50,
                lr=args.fewshot_lr,
                seed=args.seed,
                normalize=getattr(args, "normalize", True),
                device=getattr(args, "device", None),
            )
        else:
            raise SystemExit(f"unknown task {task}")
        extra = {}
        if args.dump_classnames:
            extra["classnames"] = list(ds.classnames or [])
        if args.dump_templates:
            extra["templates"] = list(ds.templates or [])
        recs.append(_dump(args, dataset, task, metrics, language=language,
                          extra=extra))
    return recs[0] if len(recs) == 1 else recs


def cmd_build(args):
    """Aggregate eval result JSONs into one benchmark CSV (reference
    ``cli.py:89-113`` ``main_build``): metrics flattened into columns plus
    the record fields and ``model_fullname``."""
    import csv

    rows, fieldnames = [], []

    def process(path):
        with open(path) as f:
            data = json.load(f)
        row = dict(data.pop("metrics", {}))
        row.update(data)
        row["model_fullname"] = f"{row.get('model', '')} {row.get('pretrained', '')}"
        for k in row:
            if k not in fieldnames:
                fieldnames.append(k)
        rows.append(row)

    for path in args.files:
        if os.path.isdir(path):
            for f in sorted(os.listdir(path)):
                if f.endswith(".json"):
                    process(os.path.join(path, f))
        else:
            process(path)
    with open(args.output, "w", newline="") as csvfile:
        writer = csv.DictWriter(csvfile, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.output}")
    return rows


def cmd_sugar_crepe(args):
    from .sugar_crepe import evaluate_sugar_crepe

    encoder = _load_encoder(args)
    metrics = evaluate_sugar_crepe(encoder, args.data_root, args.image_root)
    return _dump(args, "sugar_crepe", "compositionality", metrics)


def cmd_cola(args):
    from .group_match import evaluate_cola

    encoder = _load_encoder(args)
    metrics = evaluate_cola(encoder, args.json_path, args.image_root)
    return _dump(args, "cola", "compositionality", metrics)


def cmd_winoground(args):
    from .group_match import evaluate_winoground

    encoder = _load_encoder(args)
    metrics = evaluate_winoground(encoder)
    return _dump(args, "winoground", "compositionality", metrics)


def cmd_crepe(args):
    from .crepe import (
        evaluate_crepe_csv, productivity_csv_path, systematicity_csv_path,
    )

    encoder = _load_encoder(args)
    all_metrics = {}
    image_dirs = args.image_dirs.split(",")
    if args.compo_type == "productivity":
        for complexity in args.complexities:
            for neg in args.hard_neg_types:
                path = productivity_csv_path(args.data_root, complexity, neg)
                if os.path.exists(path):
                    m = evaluate_crepe_csv(encoder, path, image_dirs,
                                           hard_neg_key="hard_negs", crop=not args.no_crop)
                    all_metrics[f"complexity_{complexity}_{neg}"] = m
    else:
        for split in ("seen_compounds", "unseen_compounds"):
            for neg in args.hard_neg_types:
                path = systematicity_csv_path(args.data_root, split, args.train_dataset)
                if os.path.exists(path):
                    key = f"valid_hard_negs_{neg}"
                    m = evaluate_crepe_csv(encoder, path, image_dirs,
                                           hard_neg_key=key, crop=not args.no_crop)
                    all_metrics[f"{split}_{neg}"] = m
    return _dump(args, f"crepe_{args.compo_type}", "compositionality", all_metrics)


def build_parser():
    p = argparse.ArgumentParser(prog="ilvlm-eval-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, config_required=True):
        # model_config requiredness is validated in main(): required for
        # cust_clip / open_clip, unused for the HF-directory types
        # (ja_clip/nllb_clip, where --pretrained IS the model definition)
        sp.add_argument("--model_config", required=False, default=None)
        sp.set_defaults(_config_required=config_required)
        sp.add_argument("--model_type", default="cust_clip",
                        choices=["cust_clip", "open_clip", "ja_clip",
                                 "nllb_clip"],
                        help="reference TYPE2FUNC surface (models/__init__.py:8-13)."
                             " cust_clip: this framework's / reference training"
                             " checkpoints; open_clip: local OpenAI/open_clip"
                             " .pt state dicts (layout auto-converted);"
                             " ja_clip / nllb_clip: a LOCAL HF save_pretrained"
                             " directory passed via --pretrained (zero-egress"
                             " stand-in for the reference's network loaders).")
        sp.add_argument("--pretrained", default=None,
                        help="torch checkpoint (.pth.tar / .pth / .pt); "
                             "comma-separated list = weight soup")
        sp.add_argument("--batch_size", type=int, default=64)
        sp.add_argument("--output", default=None)
        sp.add_argument("--sd_temperature", type=float, default=None,
                        help="override the FDT codebook temperature (score a "
                             "T-decayed checkpoint at its final T, not the "
                             "config's initial value)")
        sp.add_argument("--no_amp", action="store_false", dest="amp",
                        help="force fp32 tower compute instead of the "
                             "config's dtype (reference --no_amp disables "
                             "torch autocast)")
        sp.add_argument("--quiet", action="store_false", dest="verbose",
                        help="suppress progress messages (reference --quiet)")
        sp.add_argument("--num_workers", type=int, default=4,
                        help="threads for image decode+preprocess (reference "
                             "--num_workers; the augment hot path is "
                             "GIL-releasing native code)")
        sp.add_argument("--distributed", action="store_true",
                        help="data-parallel eval (reference --distributed): under "
                             "python -m torch.distributed.run every rank encodes its "
                             "slice of each batch; rank 0 reports")
        sp.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="with --distributed: the process group's backend (default "
                             "nccl on CUDA, gloo on the CPU; gloo shares one card "
                             "between ranks)")
        sp.add_argument("--device", default=None,
                        help="torch device to evaluate on (default: the CUDA "
                             "card; 'cpu' to evaluate on the CPU)")

    e = sub.add_parser("eval")
    common(e, config_required=False)
    e.add_argument("--pretrained_model", nargs="+", default=None,
                   help="model sweep entries 'model_config.yaml,ckpt' (or a "
                        "file with one pair per line); overrides "
                        "--model_config/--pretrained (reference "
                        "cli.py:117-133)")
    e.add_argument("--dataset", required=True, nargs="+",
                   help="dataset name(s); an entry that is a text file is "
                        "read as one dataset name per line (reference "
                        "cli.py:135-145, test.sh webdatasets.txt)")
    e.add_argument("--dataset_root", default="")
    e.add_argument("--annotation_file", default="",
                   help="retrieval annotations for bare dataset names "
                        "(karpathy-style JSON or flickr captions.txt; "
                        "reference cli.py --annotation_file)")
    e.add_argument("--no_normalize", action="store_false", dest="normalize",
                   help="fit the linear probe on raw (un-L2-normalized) "
                        "features (reference --normalize; other tasks always "
                        "normalize, like the reference metrics)")
    e.add_argument("--split", default="test")
    e.add_argument("--task", default="auto")
    e.add_argument("--recall_k", type=int, nargs="+", default=[1, 5, 10])
    e.add_argument("--fewshot_k", type=int, default=-1)
    e.add_argument("--train_split", default="train",
                   help="split used to fit the linear probe")
    e.add_argument("--val_split", default=None,
                   help="explicit validation split for the probe WD search "
                        "(reference cli.py --val_split, mutually exclusive "
                        "with --val_proportion)")
    e.add_argument("--val_proportion", type=float, default=0.0,
                   help="held-out fraction of train for the probe's WD search")
    e.add_argument("--fewshot_epochs", type=int, default=10,
                   help="probe budget; one epoch == 50 full-batch steps here")
    e.add_argument("--fewshot_lr", type=float, default=0.1)
    e.add_argument("--feature_root", default=None,
                   help="cache linear-probe features on disk under "
                        "<feature_root>/<dataset>/<ckpt tag> (reference "
                        "cli.py --feature_root); re-runs and WD sweeps "
                        "reuse them")
    e.add_argument("--skip_load", action="store_true",
                   help="skip model loading when the probe feature cache "
                        "is complete (reference cli.py --skip_load)")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--save_clf", default=None,
                   help="save the zeroshot classifier to this .npy")
    e.add_argument("--load_clfs", nargs="+", default=[],
                   help=".npy classifiers to average instead of building one")
    e.add_argument("--custom_classname_file", default=None,
                   help="JSON list or {dataset: [names]} overriding classnames")
    e.add_argument("--custom_template_file", default=None,
                   help="JSON list or {dataset: [templates]} overriding templates")
    e.add_argument("--template_set", default=None, choices=["1", "6", "8", "80"],
                   help="use a reference prompt-ensemble set "
                        "(prototype/data/datasets/prompts/query_pattern_promptN)")
    e.add_argument("--dump_classnames", action="store_true")
    e.add_argument("--dump_templates", action="store_true")
    e.add_argument("--skip_existing", action="store_true",
                   help="skip when the formatted --output file already exists")
    e.add_argument("--language", nargs="+", default=["en"],
                   help="language(s) of classnames/templates (reference "
                        "cli.py --language); non-en entries load "
                        "{lang}_classnames.json / templates")
    e.add_argument("--language_root", default="",
                   help="dir with per-language JSONs (default: packaged "
                        "eval/languages)")
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("build", help="aggregate result JSONs into a CSV")
    b.add_argument("files", nargs="+", help="JSON result files or directories")
    b.add_argument("--output", default="benchmark.csv")
    b.set_defaults(fn=cmd_build)

    s = sub.add_parser("sugar_crepe")
    common(s)
    s.add_argument("--data_root", required=True)
    s.add_argument("--image_root", required=True)
    s.set_defaults(fn=cmd_sugar_crepe)

    c = sub.add_parser("cola")
    common(c)
    c.add_argument("--json_path", required=True)
    c.add_argument("--image_root", required=True)
    c.set_defaults(fn=cmd_cola)

    w = sub.add_parser("winoground")
    common(w)
    w.set_defaults(fn=cmd_winoground)

    cr = sub.add_parser("crepe")
    common(cr)
    cr.add_argument("--compo_type", choices=["productivity", "systematicity"],
                    default="productivity")
    cr.add_argument("--data_root", required=True)
    cr.add_argument("--image_dirs", default="datasets/VG_100K,datasets/VG_100K_2")
    cr.add_argument("--complexities", type=int, nargs="+", default=[5, 10])
    cr.add_argument("--hard_neg_types", nargs="+", default=["atom", "swap", "negate"])
    cr.add_argument("--train_dataset", default="cc12m")
    cr.add_argument("--no_crop", action="store_true")
    cr.set_defaults(fn=cmd_crepe)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_type = getattr(args, "model_type", "cust_clip")
    hf_type = model_type in ("ja_clip", "nllb_clip")
    if getattr(args, "_config_required", False) and not hf_type \
            and not getattr(args, "model_config", None):
        build_parser().error(f"--model_config is required for --model_type {model_type}")
    if hf_type and not getattr(args, "pretrained", None):
        build_parser().error("--model_type ja_clip/nllb_clip needs --pretrained "
                             "pointing at a local HF save_pretrained directory")
    # --distributed under a launcher: join its group for this run (a group
    # already set up by the caller is used as it is)
    own_group = (getattr(args, "distributed", False) and "WORLD_SIZE" in os.environ
                 and not initialized())
    if own_group:
        init_data_parallel(args.dist_backend or default_backend(args.device))
    try:
        return args.fn(args)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
