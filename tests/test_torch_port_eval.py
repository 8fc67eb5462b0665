"""The port's evaluation suite (``iterated_learning_for_vlm_tpu_torch/eval``)
against the JAX package's, on the CPU.

- Scorers, dataset builders, prompts, languages, the compositional scenes, the
  webdataset export and the eval-set tools, given the same inputs: exactly
  equal (the port's metric code is a copy: numpy float32 products of the
  same embeddings; the data writers write the same bytes).
- The model loader: port checkpoints (``train/checkpoint.py:save_checkpoint``)
  of the tiny CPU configs, loaded by both ``load_eval_encoder``s (JAX reads a
  ``.pth.tar`` through ``load_reference_checkpoint``): embeddings within
  ATOL = 1e-4 on unit-norm fp32 features, the tolerance of
  ``test_torch_port_encode.py``.
- Both CLIs end to end on one checkpoint: every encoder output within ATOL,
  the scores each metric decides on within SCORE_ATOL, and the metrics equal
  where every decision's margin exceeds twice that. The margin is asserted,
  so a near-tie fails the test instead of passing by luck.

The JAX side reuses one ``JitEncoder`` per model through its own reuse path
(``load_eval_encoder(..., encoder=...)``): each fresh JAX load initialises
the model eagerly, 4-18 s on the CPU.
"""
import csv
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from iterated_learning_for_vlm_tpu.data import compositional as jcomp
from iterated_learning_for_vlm_tpu.data import wds_export as jwds
from iterated_learning_for_vlm_tpu.eval import builder as jbuilder
from iterated_learning_for_vlm_tpu.eval import cli as jcli
from iterated_learning_for_vlm_tpu.eval import crepe as jcrepe
from iterated_learning_for_vlm_tpu.eval import group_match as jgroup
from iterated_learning_for_vlm_tpu.eval import linear_probe as jprobe
from iterated_learning_for_vlm_tpu.eval import model_loader as jloader
from iterated_learning_for_vlm_tpu.eval import outtable as jouttable
from iterated_learning_for_vlm_tpu.eval import prompts as jprompts
from iterated_learning_for_vlm_tpu.eval import results_evaluator as jresults
from iterated_learning_for_vlm_tpu.eval import sugar_crepe as jsugar
from iterated_learning_for_vlm_tpu.eval import zeroshot_classification as jzsc
from iterated_learning_for_vlm_tpu.eval import zeroshot_retrieval as jzsr
from iterated_learning_for_vlm_tpu.eval.encode import JitEncoder
from iterated_learning_for_vlm_tpu_torch.data import compositional as pcomp
from iterated_learning_for_vlm_tpu_torch.data import wds_export as pwds
from iterated_learning_for_vlm_tpu_torch.eval import builder as pbuilder
from iterated_learning_for_vlm_tpu_torch.eval import cli as pcli
from iterated_learning_for_vlm_tpu_torch.eval import crepe as pcrepe
from iterated_learning_for_vlm_tpu_torch.eval import group_match as pgroup
from iterated_learning_for_vlm_tpu_torch.eval import linear_probe as pprobe
from iterated_learning_for_vlm_tpu_torch.eval import model_loader as ploader
from iterated_learning_for_vlm_tpu_torch.eval import outtable as pouttable
from iterated_learning_for_vlm_tpu_torch.eval import prompts as pprompts
from iterated_learning_for_vlm_tpu_torch.eval import results_evaluator as presults
from iterated_learning_for_vlm_tpu_torch.eval import sugar_crepe as psugar
from iterated_learning_for_vlm_tpu_torch.eval import zeroshot_classification as pzsc
from iterated_learning_for_vlm_tpu_torch.eval import zeroshot_retrieval as pzsr
from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.tools import make_compositional_data as pmake_comp
from iterated_learning_for_vlm_tpu_torch.tools import make_eval_set as pmake_eval
from iterated_learning_for_vlm_tpu_torch.train.checkpoint import save_checkpoint
from iterated_learning_for_vlm_tpu_torch.train.optim import adamw_init, trainable_mask_tree
from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState
from iterated_learning_for_vlm_tpu_torch.utils.config import load_config
from test_dataset_formats import _make_mnist_dir, _make_voc_tree
from test_languages import _imagenet_wds_dir

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"fdt": str(REPO / "configs" / "clip_fdt_tiny_cpu_cluster.yaml"),
           "clip": str(REPO / "configs" / "clip_tiny_cpu_cluster.yaml")}
T0 = 100.0  # the tiny CLIP-FDT config's sd_temperature
BS = 4  # every encoder's batch: the last batch of most sets is partial
# unit-norm fp32 embeddings, port vs JAX (as test_torch_port_encode.py)
ATOL = 1e-4
# dot products of such embeddings (measured <= 4.5e-7; the zero-shot logits
# are 100 x these)
SCORE_ATOL = 1e-5
# a probe head trained on the same features in both packages: fp32 sums in
# another order over 200-500 momentum steps (measured <= 4.8e-7)
HEAD_ATOL = 1e-5


# -- helpers ------------------------------------------------------------------
def assert_decisions(ref, got, tol):
    """``ref`` and ``got``: [..., 2], the two scores of each comparison a
    metric makes. They agree within ``tol``, and in ``ref`` the two scores
    of every comparison are more than ``2 * tol`` apart: no decision can
    differ."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape and ref.shape[-1] == 2
    err = float(np.abs(ref - got).max())
    assert err <= tol, f"scores differ by {err} > {tol}"
    gap = float(np.abs(ref[..., 0] - ref[..., 1]).min())
    assert gap > 2 * tol, f"a near-tie: the smallest margin {gap} is within 2 x {tol}"


def top_two(scores):
    """The comparison an argmax decides on: each row's two largest scores
    (with at most 5 classes, top-5 holds no decision)."""
    assert scores.shape[-1] <= 5
    return -np.sort(-scores, axis=-1)[..., :2]


def against_others(scores, positive):
    """[rows, n] scores, ``positive`` [rows, n] bool: a rank decides on the
    best positive's score against each other score."""
    positive = np.broadcast_to(positive, scores.shape)
    best = np.where(positive, scores, -np.inf).max(-1, keepdims=True)
    others = scores[~positive].reshape(len(scores), -1)
    return np.stack(np.broadcast_arrays(best, others), axis=-1)


class Vec:
    """A stand-in image that is its own embedding."""

    def __init__(self, vec):
        self.vec = np.asarray(vec, np.float32)

    def convert(self, mode):
        return self


class TableEncoder:
    """Images are ``Vec``s, or PIL images keyed by their first pixel; a text's
    embedding is looked up by the text."""

    def __init__(self, texts, pixels=None):
        self.texts, self.pixels = texts, pixels or {}

    def encode_images(self, images, normalize=None):
        return np.stack([im.vec if isinstance(im, Vec)
                         else self.pixels[int(np.asarray(im)[0, 0, 0])] for im in images])

    def encode_texts(self, texts, normalize=None):
        return np.stack([self.texts[t] for t in texts])


def unit(rng, *shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def run_script(path, argv, monkeypatch):
    """``main()`` of a repo script (a file outside any package) with ``argv``."""
    spec = importlib.util.spec_from_file_location(Path(path).stem + "_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [str(path)] + list(argv))
    return mod.main()


def pil(rng, size=40):
    return Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))


def same_dataset(a, b):
    assert (a.name, a.task, a.classnames, a.templates, a.captions_per_image) == (
        b.name, b.task, b.classnames, b.templates, b.captions_per_image)
    if a.labels is None:
        assert b.labels is None
    else:
        assert a.labels.dtype == b.labels.dtype
        np.testing.assert_array_equal(a.labels, b.labels)
    assert len(a.images) == len(b.images) > 0
    for x, y in zip(a.images, b.images):
        assert x.mode == y.mode
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- scorers given the same embeddings -----------------------------------------
def _scorer_inputs():
    rng = np.random.default_rng(0)
    n, d, c = 24, 16, 6
    classnames = [f"class {k}" for k in range(c)]
    templates = ["a photo of {}.", "{} again"]
    texts = {t.format(k): v for k in classnames for t, v in zip(templates, unit(rng, 2, d))}
    images = [Vec(v) for v in unit(rng, n, d)]
    labels = rng.integers(0, c, n)
    return rng, images, labels, classnames, templates, texts


def _scorer_case(case, mods, tmp):
    """One scorer of a package (``mods``: its modules) on fixed inputs."""
    zsc, zsr, crepe, group, sugar, results, outtable = mods
    rng, images, labels, classnames, templates, texts = _scorer_inputs()
    enc = TableEncoder(texts)
    if case == "zeroshot":
        return zsc.evaluate_zeroshot_classification(enc, images, labels, classnames, templates)
    if case == "zeroshot_clf_files":
        save = str(tmp / "clf.npy")
        m = zsc.evaluate_zeroshot_classification(enc, images, labels, classnames, templates,
                                                 save_clf=save)
        m2 = zsc.evaluate_zeroshot_classification(enc, images, labels, classnames, templates,
                                                  load_clfs=[save, save])
        return m, m2, np.load(save)
    if case == "zeroshot_cupl":
        table = {k: [f"a photo of {k}.", f"{k} again"] for k in classnames}
        return zsc.evaluate_zeroshot_classification(enc, images, labels, classnames, table)
    if case == "zeroshot_multilabel":
        multihot = (rng.random((len(images), len(classnames))) < 0.4).astype(np.int64)
        multihot[:, 2] = 0  # a class with no positive: its AP is nan, dropped
        return zsc.evaluate_zeroshot_classification(enc, images, multihot, classnames,
                                                    templates, multilabel=True)
    if case == "metric_functions":
        logits = rng.standard_normal((40, 7)).astype(np.float32)
        y = rng.integers(0, 7, 40)
        t = (rng.random(40) < 0.3).astype(np.int64)
        return (zsc.accuracy_topk(logits, y, ks=(1, 3, 5, 10)),
                zsc.mean_per_class_recall(logits, y),
                zsc.average_precision(logits[:, 0], t),
                zsc.average_precision(logits[:, 0], np.zeros(40, np.int64)))
    if case == "retrieval":
        caps = [[f"cap {i} {j}" for j in range(1 + i % 3)] for i in range(len(images))]
        vecs = unit(rng, sum(map(len, caps)), images[0].vec.size)
        enc = TableEncoder(dict(zip([c for cs in caps for c in cs], vecs)))
        scores = rng.standard_normal((12, 9)).astype(np.float32)
        positive = rng.random((12, 9)) < 0.2
        return (zsr.evaluate_retrieval(enc, images, caps, recall_ks=(1, 2, 5, 10, 100)),
                [zsr._recall_at_k(scores, positive, k) for k in (1, 3, 9, 20)])
    if case == "crepe":
        items = [{"image": im, "captions": [f"c{i}_{j}" for j in range(6)]}
                 for i, im in enumerate(images)]
        keys = [c for it in items for c in it["captions"]]
        enc = TableEncoder(dict(zip(keys, unit(rng, len(keys), images[0].vec.size))))
        ranks = rng.integers(0, 12, 30)
        return crepe.evaluate_crepe_items(enc, items), crepe.one2many_metrics(ranks, "x")
    if case == "group":
        items = [{"image_0": images[2 * i], "image_1": images[2 * i + 1],
                  "caption_0": f"g{i}a", "caption_1": f"g{i}b"} for i in range(len(images) // 2)]
        keys = [f"g{i}{s}" for i in range(len(items)) for s in "ab"]
        enc = TableEncoder(dict(zip(keys, unit(rng, len(keys), images[0].vec.size))))
        emb = unit(rng, 10, 2, 8)
        return (group.evaluate_group_items(enc, items),
                group.group_scores(emb, emb[:, ::-1] * 0.5 + unit(rng, 10, 2, 8)))
    if case == "sugar_crepe":
        img_dir, data_dir = tmp / "imgs", tmp / "sc"
        img_dir.mkdir(exist_ok=True)
        data_dir.mkdir(exist_ok=True)
        pixels, table = {}, {}
        for split in ("add_obj", "swap_att", "replace_rel"):
            items = {}
            for i in range(5):
                v = 10 * len(pixels) + 5
                Image.fromarray(np.full((6, 6, 3), v, np.uint8)).save(img_dir / f"{v}.png")
                pixels[v] = unit(rng, 8)
                table[f"pos {v}"], table[f"neg {v}"] = unit(rng, 2, 8)
                items[str(i)] = {"filename": f"{v}.png", "caption": f"pos {v}",
                                 "negative_caption": f"neg {v}"}
            (data_dir / f"{split}.json").write_text(json.dumps(items))
        enc = TableEncoder(table, pixels)
        return (sugar.evaluate_sugar_crepe(enc, str(data_dir), str(img_dir)),
                sugar.evaluate_sugar_crepe(enc, str(data_dir), str(img_dir), max_samples=3))
    if case == "results":
        scores = rng.random((20, 5)).tolist()
        lab = rng.integers(0, 5, 20).tolist()
        res = tmp / "res.jsonl"
        res.write_text("".join(json.dumps({"score": s, "label": y}) + "\n"
                               for s, y in zip(scores, lab)))
        multi = tmp / "multi.jsonl"
        multi.write_text("".join(json.dumps({
            "score": rng.random((2, 3)).tolist(), "label_list": rng.integers(0, 3, 2).tolist(),
            "label_name_list": ["color", "shape"]}) + "\n" for _ in range(9)))
        return (results.load_results(str(res)), results.imagenet_eval(str(res), topk=(1, 2, 3)),
                results.multiclass_eval(str(multi)),
                results.topk_accuracy(np.asarray(scores), np.asarray(lab), (1, 4)))
    if case == "outtable":
        root = tmp / "results"
        (root / "sub").mkdir(parents=True, exist_ok=True)
        for i, task in enumerate(["zeroshot_classification", "compositionality", "x"]):
            rec = {"dataset": f"d{i}", "pretrained": f"/ck/ckpt_{i}.pth.tar", "task": task,
                   "metrics": {"acc1": 0.25 * i, "nested": {"a": 1.5, "b": "s"}}}
            (root / ("sub" if i else ".") / f"r{i}.json").write_text(json.dumps(rec))
        (root / "broken.json").write_text("{")
        return outtable.collect_results(str(root)), outtable.render(str(root))
    raise KeyError(case)


JAX_SCORERS = (jzsc, jzsr, jcrepe, jgroup, jsugar, jresults, jouttable)
PORT_SCORERS = (pzsc, pzsr, pcrepe, pgroup, psugar, presults, pouttable)


@pytest.mark.parametrize("case", [
    "zeroshot", "zeroshot_clf_files", "zeroshot_cupl", "zeroshot_multilabel",
    "metric_functions", "retrieval", "crepe", "group", "sugar_crepe", "results", "outtable"])
def test_scorers_match_jax(case, tmp_path):
    """Each scorer of the port gives the JAX scorer's result exactly."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _scorer_case(case, JAX_SCORERS, tmp_path / "jax")
    got = _scorer_case(case, PORT_SCORERS, tmp_path / "port")
    if case == "zeroshot_clf_files":
        np.testing.assert_array_equal(want[2], got[2])
        want, got = want[:2], got[:2]
    np.testing.assert_equal(got, want)


# -- datasets, prompts, languages, compositional data and the tools ------------
def _dataset_fixture(spec, tmp):
    """Write the files of one ``build_dataset`` spec under ``tmp``; returns
    the ``build_dataset`` keyword arguments."""
    rng = np.random.default_rng(7)
    if spec == "dummy":
        return dict(name="dummy")
    if spec in ("wds", "wds_train_split"):
        samples = [(pil(rng, 16), k % 3) for k in range(7)]
        jwds.export_classification_dataset(str(tmp / "ds"), "test", samples,
                                           ["cat", "dog", "car"], ["a {}"], samples_per_shard=3)
        jwds.export_classification_dataset(str(tmp / "ds"), "train", samples[:4],
                                           ["cat", "dog", "car"], ["a {}"])
        split = "train" if spec == "wds_train_split" else "test"
        return dict(name="wds/myset", root=str(tmp / "ds"), split=split)
    if spec == "wds_retrieval":
        samples = [(pil(rng, 16), [f"caption {k}", f"other {k}"]) for k in range(5)]
        jwds.export_retrieval_dataset(str(tmp / "ret"), "test", samples, samples_per_shard=2)
        return dict(name="wds/ret", root=str(tmp / "{dataset}"))
    if spec == "folder":
        for c in ("red_fox", "blue jay"):
            (tmp / "f" / c).mkdir(parents=True)
            for k in range(2):
                pil(rng, 12).save(tmp / "f" / c / f"{k}.png")
        (tmp / "f" / "notes.txt").write_text("x")
        return dict(name=f"folder:{tmp / 'f'}")
    if spec in ("retrieval_json", "annotation_json"):
        items = []
        for k in range(3):
            pil(rng, 12).save(tmp / f"r{k}.jpg")
            items.append({"image": f"r{k}.jpg", "captions": [f"a {k}", f"b {k}"][: k + 1]})
        (tmp / "karpathy.json").write_text(json.dumps(items))
        if spec == "annotation_json":
            return dict(name="mscoco_captions", root=str(tmp),
                        annotation_file=str(tmp / "karpathy.json"))
        return dict(name=f"retrieval_json:{tmp / 'karpathy.json'}", root=str(tmp))
    if spec in ("flickr_txt", "annotation_txt"):
        for name in ("a.jpg", "b.jpg"):
            pil(rng, 8).save(tmp / name)
        (tmp / "captions.txt").write_text(
            "image,caption\na.jpg,a dog runs\na.jpg,commas, inside, caption\nb.jpg,a cat\n")
        if spec == "annotation_txt":
            return dict(name="flickr30k", root=str(tmp), annotation_file=str(tmp / "captions.txt"))
        return dict(name=f"flickr_txt:{tmp / 'captions.txt'}", root=str(tmp))
    if spec == "npz":
        np.savez(tmp / "c.npz", images=rng.integers(0, 256, (5, 8, 8, 3), dtype=np.uint8),
                 labels=np.arange(5) % 2, classnames=np.asarray(["a", "b"]))
        return dict(name=f"npz:{tmp / 'c.npz'}")
    if spec in ("cifar", "cifar_train"):
        import pickle

        for name in ("data_batch_1", "data_batch_2", "test_batch"):
            with open(tmp / name, "wb") as f:
                pickle.dump({b"data": rng.integers(0, 256, (3, 3 * 8 * 8), dtype=np.uint8),
                             b"labels": [0, 1, 2]}, f)
        with open(tmp / "batches.meta", "wb") as f:
            pickle.dump({b"label_names": [b"plane", b"car", b"bird"]}, f)
        return dict(name=f"cifar:{tmp}", split="train" if spec == "cifar_train" else "test")
    if spec == "mnist":
        _make_mnist_dir(tmp, compress=True)
        return dict(name=f"mnist:{tmp}")
    if spec in ("voc", "voc_cropped"):
        _make_voc_tree(tmp)
        return dict(name=f"{spec}:{tmp}")
    if spec in jbuilder.ML_RETRIEVAL_TEMPLATES:
        paths = []
        for k in range(2):
            pil(rng, 8).save(tmp / f"m{k}.jpg")
            paths.append(f"m{k}.jpg")
        ann = tmp / jbuilder.ML_RETRIEVAL_TEMPLATES[spec].format("es")
        ann.write_text(json.dumps({"image_paths": paths, "annotations": ["un perro", ["x", "y"]]}),
                       encoding="utf-8")
        return dict(name=f"{spec}:{tmp}", language="es")
    if spec == "babel_imagenet":
        return dict(name="babel_imagenet", root=_imagenet_wds_dir(tmp, labels=[1, 2, 10, 11]),
                    language="ne")
    raise KeyError(spec)


@pytest.mark.parametrize("spec", [
    "dummy", "wds", "wds_train_split", "wds_retrieval", "folder", "retrieval_json",
    "annotation_json", "flickr_txt", "annotation_txt", "npz", "cifar", "cifar_train", "mnist",
    "voc", "voc_cropped", *sorted(jbuilder.ML_RETRIEVAL_TEMPLATES), "babel_imagenet"])
def test_build_dataset_matches_jax(spec, tmp_path):
    """Every ``build_dataset`` spec gives the JAX dataset: name, task, labels,
    classnames, templates, captions and every image's pixels."""
    kw = _dataset_fixture(spec, tmp_path)
    want, got = jbuilder.build_dataset(**kw), pbuilder.build_dataset(**kw)
    same_dataset(want, got)
    assert pbuilder.default_task(got) == jbuilder.default_task(want)


def test_unknown_dataset_raises():
    with pytest.raises(KeyError):
        pbuilder.build_dataset("mscoco_captions")


@pytest.mark.parametrize("lang", ["en", "ar", "cn", "it", "jp", "xx"])
def test_apply_language_and_prompt_sets_match_jax(lang, tmp_path):
    """``apply_language`` swaps the same tables (packaged, or from
    ``lang_root``), and the prompt sets are the same lists."""
    lang_root = tmp_path / "langs"
    lang_root.mkdir()
    (lang_root / f"{lang}_classnames.json").write_text(json.dumps({"mine": ["uno", "dos"]}))
    for key in ("imagenet1k", "cifar10", "mnist", "mine", "unknown"):
        for root in (None, str(lang_root)):
            a = jbuilder.EvalDataset(name=key, task="zeroshot_classification",
                                     classnames=["x", "y"], templates=["{}"])
            b = pbuilder.EvalDataset(name=key, task="zeroshot_classification",
                                     classnames=["x", "y"], templates=["{}"])
            a = jbuilder.apply_language(a, lang, lang_root=root)
            b = pbuilder.apply_language(b, lang, lang_root=root)
            assert (a.classnames, a.templates) == (b.classnames, b.templates)
    for name in ("1", "6", "8", "80", 80):
        assert pprompts.get_prompt_set(name) == jprompts.get_prompt_set(name)
    assert pprompts.PROMPT_SETS == jprompts.PROMPT_SETS


def test_language_files_are_copies():
    jdir = REPO / "iterated_learning_for_vlm_tpu" / "eval" / "languages"
    pdir = REPO / "iterated_learning_for_vlm_tpu_torch" / "eval" / "languages"
    assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    for p in jdir.iterdir():
        assert (pdir / p.name).read_bytes() == p.read_bytes(), p.name


def test_package_data_names_every_runtime_file():
    """Every non-Python file the port opens at run time (kernel sources, the
    native augment's C source, the BPE vocabulary, the language tables) is
    named in the setuptools package data, so an installed port has it."""
    import fnmatch
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "iterated_learning_for_vlm_tpu_torch"]
    pkg = REPO / "iterated_learning_for_vlm_tpu_torch"
    files = [p.relative_to(pkg).as_posix() for p in pkg.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts and p.suffix != ".py"]
    assert {"data/native/fused_augment.c", "eval/languages/en_classnames.json",
            "data/bpe_simple_vocab_16e6.txt.gz", "csrc/common.cuh"} <= set(files)
    missing = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"not in the package data: {missing}"


def test_compositional_matches_jax():
    """The same scenes, pixel for pixel, and the same splits and negatives."""
    assert pcomp.COLORS == jcomp.COLORS and pcomp.SHAPES == jcomp.SHAPES
    assert pcomp.RELATIONS == jcomp.RELATIONS
    for fold in (3, 4):
        assert pcomp.seen_pairs(fold) == jcomp.seen_pairs(fold)
        assert pcomp.unseen_pairs(fold) == jcomp.unseen_pairs(fold)
    for seed in (0, 5):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        for c in range(len(jcomp.COLOR_NAMES)):
            for s in range(len(jcomp.SHAPES)):
                a, b = jcomp.draw(c, s, 24, rj), pcomp.draw(c, s, 24, rp)
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(jcomp.to_uint8(a), pcomp.to_uint8(b))
                for swap in ("color", "shape"):
                    assert (jcomp.negative_pair(c, s, swap, rj)
                            == pcomp.negative_pair(c, s, swap, rp))
                p2 = jcomp.distinct_pair2((c, s), jcomp.seen_pairs(), rj)
                assert p2 == pcomp.distinct_pair2((c, s), pcomp.seen_pairs(), rp)
                rel = ("and",) + jcomp.RELATIONS
                r = rel[(c + s) % len(rel)]
                np.testing.assert_array_equal(jcomp.draw_two((c, s), p2, r, 32, rj),
                                              pcomp.draw_two((c, s), p2, r, 32, rp))
                assert (jcomp.caption_two("red", "ring", "blue", "cross", r)
                        == pcomp.caption_two("red", "ring", "blue", "cross", r))
    assert pcomp.caption_for("red", "ring") == jcomp.caption_for("red", "ring")
    assert [pcomp.opposite_relation(r) for r in pcomp.RELATIONS] == [
        jcomp.opposite_relation(r) for r in jcomp.RELATIONS]


@pytest.mark.parametrize("tool", ["make_compositional_data", "make_eval_set", "wds_export"])
def test_data_writers_write_the_same_bytes(tool, tmp_path, monkeypatch):
    """The port's eval-set tools and webdataset exporter write the JAX
    package's bytes for a seed."""
    a, b = tmp_path / "jax", tmp_path / "port"
    if tool == "make_compositional_data":
        argv = ["--shards", "2", "--per-shard", "3", "--eval-per-split", "2",
                "--image-size", "24", "--seed", "3"]
        run_script(REPO / "tools" / "make_compositional_data.py", [str(a)] + argv, monkeypatch)
        pmake_comp.main([str(b)] + argv)
    elif tool == "make_eval_set":
        argv = ["--num-classes", "3", "--per-class", "2", "--image-size", "24", "--seed", "1",
                "--split", "val"]
        run_script(REPO / "tools" / "make_eval_set.py", [str(a)] + argv, monkeypatch)
        pmake_eval.main([str(b)] + argv)
    else:
        rng = np.random.default_rng(2)
        imgs = [pil(rng, 10) for _ in range(5)]
        for root, mod in ((a, jwds), (b, pwds)):
            mod.export_classification_dataset(str(root), "test", ((im, k) for k, im in
                                                                   enumerate(imgs)),
                                              ["x"] * 5, ["t {}"], samples_per_shard=2,
                                              image_format="PNG")
            mod.export_retrieval_dataset(str(root / "r"), "test",
                                         ((im, [f"c{k}", "d"]) for k, im in enumerate(imgs)),
                                         samples_per_shard=4)
    want, got = tree_bytes(a), tree_bytes(b)
    assert len(want) > 3 and sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)


# -- the linear-probe head ------------------------------------------------------
def test_train_head_matches_jax():
    """``_train_head`` on the same features: weights within HEAD_ATOL."""
    rng = np.random.default_rng(4)
    feats = unit(rng, 48, 16)
    labels = rng.integers(0, 5, 48)
    for wd in (0.0, 1e-2):
        wj, bj = jprobe._train_head(feats, labels, 5, weight_decay=wd, steps=200, lr=0.3)
        wp, bp = pprobe._train_head(feats, labels, 5, weight_decay=wd, steps=200, lr=0.3)
        np.testing.assert_allclose(wp, wj, atol=HEAD_ATOL, rtol=0)
        np.testing.assert_allclose(bp, bj, atol=HEAD_ATOL, rtol=0)
        assert np.abs(wj).max() > 0.1  # the head moved


@pytest.mark.parametrize("mode", ["plain", "val_fraction", "val_split", "fewshot"])
def test_linear_probe_matches_jax(mode, tmp_path):
    """``evaluate_linear_probe`` on the same features (an encoder whose images
    are their embeddings): the test logits decide within HEAD_ATOL x 10 with
    margins, the weight-decay sweep picks the same value, and the metrics
    (and, with a cache prefix, the cached files) are equal."""
    rng = np.random.default_rng(9)
    centers = unit(rng, 4, 16)
    lab_tr, lab_te, lab_va = rng.integers(0, 4, 40), rng.integers(0, 4, 12), rng.integers(0, 4, 9)

    def imgs(lab):
        return [Vec(centers[y] + 0.6 * rng.standard_normal(16)) for y in lab]

    tr, te, va = imgs(lab_tr), imgs(lab_te), imgs(lab_va)
    kw = dict(steps=150, wd_candidates=(0.0, 1e-3, 1e-1))
    if mode == "val_fraction":
        kw["val_fraction"] = 0.25
    elif mode == "val_split":
        kw.update(val_images=va, val_labels=lab_va)
    elif mode == "fewshot":
        kw.update(fewshot_k=3, seed=2)
    heads = {}
    for name, mod in (("jax", jprobe), ("port", pprobe)):
        calls = []
        orig = mod._train_head

        def spy(*a, _orig=orig, _calls=calls, **k):
            _calls.append((a[0], _orig(*a, **k)))
            return _calls[-1][1]

        mod._train_head = spy
        try:
            extra = {"device": "cpu"} if name == "port" else {}
            heads[name] = (mod.evaluate_linear_probe(
                TableEncoder({}), tr, lab_tr, te, lab_te,
                feature_cache_prefix=str(tmp_path / name / "feat"), **kw, **extra), calls)
        finally:
            mod._train_head = orig
    (mj, cj), (mp, cp) = heads["jax"], heads["port"]
    assert len(cj) == len(cp) == (1 if mode in ("plain", "fewshot") else 4)
    test_feats = np.load(tmp_path / "jax" / "feat_test_feats.npy")
    for (fj, (wj, bj)), (fp, (wp, bp)) in zip(cj, cp):
        np.testing.assert_array_equal(fj, fp)
        assert_decisions(top_two(test_feats @ wj + bj), top_two(test_feats @ wp + bp),
                         10 * HEAD_ATOL)
    assert mp == mj
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")


# -- the model loader ------------------------------------------------------------
def _write_ckpt(out_dir, kind, step, seed, edit=None):
    cfg = load_config(CONFIGS[kind])
    model = model_entry(cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    if edit is not None:
        edit(model)
    params = dict(model.named_parameters())
    state = TrainState.create(params, adamw_init(params), trainable_mask_tree(params),
                              params.get("space_dict"))
    return save_checkpoint(str(out_dir), model, state, step)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")

    def zero_text_bias(model):  # the OpenAI layout has no text-projection bias
        with torch.no_grad():
            model.encode_text.text_projection.bias.zero_()

    out = {kind: [_write_ckpt(root / kind, kind, 5, 11), _write_ckpt(root / kind, kind, 8, 12)]
           for kind in CONFIGS}
    out["fdt_nobias"] = _write_ckpt(root / "nobias", "fdt", 3, 13, zero_text_bias)
    return out


@pytest.fixture(scope="module")
def jax_encoders(ckpts):
    """One JAX encoder per model, loaded from the first checkpoint."""
    return {kind: jloader.load_eval_encoder(CONFIGS[kind], ckpts[kind][0], batch_size=BS,
                                            num_workers=1) for kind in CONFIGS}


def jax_load(jax_encoders, kind, ckpt, sd_temperature=None, model_type="cust_clip"):
    """The JAX encoder of ``kind`` with new weights (JAX's reuse path); the
    temperature is set on every call, since reuse keeps the last one."""
    if kind == "fdt" and sd_temperature is None:
        sd_temperature = T0
    return jloader.load_eval_encoder(CONFIGS[kind], ckpt, sd_temperature=sd_temperature,
                                     model_type=model_type, encoder=jax_encoders[kind])


def port_load(config, ckpt, **kw):
    return ploader.load_eval_encoder(config, ckpt, batch_size=BS, num_workers=1, device="cpu",
                                     **kw)


PROBE_TEXTS = ["a photo of a red ring", "two cats on a blue mat", "a dog", "the end of it all",
               "a very long caption with many many words in it"]


def embeddings(enc):
    rng = np.random.default_rng(21)
    return enc.encode_images([pil(rng, 40) for _ in range(6)]), enc.encode_texts(PROBE_TEXTS)


@pytest.mark.parametrize("kind", ["fdt", "clip"])
def test_loader_matches_jax(kind, ckpts, jax_encoders):
    """A port checkpoint of each tiny model, and a soup of two: the same
    embeddings from both loaders."""
    for ckpt in (ckpts[kind][0], ckpts[kind]):
        want = embeddings(jax_load(jax_encoders, kind, ckpt))
        got = embeddings(port_load(CONFIGS[kind], ckpt))
        for w, g in zip(want, got):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_loader_soup_is_the_mean_state_dict(ckpts):
    """The soup of two checkpoints is the model loaded with the mean of their
    state dicts, bit for bit."""
    a, b = (torch.load(p, map_location="cpu", weights_only=True)["model"] for p in ckpts["fdt"])
    mean = {k: ((a[k].double() + b[k].double()) / 2).float() for k in a}
    model = model_entry(load_config(CONFIGS["fdt"]).model, device="cpu")
    model.load_state_dict(mean)
    ref = TorchEncoder(model, batch_size=BS, num_workers=1)
    for w, g in zip(embeddings(ref), embeddings(port_load(CONFIGS["fdt"], ckpts["fdt"]))):
        np.testing.assert_array_equal(g, w)


def test_loader_options_match_jax(ckpts, jax_encoders):
    """``sd_temperature``, ``amp=False`` on a bf16 config (fp32 towers, so the
    JAX fp32 model's embeddings), the OpenAI/open_clip layout (detected, or
    forced by ``open_clip``), and the reuse of an encoder."""
    ckpt = ckpts["fdt"][0]
    want = embeddings(jax_load(jax_encoders, "fdt", ckpt, sd_temperature=0.5))
    enc = port_load(CONFIGS["fdt"], ckpt, sd_temperature=0.5)
    assert enc.model.fdt_cfg.sd_temperature == enc.sd_temperature == 0.5
    for w, g in zip(want, embeddings(enc)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # the caller's Config is left as it was
    cfg = load_config(CONFIGS["fdt"])
    cfg.model.kwargs["dtype"] = "bfloat16"
    port_load(cfg, None, sd_temperature=3.0)
    assert cfg.model.kwargs.fdt.sd_temperature == T0 and cfg.model.kwargs.dtype == "bfloat16"

    want = embeddings(jax_load(jax_encoders, "fdt", ckpt))
    fp32 = port_load(cfg, ckpt, amp=False)
    assert fp32.model.dtype == torch.float32 and port_load(cfg, ckpt).model.dtype == torch.bfloat16
    for w, g in zip(want, embeddings(fp32)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)

    # the OpenAI layout: unprefixed text tower, a bare [width, embed] projection
    sd = torch.load(ckpts["fdt_nobias"], map_location="cpu", weights_only=True)["model"]
    openai = {}
    for k, v in sd.items():
        if k == "encode_text.text_projection.weight":
            openai["text_projection"] = v.T.contiguous()
        elif k == "encode_text.text_projection.bias":
            assert not v.any()
        else:
            openai[k[len("encode_text."):] if k.startswith("encode_text.") else k] = v
    openai["attn_mask"] = torch.zeros(3)  # a buffer of the OpenAI model, dropped
    path = Path(ckpts["fdt_nobias"]).with_name("openai.pt")
    torch.save(openai, path)
    want = embeddings(jax_load(jax_encoders, "fdt", ckpts["fdt_nobias"]))
    ref = embeddings(port_load(CONFIGS["fdt"], ckpts["fdt_nobias"]))
    for model_type in ("cust_clip", "open_clip"):
        jw = embeddings(jax_load(jax_encoders, "fdt", str(path), model_type=model_type))
        got = embeddings(port_load(CONFIGS["fdt"], str(path), model_type=model_type))
        for w, j, r, g in zip(want, jw, ref, got):
            np.testing.assert_array_equal(j, w)
            np.testing.assert_array_equal(g, r)
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)

    # reuse: the first encoder's model takes the second checkpoint in place
    first = port_load(CONFIGS["fdt"], ckpts["fdt"][0])
    model = first.model
    again = port_load(CONFIGS["fdt"], ckpts["fdt"][1], encoder=first, sd_temperature=2.0)
    assert again is first and again.model is model and again.sd_temperature == 2.0
    fresh = port_load(CONFIGS["fdt"], ckpts["fdt"][1], sd_temperature=2.0)
    for w, g in zip(embeddings(fresh), embeddings(again)):
        np.testing.assert_array_equal(g, w)


def test_loader_refusals(ckpts, tmp_path):
    """A JAX (Orbax) checkpoint directory and the spectral-norm types raise;
    data-parallel eval with no process group is the one-device encoder (JAX's
    ``ndata == 1`` path; the 2-rank case is ``test_torch_port_dist.py``'s);
    with no device named and no card, the loader raises instead of building
    on the CPU."""
    with pytest.raises(ValueError, match="torch-format checkpoints only"):
        port_load(CONFIGS["fdt"], str(tmp_path))
    cfg = load_config(CONFIGS["clip"])
    cfg.model["type"] = "clip_vitb32_sp"
    with pytest.raises(NotImplementedError, match="spectral norm"):
        port_load(cfg, None)
    parallel = port_load(CONFIGS["clip"], ckpts["clip"][0], data_parallel=True)
    assert (parallel.rank, parallel.world, parallel.batch_size) == (0, 1, BS)
    for w, g in zip(embeddings(port_load(CONFIGS["clip"], ckpts["clip"][0])),
                    embeddings(parallel)):
        np.testing.assert_array_equal(g, w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ploader.load_eval_encoder(CONFIGS["clip"], None)


# -- both CLIs end to end ----------------------------------------------------------
@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """Every dataset the CLI runs read, written once from seeds."""
    root = tmp_path_factory.mktemp("cli_data")
    pmake_eval.main([str(root / "zs"), "--num-classes", "4", "--per-class", "3",
                     "--image-size", "32"])
    pmake_eval.main([str(root / "probe"), "--num-classes", "4", "--per-class", "6",
                     "--image-size", "32", "--split", "train"])
    pmake_eval.main([str(root / "probe"), "--num-classes", "4", "--per-class", "3",
                     "--image-size", "32", "--split", "test", "--noise-seed", "778"])
    pmake_comp.main([str(root / "comp"), "--shards", "0", "--eval-per-split", "4",
                     "--image-size", "32"])
    rng = np.random.default_rng(31)
    scenes = root / "scenes"
    scenes.mkdir()
    pairs = pcomp.seen_pairs()
    caption = {}
    for k in range(8):
        c, s = pairs[(5 * k) % len(pairs)]
        Image.fromarray(pcomp.to_uint8(pcomp.draw(c, s, 40, rng))).save(scenes / f"{k}.jpg")
        caption[k] = (c, s)

    def name(c, s):
        return pcomp.caption_for(pcomp.COLOR_NAMES[c], pcomp.SHAPES[s])

    (root / "retrieval.json").write_text(json.dumps([
        {"image": f"{k}.jpg", "captions": [name(*caption[k]), f"shape {k}"]}
        for k in range(6)]))
    crepe_csv = root / "crepe" / "prod_hard_negatives" / "atom"
    crepe_csv.mkdir(parents=True)
    with open(crepe_csv / "prod_vg_hard_negs_atom_complexity_5.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_id", "caption", "hard_negs", "x", "y", "width", "height"])
        for k in range(7):
            c, s = caption[k]
            negs = [name(c, (s + j) % len(pcomp.SHAPES)) for j in range(1, 6)]
            w.writerow([k % 8, name(c, s), repr(negs), 2 * (k % 3), 1, 30, 36])
    (root / "cola.json").write_text(json.dumps([
        [f"{2 * i}.jpg", name(*caption[2 * i]), f"{2 * i + 1}.jpg", name(*caption[2 * i + 1])]
        for i in range(4)]))
    return root


def _zeroshot_scores(log):
    """The logits' top two (4 or 2 classes here): one text call per class,
    then the images."""
    clf = []
    for _, emb in log[:-1]:
        mean = emb.mean(axis=0)
        clf.append(mean / (np.linalg.norm(mean) + 1e-10))
    return [top_two(100.0 * log[-1][1] @ np.stack(clf, axis=1))]


def _retrieval_scores(log):
    """Two captions per image: each query's best positive against the rest."""
    t2i = log[1][1] @ log[0][1].T
    positive = np.repeat(np.eye(len(t2i) // 2, dtype=bool), 2, axis=0)
    return [against_others(t2i, positive), against_others(t2i.T, positive.T)]


def _sugar_scores(log):
    return [np.stack([np.sum(log[i][1] * log[i + 1][1], -1), np.sum(log[i][1] * log[i + 2][1], -1)],
                     axis=-1) for i in range(0, len(log), 3)]


def _crepe_scores(log):
    img = log[0][1]
    scores = np.einsum("nd,ncd->nc", img, log[1][1].reshape(len(img), -1, img.shape[1]))
    return [against_others(scores, np.arange(scores.shape[1]) == 0)]


def _cola_scores(log):
    img = log[0][1].reshape(-1, 2, log[0][1].shape[1])
    txt = log[1][1].reshape(-1, 2, log[1][1].shape[1])
    lg = np.einsum("nid,ncd->nic", img, txt)
    # each pair the rule compares: image rows, then caption columns
    return [np.stack([lg[:, [0, 1], 0], lg[:, [1, 0], 1], lg[:, 0, [0, 1]], lg[:, 1, [1, 0]]],
                     axis=1)]


CLI_CASES = {
    "dummy": (["eval", "--dataset", "dummy"], _zeroshot_scores, 100 * SCORE_ATOL),
    "wds": (["eval", "--dataset", "wds/zs", "--dataset_root", "{root}/zs",
             "--template_set", "6"], _zeroshot_scores, 100 * SCORE_ATOL),
    "retrieval": (["eval", "--dataset", "retrieval_json:{root}/retrieval.json",
                   "--dataset_root", "{root}/scenes", "--recall_k", "1", "2", "5"],
                  _retrieval_scores, SCORE_ATOL),
    "sugar_crepe": (["sugar_crepe", "--data_root", "{root}/comp/eval",
                     "--image_root", "{root}/comp/eval/images"], _sugar_scores, SCORE_ATOL),
    "crepe": (["crepe", "--data_root", "{root}/crepe", "--image_dirs", "{root}/none,{root}/scenes",
               "--complexities", "5", "9"], _crepe_scores, SCORE_ATOL),
    "cola": (["cola", "--json_path", "{root}/cola.json", "--image_root", "{root}/scenes"],
             _cola_scores, SCORE_ATOL),
}


def record_encoders(monkeypatch):
    """Every ``encode_images`` / ``encode_texts`` output of the JAX and the
    port encoders, in call order: ``{"jax": [(kind, array)], "port": [...]}``."""
    logs = {"jax": [], "port": []}
    for side, cls in (("jax", JitEncoder), ("port", TorchEncoder)):
        for kind in ("encode_images", "encode_texts"):
            def rec(self, *a, _orig=getattr(cls, kind), _log=logs[side], _kind=kind, **k):
                out = _orig(self, *a, **k)
                _log.append((_kind, np.array(out)))
                return out
            monkeypatch.setattr(cls, kind, rec)
    return logs


@pytest.fixture
def recorded(monkeypatch, ckpts, jax_encoders):
    """Every encoder output of both CLIs, in call order; the JAX CLI's loader
    reuses the module's JAX encoder."""
    logs = record_encoders(monkeypatch)

    def jax_cli_loader(args, language="en"):
        assert args.model_config == CONFIGS["fdt"] and args.batch_size == BS
        ckpt = args.pretrained.split(",") if "," in args.pretrained else args.pretrained
        return jax_load(jax_encoders, "fdt", ckpt, args.sd_temperature)

    monkeypatch.setattr(jcli, "_load_encoder", jax_cli_loader)
    return logs


def _argv(args, root, ckpt, out):
    return ([a.format(root=root) for a in args]
            + ["--model_config", CONFIGS["fdt"], "--pretrained", ckpt, "--batch_size", str(BS),
               "--num_workers", "1", "--output", str(out / "{dataset}_{task}.json")])


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_jax(case, cli_data, ckpts, recorded, tmp_path):
    """Both CLIs on the same checkpoint and data: the same encoder calls
    within ATOL, the scores of every decision within tolerance and apart by
    more than twice it, hence the same metrics and the same record."""
    args, scores, tol = CLI_CASES[case]
    ckpt = ckpts["fdt"][1]
    want = jcli.main(_argv(args, cli_data, ckpt, tmp_path / "jax"))
    got = pcli.main(_argv(args, cli_data, ckpt, tmp_path / "port") + ["--device", "cpu"])
    log_j, log_p = recorded["jax"], recorded["port"]
    assert [k for k, _ in log_p] == [k for k, _ in log_j] and log_j
    for (_, w), (_, g) in zip(log_j, log_p):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    for w, g in zip(scores(log_j), scores(log_p)):
        assert_decisions(w, g, tol)
    assert got == want
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")

    # `build` over the records: the same CSV
    jcli.main(["build", str(tmp_path / "jax"), "--output", str(tmp_path / "j.csv")])
    pcli.main(["build", str(tmp_path / "port"), "--output", str(tmp_path / "p.csv")])
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_cli_linear_probe_matches_jax(cli_data, ckpts, recorded, tmp_path):
    """The probe through both CLIs: the cached features within ATOL, each
    package's head on its own features deciding the test split the same way
    (margins asserted), and the same record."""
    ckpt = ckpts["fdt"][1]
    args = ["eval", "--dataset", "wds/probe", "--dataset_root", "{root}/probe", "--task",
            "linear_probe", "--fewshot_epochs", "2", "--fewshot_lr", "0.5"]
    records = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        records[side] = main(_argv(args, cli_data, ckpt, tmp_path / side)
                             + ["--feature_root", str(tmp_path / f"feat_{side}")] + extra)
    prefix = "wds_probe/clip_fdt_tiny_cpu_cluster__ckpt_8.pth.tar__train-test"
    logits = {}
    for side, mod in (("jax", jprobe), ("port", pprobe)):
        tr, te = (np.load(tmp_path / f"feat_{side}" / f"{prefix}_{s}_feats.npy")
                  for s in ("train", "test"))
        labels = np.load(tmp_path / f"feat_{side}" / f"{prefix}_train_labels.npy")
        w, b = mod._train_head(tr, labels, 4, steps=100, lr=0.5)
        logits[side] = (tr, te, te @ w + b)
    for j, p in zip(logits["jax"][:2], logits["port"][:2]):
        np.testing.assert_allclose(p, j, atol=ATOL, rtol=0)
    # features within ATOL, through heads of these sizes (measured 3.1e-6)
    assert_decisions(top_two(logits["jax"][2]), top_two(logits["port"][2]), 1e-4)
    assert records["port"] == records["jax"]


# -- the port CLI's own behaviour (JAX tests/test_cli.py) ---------------------------
def _tiny_dummy():
    rng = np.random.default_rng(0)
    return pbuilder.EvalDataset(
        name="dummy", task="zeroshot_classification",
        images=[Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype("uint8"))
                for _ in range(4)],
        labels=np.asarray([0, 1, 0, 1]), classnames=["blank image", "noisy image"],
        templates=["a photo of {}"])


@pytest.fixture
def port_cli(monkeypatch):
    """``main`` of the port CLI on the CPU over the tiny CLIP config, with a
    4-image dummy set."""
    monkeypatch.setattr(pbuilder, "build_dummy", lambda n=8: _tiny_dummy())

    def main(argv, config=True):
        head = argv[:1] + (["--model_config", CONFIGS["clip"]] if config else [])
        return pcli.main(head + argv[1:] + ["--device", "cpu", "--num_workers", "1"])

    return main


def test_cli_clf_roundtrip_custom_names_skip_existing(port_cli, tmp_path):
    """--save_clf / --load_clfs round trip, a custom classname file with
    --dump_classnames, --template_set with --dump_templates, and
    --skip_existing against the formatted --output (the task resolved from
    'auto' first)."""
    clf = tmp_path / "clf.npy"
    tmpl = str(tmp_path / "{dataset}_{task}_{language}.json")
    rec = port_cli(["eval", "--dataset", "dummy", "--save_clf", str(clf), "--output", tmpl,
                    "--dump_classnames"])
    assert rec["task"] == "zeroshot_classification" and clf.exists()
    assert rec["classnames"] == ["blank image", "noisy image"]
    saved = json.loads((tmp_path / "dummy_zeroshot_classification_en.json").read_text())
    assert saved == rec and saved["language"] == "en" and saved["pretrained"] is None
    rec2 = port_cli(["eval", "--dataset", "dummy", "--load_clfs", str(clf), str(clf)])
    assert rec2["metrics"] == rec["metrics"]
    names = tmp_path / "names.json"
    names.write_text(json.dumps({"dummy": ["empty picture", "static picture"]}))
    rec3 = port_cli(["eval", "--dataset", "dummy", "--custom_classname_file", str(names),
                     "--dump_classnames", "--template_set", "6", "--dump_templates"])
    assert rec3["classnames"] == ["empty picture", "static picture"]
    assert rec3["templates"] == pprompts.PROMPT_6
    assert port_cli(["eval", "--dataset", "dummy", "--output", tmpl, "--skip_existing"]) == []


def test_cli_dataset_list_and_model_sweep(port_cli, tmp_path, monkeypatch):
    """A dataset-list file expands to one dataset per line, and
    --pretrained_model sweeps (config, checkpoint) pairs from a file and the
    command line."""
    def fake_build(name, root="", split="test", language="en", **kw):
        ds = _tiny_dummy()
        ds.name = name
        return ds

    lst = tmp_path / "webdatasets.txt"
    lst.write_text("wds/ds_a\nwds/ds_b\n")
    tmpl = str(tmp_path / "{dataset}_{task}_{language}.json")
    with monkeypatch.context() as m:
        m.setattr(pbuilder, "build_dataset", fake_build)
        recs = port_cli(["eval", "--dataset", str(lst), "dummy", "--output", tmpl])
    assert [r["dataset"] for r in recs] == ["wds/ds_a", "wds/ds_b", "dummy"]
    assert (tmp_path / "wds_ds_a_zeroshot_classification_en.json").exists()
    models = tmp_path / "models.txt"
    models.write_text(f"{CONFIGS['clip']}\n{CONFIGS['clip']},\n")
    recs = port_cli(["eval", "--dataset", "dummy", "--pretrained_model", str(models),
                     CONFIGS["clip"]], config=False)
    assert len(recs) == 3 and all(r["model"] == CONFIGS["clip"] for r in recs)
    with pytest.raises(SystemExit):
        port_cli(["eval", "--dataset", "dummy"], config=False)


def test_cli_probe_cache_val_split_no_normalize(port_cli, tmp_path, monkeypatch):
    """--feature_root caches the probe's features under a key of config,
    checkpoint and splits; --skip_load then scores them without building a
    model; --val_split drives the weight-decay search and excludes
    --val_proportion; --no_normalize reaches the probe only."""
    froot = str(tmp_path / "features")
    argv = ["eval", "--dataset", "dummy", "--task", "linear_probe", "--fewshot_epochs", "1",
            "--feature_root", froot]
    rec = port_cli(argv)
    prefix = os.path.join(froot, "dummy", "clip_tiny_cpu_cluster__random_init__train-test")
    for s in ("train", "test"):
        assert os.path.exists(f"{prefix}_{s}_feats.npy")
    with monkeypatch.context() as m:
        m.setattr(pcli, "_load_encoder", lambda *a, **k: pytest.fail("loaded a model"))
        assert port_cli(argv + ["--skip_load"])["metrics"] == rec["metrics"]
    with monkeypatch.context() as m:
        m.setattr(pbuilder, "build_dataset",
                  lambda name, root="", split="test", language="en", **kw: _tiny_dummy())
        val = port_cli(["eval", "--dataset", "dummy", "--task", "linear_probe",
                        "--fewshot_epochs", "1", "--val_split", "val"])
        assert val["metrics"]["weight_decay"] in (0.0, 1e-6, 1e-4, 1e-2)
        with pytest.raises(SystemExit):
            port_cli(["eval", "--dataset", "dummy", "--task", "linear_probe", "--val_split",
                      "val", "--val_proportion", "0.2"])
    raw = port_cli(argv + ["--no_normalize"])
    assert raw["metrics"]["normalized"] is False and rec["metrics"]["normalized"] is True
    feats = np.load(f"{prefix}-nonorm_test_feats.npy")
    assert not np.allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-3)
    zs = [port_cli(["eval", "--dataset", "dummy"] + flag)["metrics"]
          for flag in ([], ["--no_normalize"])]
    assert zs[0] == zs[1]


def test_cli_refusals_and_device(port_cli, capsys):
    """--distributed without a launcher's process group is the one-process
    run (the 2-rank runs are ``test_torch_port_dist.py``'s); --quiet silences
    the progress line; without --device and without a card the CLI raises
    instead of running on the CPU."""
    assert (port_cli(["eval", "--dataset", "dummy", "--distributed", "--dist_backend", "gloo"])
            == port_cli(["eval", "--dataset", "dummy"]))
    capsys.readouterr()
    port_cli(["eval", "--dataset", "dummy", "--quiet"])
    assert "Running" not in capsys.readouterr().err
    args = pcli.build_parser().parse_args(["eval", "--dataset", "dummy", "--device", "cuda:1"])
    assert args.device == "cuda:1" and not hasattr(args, "platform")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcli.main(["eval", "--model_config", CONFIGS["clip"], "--dataset", "dummy"])


def test_test_sweep_scores_every_checkpoint(port_cli, ckpts, tmp_path, capsys):
    """The ``test.sh`` sweep takes the port's ``ckpt_N.pth.tar`` files
    newest first (not JAX's ``ckpt_N`` directories, nor a write in flight)
    and renders the results table."""
    from iterated_learning_for_vlm_tpu_torch.tools import test_sweep

    names = tmp_path / "names"
    names.mkdir()
    for name in ("ckpt_3.pth.tar", "ckpt_12.pth.tar", "ckpt_7", "ckpt_5.pth.tar.tmp", "x.txt"):
        (names / name).write_text("")
    assert [s for s, _ in test_sweep.find_checkpoints(str(names))] == [12, 3]
    out = tmp_path / "results"
    test_sweep.main(["--model_config", CONFIGS["clip"], "--ckpt_dir",
                     str(Path(ckpts["clip"][0]).parent), "--task", "recognition", "--datasets",
                     "dummy", "--output_folder", str(out), "--batch_size", "4", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["5_dummy_zeroshot_classification.json",
                                       "8_dummy_zeroshot_classification.json"]
    assert "== task: zeroshot_classification ==" in capsys.readouterr().out
