"""The port's caption tasks, COCO loaders and HF adapter against the JAX
package, on the CPU.

- ``eval/caption_metrics.py`` (BLEU-1..4, ROUGE-L, CIDEr-D and the tokenizer),
  ``eval/caption_selection.py`` and ``eval/captioning.py`` on the same inputs
  or embeddings: exactly equal (the port's code is a copy).
- ``data/coco.py``: the COCO ``captions_*.json`` and Karpathy loaders and
  ``COCOCaptionDataset`` over JSON and images written from seeds: equal items.
- Both CLIs' ``image_caption_selection`` and ``captioning`` tasks on one port
  checkpoint of the tiny CLIP-FDT: every encoder call within ATOL = 1e-4, the
  scores each decision takes within SCORE_ATOL = 1e-5 and apart by more than
  twice it (asserted, as ``tests/test_torch_port_eval.py`` does), hence the
  same metrics and records.
- ``HFClipEncoder`` (``--model_type ja_clip`` / ``nllb_clip``) on a tiny
  rinna-shaped HF directory built offline (as ``tests/test_hf_adapter.py``):
  the port's on ``device="cpu"`` against JAX's, embeddings within 1e-6, and
  both CLIs' records equal. Skipped where ``transformers`` is missing.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from iterated_learning_for_vlm_tpu.data import coco as jcoco
from iterated_learning_for_vlm_tpu.eval import builder as jbuilder
from iterated_learning_for_vlm_tpu.eval import caption_metrics as jmetrics
from iterated_learning_for_vlm_tpu.eval import caption_selection as jselection
from iterated_learning_for_vlm_tpu.eval import captioning as jcaptioning
from iterated_learning_for_vlm_tpu.eval import cli as jcli
from iterated_learning_for_vlm_tpu_torch.data import coco as pcoco
from iterated_learning_for_vlm_tpu_torch.data import compositional as pcomp
from iterated_learning_for_vlm_tpu_torch.eval import builder as pbuilder
from iterated_learning_for_vlm_tpu_torch.eval import caption_metrics as pmetrics
from iterated_learning_for_vlm_tpu_torch.eval import caption_selection as pselection
from iterated_learning_for_vlm_tpu_torch.eval import captioning as pcaptioning
from iterated_learning_for_vlm_tpu_torch.eval import cli as pcli
from iterated_learning_for_vlm_tpu_torch.eval import model_loader as ploader
from test_torch_port_eval import (  # noqa: F401  (fixtures)
    ATOL, CONFIGS, SCORE_ATOL, TableEncoder, Vec, _argv, against_others, assert_decisions,
    ckpts, jax_encoders, recorded, tree_bytes, unit,
)

WORDS = ["a", "the", "dog", "cat", "red", "blue", "ring", "mat", "on", "runs", "two",
         "small", "park", "ball", "with", "of"]


def _corpus(seed, n):
    """``n`` candidates (one may be empty) and 1-4 references each, from a
    seeded vocabulary with case and punctuation for the tokenizer."""
    rng = np.random.default_rng(seed)

    def sentence(lo=1):
        words = [WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(lo, 12))]
        if rng.random() < 0.5:
            words[0] = words[0].capitalize()
        return " ".join(words) + rng.choice(["", ".", "!", " ,"])

    cands = [sentence(0 if i == 0 else 1) for i in range(n)]
    refs = [[sentence() for _ in range(rng.integers(1, 5))] for _ in range(n)]
    return cands, refs


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 40)])
def test_caption_metrics_equal_jax(seed, n):
    """Tokenizer, corpus BLEU 1..4 (``max_n`` 2 and 4), ROUGE-L and CIDEr-D on
    seeded corpora: equal to JAX's bit for bit."""
    cands, refs = _corpus(seed, n)
    for text in cands + [r for rs in refs for r in rs]:
        assert pmetrics.tokenize(text) == jmetrics.tokenize(text)
    tc = [jmetrics.tokenize(c) for c in cands]
    tr = [[jmetrics.tokenize(r) for r in rs] for rs in refs]
    for max_n in (2, 4):
        assert pmetrics.bleu(tc, tr, max_n) == jmetrics.bleu(tc, tr, max_n)
    assert pmetrics.rouge_l(tc, tr) == jmetrics.rouge_l(tc, tr)
    assert pmetrics.cider_d(tc, tr) == jmetrics.cider_d(tc, tr)
    got, want = pmetrics.score_captions(cands, refs), jmetrics.score_captions(cands, refs)
    assert got == want and set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L",
                                        "CIDEr"}


def test_selection_and_captioning_scorers_equal_jax():
    """Given the same embeddings (a table encoder), the selection accuracy,
    the retrieval generator's picks and the captioning metrics are JAX's;
    a ``generate_fn`` and an explicit candidate pool pass through."""
    rng = np.random.default_rng(3)
    n, d = 9, 16
    images = [Vec(v) for v in unit(rng, n, d)]
    captions = [[f"cap {i} {j}" for j in range(3)] for i in range(n)]
    pool = sorted({c for cs in captions for c in cs} | {"an extra caption"})
    enc = TableEncoder({t: v for t, v in zip(pool, unit(rng, len(pool), d))})
    assert (pselection.evaluate_caption_selection(enc, images, captions)
            == jselection.evaluate_caption_selection(enc, images, captions))
    assert (pselection.evaluate_caption_selection(enc, images, captions, true_index=2)
            == jselection.evaluate_caption_selection(enc, images, captions, true_index=2))
    got = pcaptioning.retrieval_generator(enc, pool, batch_size=4)(images)
    assert got == jcaptioning.retrieval_generator(enc, pool, batch_size=4)(images)
    for kw in ({}, {"candidates": pool}, {"generate_fn": lambda ims: ["cap 0 0"] * len(ims)}):
        assert (pcaptioning.evaluate_captioning(enc, images, captions, **kw)
                == jcaptioning.evaluate_captioning(enc, images, captions, **kw))


# -- COCO loaders ------------------------------------------------------------------
def _coco_tree(root, rng):
    """Images under ``root/images`` (some in a subdirectory), a COCO
    ``captions_val.json`` (an annotation of an unknown image id, images with
    several captions) and a Karpathy ``dataset_coco.json`` with three splits."""
    names = []
    for k in range(7):
        rel = os.path.join("val2014" if k % 2 else "", f"COCO_{k:04d}.jpg")
        path = root / "images" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (24 + k, 30, 3), dtype=np.uint8)).save(path)
        names.append(rel)
    ann = {"images": [{"id": 100 + k, "file_name": n} for k, n in enumerate(names)],
           "annotations": []}
    for a in range(20):
        ann["annotations"].append({"id": a, "image_id": 100 + int(rng.integers(0, 8)),
                                   "caption": f"caption {a} of a scene"})
    (root / "captions_val.json").write_text(json.dumps(ann))
    split = ["test", "train", "val", "test", "restval", "test", "val"]
    karpathy = {"images": [
        {"filepath": os.path.dirname(n), "filename": os.path.basename(n), "split": split[k],
         "sentences": [{"raw": f"raw {k}.{j}", "tokens": []} for j in range(1 + k % 3)]}
        for k, n in enumerate(names)]}
    (root / "dataset_coco.json").write_text(json.dumps(karpathy))


def test_coco_loaders_equal_jax(tmp_path):
    _coco_tree(tmp_path, np.random.default_rng(5))
    ann, kar = str(tmp_path / "captions_val.json"), str(tmp_path / "dataset_coco.json")
    assert pcoco.load_coco_captions(ann) == jcoco.load_coco_captions(ann)
    for split in ("test", "val", "train", "restval", "none"):
        assert pcoco.load_karpathy_split(kar, split) == jcoco.load_karpathy_split(kar, split)
    for kw in ({"annotation_path": ann}, {"annotation_path": ann, "max_items": 3},
               {"annotation_path": kar, "karpathy_split": "test"},
               {"annotation_path": kar, "karpathy_split": "val", "max_items": 1}):
        got = pcoco.COCOCaptionDataset(str(tmp_path / "images"), **kw)
        want = jcoco.COCOCaptionDataset(str(tmp_path / "images"), **kw)
        assert got.items == want.items and len(got) == len(want) > 0
        for (gi, gc), (wi, wc) in zip(got, want):
            assert gc == wc and gi.mode == wi.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))


# -- both CLIs on one checkpoint ------------------------------------------------------
@pytest.fixture(scope="module")
def caption_data(tmp_path_factory):
    """Coloured-shape scenes with, for selection, the true caption first and
    one swapped-attribute negative (``data/compositional.py``), and, for
    captioning, two references an image (the caption and "shape k")."""
    root = tmp_path_factory.mktemp("caption_data")
    rng = np.random.default_rng(41)
    pairs = pcomp.seen_pairs()
    select, refs = [], []
    for k in range(8):
        c, s = pairs[(7 * k + 3) % len(pairs)]
        Image.fromarray(pcomp.to_uint8(pcomp.draw(c, s, 40, rng))).save(root / f"{k}.jpg")
        neg = pcomp.negative_pair(c, s, ("color", "shape")[k % 2], rng)
        name = pcomp.caption_for(pcomp.COLOR_NAMES[c], pcomp.SHAPES[s])
        select.append({"image": f"{k}.jpg", "captions": [
            name, pcomp.caption_for(pcomp.COLOR_NAMES[neg[0]], pcomp.SHAPES[neg[1]])]})
        refs.append({"image": f"{k}.jpg", "captions": [name, f"shape {k}"]})
    (root / "select.json").write_text(json.dumps(select))
    (root / "refs.json").write_text(json.dumps(refs))
    return root


def _selection_scores(log):
    """Each image against its two candidates: the true one against the other."""
    img = log[0][1]
    scores = np.einsum("nd,ncd->nc", img, log[1][1].reshape(len(img), -1, img.shape[1]))
    return [against_others(scores, np.arange(scores.shape[1]) == 0)]


def _captioning_scores(log):
    """The pool is encoded first, then the images: each image's best
    candidate against its second best."""
    scores = log[1][1] @ log[0][1].T
    return [-np.sort(-scores, axis=-1)[:, :2]]


CAPTION_CASES = {
    "image_caption_selection": ("select.json", _selection_scores),
    "captioning": ("refs.json", _captioning_scores),
}


@pytest.mark.parametrize("task", sorted(CAPTION_CASES))
def test_caption_tasks_cli_matches_jax(task, caption_data, ckpts, recorded, tmp_path):
    """``eval --task image_caption_selection`` / ``--task captioning`` through
    both CLIs on the same checkpoint and data: the same encoder calls within
    ATOL, every decision's scores within SCORE_ATOL and apart by more than
    twice it, the same metrics, records and record files."""
    spec, scores = CAPTION_CASES[task]
    args = ["eval", "--dataset", f"retrieval_json:{caption_data}/{spec}", "--dataset_root",
            str(caption_data), "--task", task]
    ckpt = ckpts["fdt"][1]
    want = jcli.main(_argv(args, caption_data, ckpt, tmp_path / "jax"))
    got = pcli.main(_argv(args, caption_data, ckpt, tmp_path / "port") + ["--device", "cpu"])
    log_j, log_p = recorded["jax"], recorded["port"]
    assert [k for k, _ in log_p] == [k for k, _ in log_j] and len(log_j) == 2
    for (_, w), (_, g) in zip(log_j, log_p):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    for w, g in zip(scores(log_j), scores(log_p)):
        assert_decisions(w, g, SCORE_ATOL)
    assert got == want and got["task"] == task
    metrics = got["metrics"]
    if task == "captioning":
        assert set(metrics) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr"}
    else:
        assert set(metrics) == {"acc"} and 0.0 <= metrics["acc"] <= 1.0
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")


# -- the HF adapter -------------------------------------------------------------------
@pytest.fixture(scope="module")
def hf_model_dir(tmp_path_factory):
    """A tiny rinna-shaped dual encoder (CLIP-ViT vision + BERT text,
    ``VisionTextDualEncoderModel``), its tokenizer and image processor, built
    offline (``tests/test_hf_adapter.py``'s fixture)."""
    pytest.importorskip("transformers")
    from transformers import (
        BertConfig, BertTokenizer, CLIPImageProcessor, CLIPVisionConfig,
        VisionTextDualEncoderConfig, VisionTextDualEncoderModel,
    )

    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("hf_ja_clip")
    vision = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                              num_attention_heads=2, image_size=32, patch_size=16)
    text = BertConfig(vocab_size=32, hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)
    cfg = VisionTextDualEncoderConfig.from_vision_text_configs(vision, text, projection_dim=16)
    VisionTextDualEncoderModel(cfg).save_pretrained(d)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "dog", "photo", "of",
             "the", "##s"]
    vocab_file = os.path.join(d, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(vocab))
    BertTokenizer(vocab_file).save_pretrained(d)
    CLIPImageProcessor(size={"shortest_edge": 32},
                       crop_size={"height": 32, "width": 32}).save_pretrained(d)
    return str(d)


HF_ATOL = 1e-6  # the same torch model on the CPU on both sides
HF_TEXTS = ["a photo of a cat", "a photo of a dog", "cats", "the dog of the cat"]


@pytest.mark.parametrize("model_type", ["ja_clip", "nllb_clip"])
def test_hf_encoder_matches_jax(hf_model_dir, model_type):
    """PIL images, raw uint8 frames and preprocessed float arrays (batch 2, so
    the last batch is partial), texts, and raw features: the port's adapter
    on ``device="cpu"`` gives the JAX adapter's embeddings within HF_ATOL."""
    from iterated_learning_for_vlm_tpu.eval.hf_adapter import HFClipEncoder as JHF
    from iterated_learning_for_vlm_tpu_torch.eval.hf_adapter import HFClipEncoder

    port = HFClipEncoder(hf_model_dir, model_type=model_type, batch_size=2, device="cpu")
    jax_side = JHF(hf_model_dir, model_type=model_type, batch_size=2)
    assert port.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in port.model.parameters())
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (3, 32, 32, 3), dtype=np.uint8)
    pils = [Image.fromarray(f) for f in frames]
    pre = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    for images in (pils, frames, pre):
        got, want = port.encode_images(images), jax_side.encode_images(images)
        assert got.shape == want.shape == (3, 16)
        np.testing.assert_allclose(got, want, atol=HF_ATOL, rtol=0)
    for normalize in (None, False):
        got = port.encode_texts(HF_TEXTS, normalize=normalize)
        want = jax_side.encode_texts(HF_TEXTS, normalize=normalize)
        assert got.shape == want.shape == (4, 16)
        np.testing.assert_allclose(got, want, atol=HF_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(port.encode_texts(HF_TEXTS), axis=-1), 1.0,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="raw-pixel"):
        port.encode_images(frames.astype(np.float32) / 255.0)


def test_hf_language_map_equals_jax():
    from iterated_learning_for_vlm_tpu.eval import hf_adapter as jhf
    from iterated_learning_for_vlm_tpu_torch.eval import hf_adapter as phf

    assert phf._NLLB_LANG == jhf._NLLB_LANG
    for code in list(jhf._NLLB_LANG) + ["zho_Hant", "eng_Latn", "xx", "abc_d_e"]:
        try:
            want = jhf.nllb_language_code(code)
        except KeyError:
            with pytest.raises(KeyError):
                phf.nllb_language_code(code)
        else:
            assert phf.nllb_language_code(code) == want


@pytest.fixture
def tiny_dummies(monkeypatch):
    """Both packages' dummy set as four 32-px images of two classes."""
    def make(mod):
        rng = np.random.default_rng(0)
        return lambda n=8: mod.EvalDataset(
            name="dummy", task="zeroshot_classification",
            images=[Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype("uint8"))
                    for _ in range(4)],
            labels=np.asarray([0, 1, 0, 1]), classnames=["cat", "dog"],
            templates=["a photo of {}"])

    monkeypatch.setattr(jbuilder, "build_dummy", make(jbuilder))
    monkeypatch.setattr(pbuilder, "build_dummy", make(pbuilder))


@pytest.mark.parametrize("model_type", ["ja_clip", "nllb_clip"])
def test_hf_cli_matches_jax(hf_model_dir, model_type, tiny_dummies, tmp_path):
    """``eval --model_type ja_clip|nllb_clip --pretrained <HF dir>`` with no
    ``--model_config`` through both CLIs: the same record (the metrics from
    the same embeddings), and the port's on ``--device cpu``."""
    argv = ["eval", "--model_type", model_type, "--pretrained", hf_model_dir, "--dataset",
            "dummy", "--batch_size", "2", "--quiet"]
    want = jcli.main(argv + ["--output", str(tmp_path / "j.json")])
    got = pcli.main(argv + ["--output", str(tmp_path / "p.json"), "--device", "cpu"])
    assert got == want and got["model"] is None and got["pretrained"] == hf_model_dir
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_hf_refusals(hf_model_dir, monkeypatch, capsys):
    """No ``--pretrained``, a soup (one directory is the model);
    no card and no device named; and without ``transformers`` the adapter
    raises ``ImportError`` naming it (no fallback)."""
    from iterated_learning_for_vlm_tpu_torch.eval.hf_adapter import HFClipEncoder

    with pytest.raises(SystemExit):
        pcli.main(["eval", "--model_type", "ja_clip", "--dataset", "dummy"])
    assert "local HF save_pretrained" in capsys.readouterr().err
    with pytest.raises(ValueError, match="ONE local HF"):
        ploader.load_eval_encoder(None, [hf_model_dir, hf_model_dir], model_type="ja_clip",
                                  device="cpu")
    enc = ploader.load_eval_encoder(None, hf_model_dir, model_type="nllb_clip",
                                    batch_size=3, device="cpu")
    assert isinstance(enc, HFClipEncoder) and enc.batch_size == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HFClipEncoder(hf_model_dir)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        HFClipEncoder(hf_model_dir, device="cpu")


def test_hf_image_processor_where_auto_needs_torchvision(hf_model_dir, monkeypatch):
    """Where ``AutoImageProcessor`` raises ``ImportError`` (transformers 5
    without torchvision), the adapter loads the class the directory names and
    gives the same image embeddings."""
    import transformers

    from iterated_learning_for_vlm_tpu_torch.eval.hf_adapter import HFClipEncoder

    rng = np.random.default_rng(2)
    pils = [Image.fromarray(rng.integers(0, 255, (40, 36, 3), dtype=np.uint8)) for _ in range(3)]
    want = HFClipEncoder(hf_model_dir, batch_size=2, device="cpu").encode_images(pils)

    def needs_torchvision(*a, **k):
        raise ImportError("AutoImageProcessor requires the Torchvision library")

    monkeypatch.setattr(transformers.AutoImageProcessor, "from_pretrained", needs_torchvision)
    enc = HFClipEncoder(hf_model_dir, batch_size=2, device="cpu")
    assert type(enc.processor).__name__.startswith("CLIPImageProcessor")
    np.testing.assert_array_equal(enc.encode_images(pils), want)


def test_hf_features_from_model_outputs(hf_model_dir, monkeypatch):
    """transformers 5's ``get_*_features`` return a model output whose
    ``pooler_output`` holds the projected features: the adapter takes it and
    gives the same embeddings; one without ``projection_dim`` columns raises."""
    from transformers.modeling_outputs import BaseModelOutputWithPooling

    from iterated_learning_for_vlm_tpu_torch.eval.hf_adapter import HFClipEncoder

    enc = HFClipEncoder(hf_model_dir, batch_size=2, device="cpu")
    rng = np.random.default_rng(4)
    pils = [Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)) for _ in range(3)]
    want = enc.encode_images(pils), enc.encode_texts(HF_TEXTS)
    for name in ("get_image_features", "get_text_features"):
        monkeypatch.setattr(enc.model, name, lambda *a, _f=getattr(enc.model, name), **k:
                            BaseModelOutputWithPooling(pooler_output=_f(*a, **k)))
    np.testing.assert_array_equal(enc.encode_images(pils), want[0])
    np.testing.assert_array_equal(enc.encode_texts(HF_TEXTS), want[1])
    monkeypatch.setattr(enc.model, "get_text_features",
                        lambda *a, **k: BaseModelOutputWithPooling(pooler_output=torch.ones(2, 5)))
    with pytest.raises(ValueError, match="projection_dim 16"):
        enc.encode_texts(HF_TEXTS)
