"""Evaluation dataset builder.

A copy of ``iterated_learning_for_vlm_tpu/eval/builder.py`` over the port's
``data/shards.py`` and ``data/synthetic.py``.

Parity target: reference ``CLIP_benchmark/clip_benchmark/datasets/builder.py``
(898 LoC registry).  Supported here:

- ``dummy``: the reference's test fixture (one blank image, two classnames).
- ``wds/<name>`` local webdataset-protocol directories: ``nshards.txt``,
  ``classnames.txt``, ``zeroshot_templates.txt`` plus tar shards named
  ``{0..n}.tar`` containing image + ``cls``/``txt``/``json`` members —
  the exact on-disk layout the reference consumes from HF-hosted eval sets
  (builder.py:698-797) minus the network fetch (zero-egress environment).
- ``folder:<path>``: torchvision ImageFolder-style class-per-directory trees.
- ``retrieval_json:<path>``: COCO/Flickr karpathy-style JSON
  (``[{image: path, captions: [...]}, ...]``) for retrieval tasks.
- ``cifar:<path>`` / ``npz:<path>``: CIFAR pickle batches or npz arrays.
- ``mnist:<dir>``: raw idx-ubyte MNIST layout (``train-images-idx3-ubyte`` /
  ``t10k-...``, optionally ``.gz``) — the torchvision download layout
  (builder.py:407-410) read without torchvision.
- ``voc:<root>`` / ``voc_cropped:<root>``: PASCAL VOC2007 devkit trees —
  multilabel presence targets (``voc2007_multilabel``, voc2007.py:170-210)
  and the per-bounding-box single-label crop variant (``voc2007``,
  voc2007.py:213-247).
- ``flickr_txt:<file>``: Flickr8k/30k ``captions.txt`` / karpathy-txt
  annotations (``img.jpg,caption`` lines, header skipped; flickr.py:26-36),
  images under ``--dataset_root``.
- ``multilingual_mscoco_captions:<dir>`` / ``flickr30k_200:<dir>`` /
  ``xtd200:<dir>`` / ``crossmodal3600:<dir>``: per-language retrieval
  annotation JSONs ``{image_paths: [...], annotations: [...]}`` resolved by
  the reference filename templates (e.g.
  ``multilingual_mscoco_captions-{lang}.json``; multilingual_mscoco.py:18,
  flickr30k_200.py:20, xtd200.py:20, crossmodal3600.py:52 + builder.py
  266-299) — the files the reference *creates* on first use; here they are
  read from disk (zero-egress), selected by ``--language``.

Each build returns an :class:`EvalDataset` with uniform fields, and
``default_task`` mirrors the reference's task inference.
"""
from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from ..data.shards import iter_tar_samples

DEFAULT_TEMPLATES = ["a photo of a {}."]


@dataclass
class EvalDataset:
    name: str
    task: str  # zeroshot_classification | zeroshot_retrieval | linear_probe
    images: List = field(default_factory=list)  # PIL images (lazy ok)
    labels: Optional[np.ndarray] = None
    classnames: List[str] = field(default_factory=list)
    templates: List[str] = field(default_factory=list)
    captions_per_image: Optional[List[List[str]]] = None

    def __len__(self):
        return len(self.images)


def _read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [l.strip() for l in f if l.strip()]


def build_dummy(n: int = 8) -> EvalDataset:
    from ..data.synthetic import DummyDataset

    d = DummyDataset(n=n)
    images = [Image.fromarray((np.clip(x, 0, 1) * 255).astype(np.uint8)) for x in d.images]
    return EvalDataset(
        name="dummy", task="zeroshot_classification", images=images,
        labels=np.asarray(d.labels), classnames=d.classes, templates=d.templates,
    )


def build_wds_dataset(root: str, name: str, split: str = "test") -> EvalDataset:
    """Load a local wds-protocol eval set directory."""
    base = os.path.join(root, split) if os.path.isdir(os.path.join(root, split)) else root
    classnames = (
        _read_lines(os.path.join(root, "classnames.txt"))
        if os.path.exists(os.path.join(root, "classnames.txt"))
        else []
    )
    tmpl_path = os.path.join(root, "zeroshot_classification_templates.txt")
    templates = _read_lines(tmpl_path) if os.path.exists(tmpl_path) else list(DEFAULT_TEMPLATES)

    nshards_path = os.path.join(base, "nshards.txt")
    if os.path.exists(nshards_path):
        nshards = int(_read_lines(nshards_path)[0])
        shard_paths = [os.path.join(base, f"{i}.tar") for i in range(nshards)]
    else:
        shard_paths = sorted(
            os.path.join(base, f) for f in os.listdir(base) if f.endswith(".tar")
        )

    images, labels, captions = [], [], []
    has_captions = False
    for shard in shard_paths:
        for sample in iter_tar_samples(shard):
            img_bytes = next(
                (sample[e] for e in ("jpg", "jpeg", "png", "webp") if e in sample), None
            )
            if img_bytes is None:
                continue
            images.append(Image.open(io.BytesIO(img_bytes)).convert("RGB"))
            if "cls" in sample:
                labels.append(int(sample["cls"].decode().strip()))
            if "txt" in sample:
                has_captions = True
                captions.append(sample["txt"].decode("utf-8").split("\n"))
            elif "json" in sample:
                obj = json.loads(sample["json"])
                caps = obj.get("captions") or ([obj["caption"]] if "caption" in obj else None)
                if caps:
                    has_captions = True
                    captions.append(caps)

    if has_captions and not labels:
        return EvalDataset(name=name, task="zeroshot_retrieval", images=images,
                           captions_per_image=captions, templates=templates)
    return EvalDataset(
        name=name, task="zeroshot_classification", images=images,
        labels=np.asarray(labels, np.int64) if labels else None,
        classnames=classnames, templates=templates,
    )


def build_folder_dataset(path: str, name: str) -> EvalDataset:
    classes = sorted(
        d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))
    )
    images, labels = [], []
    for ci, c in enumerate(classes):
        cdir = os.path.join(path, c)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith((".jpg", ".jpeg", ".png", ".webp")):
                images.append(Image.open(os.path.join(cdir, fn)).convert("RGB"))
                labels.append(ci)
    return EvalDataset(
        name=name, task="zeroshot_classification", images=images,
        labels=np.asarray(labels), classnames=[c.replace("_", " ") for c in classes],
        templates=list(DEFAULT_TEMPLATES),
    )


def build_retrieval_json(path: str, name: str, image_root: str = "") -> EvalDataset:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    images, captions = [], []
    for item in data:
        images.append(Image.open(os.path.join(image_root, item["image"])).convert("RGB"))
        captions.append(list(item["captions"]))
    return EvalDataset(name=name, task="zeroshot_retrieval", images=images,
                       captions_per_image=captions)


def build_cifar_dataset(path: str, name: str, split: str = "test") -> EvalDataset:
    """CIFAR-style local datasets, two on-disk layouts:

    - ``.npz`` file with arrays ``images`` (N,H,W,3 uint8), ``labels`` and
      optionally ``classnames``;
    - a directory of CIFAR-10 python pickle batches (``data_batch_*`` /
      ``test_batch`` with ``b"data"``/``b"labels"`` and ``batches.meta``),
      the torchvision download layout.
    """
    import pickle

    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        images_arr = z["images"]
        labels = np.asarray(z["labels"], np.int64)
        classnames = [str(c) for c in z["classnames"]] if "classnames" in z else []
    else:
        batches = (
            sorted(f for f in os.listdir(path) if f.startswith("data_batch"))
            if split == "train" else ["test_batch"]
        )
        data, labels = [], []
        for b in batches:
            with open(os.path.join(path, b), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data.append(d[b"data"])
            labels.extend(d.get(b"labels", d.get(b"fine_labels", [])))
        flat = np.concatenate(data)  # [N, 3072] CHW-flattened
        side = int(np.sqrt(flat.shape[1] // 3))
        images_arr = flat.reshape(-1, 3, side, side).transpose(0, 2, 3, 1)
        labels = np.asarray(labels, np.int64)
        classnames = []
        meta = os.path.join(path, "batches.meta")
        if os.path.exists(meta):
            with open(meta, "rb") as f:
                m = pickle.load(f, encoding="bytes")
            classnames = [c.decode() for c in m.get(b"label_names", [])]
    images = [Image.fromarray(np.asarray(x, np.uint8)) for x in images_arr]
    return EvalDataset(
        name=name, task="zeroshot_classification", images=images, labels=labels,
        classnames=classnames, templates=list(DEFAULT_TEMPLATES),
    )


def build_npz_dataset(path: str, name: str, split: str = "test") -> EvalDataset:
    return build_cifar_dataset(path, name, split)


MNIST_CLASSNAMES = [str(i) for i in range(10)]
MNIST_TEMPLATES = ['a photo of the number: "{c}".']


def _read_idx(path: str) -> np.ndarray:
    """Parse an idx-ubyte file (the raw MNIST wire format), .gz transparent."""
    import gzip
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        assert magic[0] == 0, f"{path}: bad idx magic {magic}"
        ndim = magic[2]
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def build_mnist_dataset(path: str, name: str, split: str = "test") -> EvalDataset:
    """Raw MNIST idx layout (reference builder.py:407-410 via torchvision;
    classnames/templates from en_classnames.json / ..._templates.json)."""
    prefix = "train" if split == "train" else "t10k"

    def _find(kind):
        for suffix in ("", ".gz"):
            p = os.path.join(path, f"{prefix}-{kind}-ubyte{suffix}")
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no {prefix}-{kind}-ubyte[.gz] under {path}")

    images_arr = _read_idx(_find("images-idx3"))
    labels = _read_idx(_find("labels-idx1")).astype(np.int64)
    images = [Image.fromarray(x, mode="L").convert("RGB") for x in images_arr]
    return EvalDataset(
        name=name, task="zeroshot_classification", images=images, labels=labels,
        classnames=list(MNIST_CLASSNAMES), templates=list(MNIST_TEMPLATES),
    )


VOC2007_CLASSNAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def _voc_read_split(root: str, split: str) -> List[str]:
    """Image ids for a split (reference voc2007.py:137-149 reads the first
    category's ``ImageSets/Main/{cat}_{split}.txt``; a plain ``{split}.txt``
    works too)."""
    main = os.path.join(root, "VOCdevkit", "VOC2007", "ImageSets", "Main")
    for fn in (f"{VOC2007_CLASSNAMES[0]}_{split}.txt", f"{split}.txt"):
        p = os.path.join(main, fn)
        if os.path.exists(p):
            return [line.split()[0] for line in _read_lines(p)]
    raise FileNotFoundError(f"no split file for {split!r} under {main}")


def _voc_read_boxes(root: str, ids: Sequence[str]):
    """(image_id, (l,t,r,b), class_idx) per annotated object
    (reference voc2007.py:152-167)."""
    import xml.etree.ElementTree as ET

    cat_idx = {c: i for i, c in enumerate(VOC2007_CLASSNAMES)}
    anno = os.path.join(root, "VOCdevkit", "VOC2007", "Annotations")
    out = []
    for image_id in ids:
        tree = ET.parse(os.path.join(anno, image_id + ".xml"))
        for obj in tree.findall("object"):
            c = cat_idx[obj.find("name").text.strip()]
            bb = obj.find("bndbox")
            box = tuple(int(float(bb.find(k).text)) for k in ("xmin", "ymin", "xmax", "ymax"))
            out.append((image_id, box, c))
    return out


def build_voc_dataset(root: str, name: str, split: str = "test",
                      cropped: bool = False) -> EvalDataset:
    """PASCAL VOC2007 from a local devkit tree.

    ``cropped=False``: one sample per image with a multihot ``[N, 20]``
    presence target (reference ``PASCALVoc2007``, voc2007.py:170-210; the
    harness infers the multilabel mAP path from ``labels.ndim == 2``,
    matching reference zeroshot_classification.py:212-214).
    ``cropped=True``: one sample per bounding box, cropped to the box, with
    a single class label (reference ``PASCALVoc2007Cropped``).
    """
    ids = _voc_read_split(root, split)
    boxes = _voc_read_boxes(root, ids)
    img_dir = os.path.join(root, "VOCdevkit", "VOC2007", "JPEGImages")
    templates = ["a photo of a {c}."]  # en_zeroshot_classification_templates.json:voc2007
    if cropped:
        images, labels = [], []
        for image_id, box, c in boxes:
            img = Image.open(os.path.join(img_dir, image_id + ".jpg")).convert("RGB")
            images.append(img.crop(box))
            labels.append(c)
        return EvalDataset(
            name=name, task="zeroshot_classification", images=images,
            labels=np.asarray(labels, np.int64),
            classnames=list(VOC2007_CLASSNAMES), templates=templates,
        )
    index = {image_id: i for i, image_id in enumerate(ids)}
    labels = np.zeros((len(ids), len(VOC2007_CLASSNAMES)), np.int64)
    for image_id, _, c in boxes:
        labels[index[image_id], c] = 1
    images = [
        Image.open(os.path.join(img_dir, image_id + ".jpg")).convert("RGB")
        for image_id in ids
    ]
    return EvalDataset(
        name=name, task="zeroshot_classification", images=images, labels=labels,
        classnames=list(VOC2007_CLASSNAMES), templates=templates,
    )


def build_flickr_txt(path: str, name: str, image_root: str = "") -> EvalDataset:
    """Flickr-style ``captions.txt`` / karpathy-txt annotations: a header
    line, then ``img.jpg,caption`` rows (captions may contain commas — split
    on ``.jpg,`` exactly as reference flickr.py:26-36); captions grouped per
    image, images loaded from ``image_root``."""
    groups: dict = {}
    with open(path, encoding="utf-8") as f:
        f.readline()  # header
        for line in f:
            line = line.strip()
            if not line:
                continue
            img, caption = line.split(".jpg,", 1)
            groups.setdefault(img + ".jpg", []).append(caption)
    images = [
        Image.open(os.path.join(image_root, img)).convert("RGB") for img in groups
    ]
    return EvalDataset(name=name, task="zeroshot_retrieval", images=images,
                       captions_per_image=list(groups.values()))


# reference per-language annotation filename templates
ML_RETRIEVAL_TEMPLATES = {
    "multilingual_mscoco_captions": "multilingual_mscoco_captions-{}.json",
    "flickr30k_200": "flickr30k_200-{}.json",
    "xtd200": "xtd200-{}.json",
    "crossmodal3600": "crossmodal3600_captions-{}.json",
}


def build_ml_retrieval(dir_path: str, name: str, language: str,
                       image_root: str = "") -> EvalDataset:
    """Multilingual retrieval sets (reference multilingual_mscoco.py /
    flickr30k_200.py / xtd200.py / crossmodal3600.py): one annotation JSON
    per language, ``{"image_paths": [...], "annotations": [...]}``, one
    caption (or caption list) per image."""
    ann = os.path.join(dir_path, ML_RETRIEVAL_TEMPLATES[name].format(language))
    if not os.path.exists(ann):
        raise FileNotFoundError(
            f"no {name!r} annotations for language {language!r}: {ann}")
    with open(ann, encoding="utf-8") as f:
        data = json.load(f)
    images = [
        Image.open(p if os.path.isabs(p) else os.path.join(image_root or dir_path, p)).convert("RGB")
        for p in data["image_paths"]
    ]
    captions = [[c] if isinstance(c, str) else list(c) for c in data["annotations"]]
    return EvalDataset(name=f"{name}-{language}", task="zeroshot_retrieval",
                       images=images, captions_per_image=captions)


def build_babel_imagenet(root: str, language: str, split: str = "test") -> EvalDataset:
    """Babel-ImageNet: the per-language ImageNet class subset benchmark
    (reference ``datasets/builder.py:125-137`` + ``datasets/babel_imagenet.py``;
    tables from gregor-ge/Babel-ImageNet, shipped verbatim in
    ``eval/languages/``).  ``babel_imagenet.json`` maps ``LANG -> [idxs,
    classnames]`` — the ImageNet class indices that language covers —
    and ``nllb_dist13b_prompts.json`` maps ``LANG`` to NLLB-translated
    prompt templates.  ``root`` is a local imagenet layout (wds-protocol dir
    or class folders); samples outside the language's classes are dropped and
    labels are re-indexed into the subset, exactly as the reference's
    ``BabelImageNet.__getitem__`` does."""
    lang_dir = os.path.join(os.path.dirname(__file__), "languages")
    with open(os.path.join(lang_dir, "babel_imagenet.json"), encoding="utf-8") as f:
        tables = json.load(f)
    lang = language.upper()
    if lang not in tables:
        raise KeyError(f"language {language!r} not in Babel-ImageNet "
                       f"({len(tables)} languages available)")
    idxs, classnames = tables[lang]
    with open(os.path.join(lang_dir, "nllb_dist13b_prompts.json"), encoding="utf-8") as f:
        templates = json.load(f)[lang]
    templates = [t.replace("{}", "{c}") for t in templates]

    if os.path.exists(os.path.join(root, "classnames.txt")) or any(
        fn.endswith(".tar") for fn in os.listdir(root)
    ):
        base = build_wds_dataset(root, "imagenet1k", split)
    else:
        base = build_folder_dataset(root, "imagenet1k")
    remap = {int(orig): i for i, orig in enumerate(idxs)}
    keep = [i for i, l in enumerate(base.labels) if int(l) in remap]
    return EvalDataset(
        name=f"babel_imagenet_{lang}", task="zeroshot_classification",
        images=[base.images[i] for i in keep],
        labels=np.asarray([remap[int(base.labels[i])] for i in keep], np.int64),
        classnames=list(classnames), templates=templates,
    )


def build_dataset(name: str, root: str = "", split: str = "test",
                  language: str = "en", annotation_file: str = "") -> EvalDataset:
    """Dispatch mirroring the reference ``build_dataset`` protocol names.

    ``annotation_file`` mirrors the reference ``--annotation_file`` flag
    (cli.py / datasets/builder.py mscoco_captions & flickr): retrieval
    annotations supplied separately from the dataset name — a karpathy-style
    JSON or a flickr ``captions.txt``, with images under ``root``."""
    for ml_name in ML_RETRIEVAL_TEMPLATES:
        if name.startswith(ml_name + ":"):
            return build_ml_retrieval(name[len(ml_name) + 1:], ml_name,
                                      language, image_root=root)
    if name == "dummy":
        return build_dummy()
    if name == "babel_imagenet" or name.startswith("babel_imagenet:"):
        bi_root = name.split(":", 1)[1] if ":" in name else root
        return build_babel_imagenet(bi_root, language, split)
    if name.startswith("wds/"):
        ds_name = name[len("wds/"):]
        ds_root = root.format(dataset=ds_name) if "{dataset}" in root else root
        return build_wds_dataset(ds_root, ds_name, split)
    if name.startswith("folder:"):
        return build_folder_dataset(name[len("folder:"):], os.path.basename(name))
    if name.startswith("retrieval_json:"):
        return build_retrieval_json(name[len("retrieval_json:"):], name, image_root=root)
    if name.startswith("cifar:") or name.startswith("npz:"):
        path = name.split(":", 1)[1]
        return build_cifar_dataset(path, os.path.basename(path).split(".")[0], split)
    if name.startswith("mnist:"):
        path = name[len("mnist:"):]
        return build_mnist_dataset(path, "mnist", split)
    if name.startswith("voc_cropped:"):
        return build_voc_dataset(name[len("voc_cropped:"):], "voc2007", split, cropped=True)
    if name.startswith("voc:"):
        return build_voc_dataset(name[len("voc:"):], "voc2007_multilabel", split)
    if name.startswith("flickr_txt:"):
        return build_flickr_txt(name[len("flickr_txt:"):], "flickr", image_root=root)
    if annotation_file:
        # bare retrieval names (mscoco_captions / flickr30k / flickr8k ...)
        # resolved by the external annotation file, reference-style
        if annotation_file.endswith(".json"):
            return build_retrieval_json(annotation_file, name, image_root=root)
        return build_flickr_txt(annotation_file, name, image_root=root)
    raise KeyError(f"unknown dataset spec {name!r}")


def apply_language(ds: EvalDataset, language: str, lang_root: Optional[str] = None,
                   dataset_key: Optional[str] = None) -> EvalDataset:
    """Swap classnames/templates for another language (reference
    ``cli.py:116-195`` + per-language ``{lang}_classnames.json`` /
    ``{lang}_zeroshot_classification_templates.json`` in ``datasets/``).

    JSON shape: ``{dataset_name: [entries...]}``.  Missing language or
    dataset entries leave the English defaults untouched (same fallback as
    the reference).
    """
    if not language or language == "en":
        return ds
    lang_root = lang_root or os.path.join(os.path.dirname(__file__), "languages")
    key = dataset_key or ds.name

    def _load(kind):
        p = os.path.join(lang_root, f"{language}_{kind}.json")
        if not os.path.exists(p):
            return None
        with open(p, encoding="utf-8") as f:
            return json.load(f).get(key)

    classnames = _load("classnames")
    templates = _load("zeroshot_classification_templates")
    if classnames:
        ds.classnames = list(classnames)
    if templates:
        ds.templates = list(templates)
    return ds


def default_task(dataset: EvalDataset) -> str:
    return dataset.task
