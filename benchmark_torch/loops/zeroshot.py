"""Zero-shot classification cells: the port's eval path, rounds of classifier and images.

The encoder is built as the eval CLI builds it (``load_eval_encoder``: the
configuration's model, ``batch_size``, ``num_workers``), its parameters set
to the benchmark's draw from ``--seed``. The window runs chunks until
``--seconds`` have passed; a chunk is

- ``build_zeroshot_classifier`` over ``chunk_classes`` of the ImageNet-1k
  class names (the port's ``eval/languages/en_classnames.json``) with the 80
  templates, one encoder call per class as the CLI makes them, then
- ``chunk_images`` JPEGs decoded with Pillow and put through
  ``encode_images`` (``preprocess``, then ``image_batch`` at ``batch_size``),

and every ``1000 / chunk_classes`` chunks the round's images are scored
against its classifier. ``--seed`` draws the weights and the order in which
classes and images come, never how many. After the window, a sample drawn
from the seed of the classifier's columns and of the image embeddings that
the window produced is recomputed by the plain reference: the columns from
the token ids the encoder's text calls took, the embeddings from the JPEG
bytes through the reference's own decode and transform
(``reference/preprocess.py``), so the program's preprocessing is inside the
comparison. The largest gaps are compared with the cell's limits.
"""
from __future__ import annotations

import gc
import io
import time
from typing import Dict

import numpy as np
import torch

import corpus
import harness
from reference import clip as ref
from reference import preprocess


class Captured:
    """The encoder's text calls in the window: the token ids of the sampled
    columns, and the rows the calls were given."""

    def __init__(self, encoder, text_keep):
        self.on = True
        self.text = []
        self.rows = {"real": 0, "padded": 0}
        self.calls = 0
        text_batch = encoder.text_batch
        tokens_call = encoder.encode_texts_tokens

        def counted_tokens(tokens, pad_mask, normalize=None):
            if self.on:
                real = len(tokens)
                self.rows["real"] += real
                self.rows["padded"] += -(-real // encoder.batch_size) * encoder.batch_size
            return tokens_call(tokens, pad_mask, normalize)

        def text(tokens, pad_mask, normalize=None):
            if self.on:
                keep = text_keep(self.calls)
                if keep:
                    self.text.append((tokens[:keep].clone(), pad_mask[:keep].clone()))
                self.calls += 1
            return text_batch(tokens, pad_mask, normalize)

        encoder.encode_texts_tokens = counted_tokens
        encoder.text_batch = text


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    outcome, (text, image, answers, temperature) = serve(cell, seed, seconds, trace, device,
                                                         process_start)
    found = eval_gaps(cell.config, seed, text, image, answers, temperature, device)
    outcome["checks"] = {k: {"value": found[k], "limit": v} for k, v in cell.limits.items()}
    return outcome


def calibrate(cell, seed: int, variants, device, process_start: float, seconds: float):
    """The compared numbers of the program's window and of the control (the
    reference in fp8 in the program's place), one row per variant."""
    _, (text, image, answers, temperature) = serve(cell, seed, seconds, False, device,
                                                   process_start)
    rows = []
    for variant in variants:
        if variant == "program":
            found = eval_gaps(cell.config, seed, text, image, answers, temperature, device)
        else:
            cols, embs = reference_embeddings(cell.config, seed, text, image, temperature,
                                              device, variant)
            found = eval_gaps(cell.config, seed, text, image,
                              {"columns": cols, "images": embs}, temperature, device)
        rows.append({"variant": variant, **found})
    return rows


def serve(cell, seed: int, seconds: float, trace: bool, device, process_start: float):
    """Set up, run the window (and the traced chunks), free the encoder; the
    outcome without checks, and what the check compares."""
    from PIL import Image

    from iterated_learning_for_vlm_tpu_torch.eval.model_loader import load_eval_encoder
    from iterated_learning_for_vlm_tpu_torch.eval.prompts import PROMPT_80
    from iterated_learning_for_vlm_tpu_torch.eval.zeroshot_classification import (
        accuracy_topk, build_zeroshot_classifier)
    from iterated_learning_for_vlm_tpu_torch.utils.config import Config

    config, traffic = cell.config, cell.traffic
    classnames = [str(c) for c in harness.load_json(
        harness.ROOT / "iterated_learning_for_vlm_tpu_torch" / "eval" / "languages"
        / "en_classnames.json")["imagenet1k"]]
    classnames = classnames[:traffic["classes"]]
    n_cls, per_cls, per_img = len(classnames), traffic["chunk_classes"], traffic["chunk_images"]
    paths = corpus.ensure_images(traffic["images"])
    jpegs = []
    for path in paths:
        with open(path, "rb") as f:
            jpegs.append(f.read())
    n_img, chunks_per_round = len(jpegs), n_cls // per_cls
    if n_cls % per_cls or n_img != chunks_per_round * per_img:
        raise ValueError("a round must be whole chunks of classes and of images")
    rng = np.random.default_rng(seed)
    class_order, image_order = rng.permutation(n_cls), rng.permutation(n_img)
    # the sample: per chunk, one class's prompts and `sample_images` image rows
    sample_classes = [int(rng.integers(per_cls)) for _ in range(4096)]
    sample_rows = [np.sort(rng.choice(traffic["batch_size"], traffic["sample_images"],
                                      replace=False)) for _ in range(4096)]

    params0 = ref.init_params(config, seed, device)
    encoder = load_eval_encoder(Config({"model": config["model"]}), None,
                                batch_size=traffic["batch_size"],
                                num_workers=traffic["num_workers"], device=device)
    harness.load_params(encoder.model, params0)
    del params0
    templates = {"PROMPT_80": PROMPT_80}[traffic["templates"]]
    if per_img != encoder.batch_size or len(templates) > encoder.batch_size:
        raise ValueError("a chunk's images fill one image batch and a class's prompts one "
                         "text batch")

    def chunk(i):
        """Chunk ``i`` of the stream: its classifier columns and embeddings."""
        k = i % chunks_per_round
        cls = class_order[k * per_cls:(k + 1) * per_cls]
        imgs = image_order[k * per_img:(k + 1) * per_img]
        columns = build_zeroshot_classifier(encoder, [classnames[c] for c in cls], templates)
        pil = [Image.open(io.BytesIO(jpegs[j])).convert("RGB") for j in imgs]
        return cls, imgs, columns, encoder.encode_images(pil)

    # set-up: every text bucket and the image batch, warmed once
    for ctx in encoder.text_buckets:
        tok = torch.zeros((encoder.batch_size, ctx), dtype=torch.int64, device=device)
        tok[:, 0], tok[:, 1] = ref.sizes(config)["text"]["vocab_size"] - 2, 320
        tok[:, 2] = ref.sizes(config)["text"]["vocab_size"] - 1
        pad = torch.where(torch.arange(ctx, device=device) < 3, 0.0, float("-inf"))
        encoder.text_batch(tok, pad.expand(encoder.batch_size, ctx).contiguous())
    chunk(chunks_per_round - 1)
    if trace:
        harness.warm_profiler(device)
    if device.type == "cuda":
        torch.cuda.synchronize()

    # one text call per class (its 80 prompts fit one batch)
    captured = Captured(
        encoder,
        text_keep=lambda call: (len(templates) if call % per_cls
                                == sample_classes[call // per_cls] else 0))
    t0 = time.perf_counter()
    setup_s = t0 - process_start
    items, done, scores, answers = 0, 0, [], {"columns": [], "images": []}
    image_ids = []
    round_cols, round_embs = {}, {}
    while time.perf_counter() - t0 < seconds:
        cls, imgs, columns, embs = chunk(done)
        answers["columns"].append(columns[:, sample_classes[done]])
        answers["images"].append(embs[sample_rows[done]])
        image_ids.append(imgs[sample_rows[done]])
        round_cols.update(zip(cls.tolist(), columns.T))
        round_embs.update(zip(imgs.tolist(), embs))
        done += 1
        items += len(cls) * len(templates) + len(imgs)
        if done % chunks_per_round == 0:  # a whole round: score it
            clf = np.stack([round_cols[c] for c in range(n_cls)], axis=1)
            emb = np.stack([round_embs[j] for j in range(n_img)])
            labels = np.arange(n_img) % n_cls
            scores.append(accuracy_topk(100.0 * emb @ clf, labels))
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    fill = captured.rows["real"] / max(captured.rows["padded"], 1)
    captured.on = False

    profile = None
    if trace:
        cuda = device.type == "cuda"
        t1 = time.perf_counter()
        with harness.profiler(cuda, host=False) as prof:
            chunk(done)
            window_t = time.perf_counter() - t1
        profile = harness.summarize_trace(harness.chrome_trace(prof), window_t, 1)
        with harness.profiler(cuda, host=True) as named:
            chunk(done + 1)
        profile["idle_gaps"] = harness.idle_gaps(harness.chrome_trace(named))

    # what the check needs, the encoder freed
    temperature = encoder.sd_temperature
    text = captured.text
    image = [[jpegs[j] for j in ids] for ids in image_ids]
    del encoder, captured, jpegs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    outcome = {"attempted": items, "failed": 0, "checks": {},
               "end_to_end": {"setup_s": setup_s, "eval_items_per_s": items / window_s},
               "window": {"seconds": window_s, "chunks": done, "items": items,
                          "text_fill": fill, "scores": scores},
               "memory_peak_bytes": peak, "config": config, "traffic": traffic,
               "trace": profile, "counters": {}}
    return outcome, (text, image, answers, temperature)


def reference_embeddings(config: dict, seed: int, text, image, temperature, device,
                         precision: str = "fp32"):
    """The reference's classifier columns (the mean of the normalised prompt
    embeddings, normalised) for the captured token ids, and its image
    embeddings for the sampled JPEGs (a list of bytes per chunk)."""
    ref.exact_fp32()
    params = ref.init_params(config, seed, device)
    net = ref.Net(config, precision)
    resolution = ref.sizes(config)["image"]["resolution"]
    with torch.no_grad():
        cols = []
        for tokens, pad_mask in text:
            emb = net.text_embedding(params, tokens, pad_mask, temperature).mean(dim=0)
            cols.append((emb / (emb.norm() + 1e-10)).cpu().numpy())
        embs = [net.image_embedding(params, preprocess.eval_batch(jpegs, resolution, device),
                                    temperature, eps=1e-10).cpu().numpy()
                for jpegs in image]
    return cols, embs


def gaps_of(cols, embs, answers) -> Dict[str, float]:
    """``classifier_gap``: the largest distance between a sampled class's
    column and the reference's (both unit vectors); ``image_embedding_gap``:
    the same for the sampled images' embeddings."""
    classifier = max((float(np.linalg.norm(got - want))
                      for got, want in zip(answers["columns"], cols)), default=np.inf)
    image_gap = max((float(np.linalg.norm(got - want, axis=-1).max())
                     for got, want in zip(answers["images"], embs)), default=np.inf)
    return {"classifier_gap": classifier, "image_embedding_gap": image_gap}


def eval_gaps(config, seed, text, image, answers, temperature, device, precision="fp32"):
    if len(text) != len(answers["columns"]) or len(image) != len(answers["images"]):
        raise RuntimeError("the captured samples do not match the window's chunks")
    cols, embs = reference_embeddings(config, seed, text, image, temperature, device, precision)
    return gaps_of(cols, embs, answers)
