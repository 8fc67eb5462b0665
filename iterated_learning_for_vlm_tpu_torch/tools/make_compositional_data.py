"""Export the compositional colored-shapes task: train shards + eval probes.

The port's copy of ``tools/make_compositional_data.py``, with the same
command line and the same bytes for a seed, through the port's
``data/compositional.py`` and ``data/shards.py``.

Train: wds tar shards (CC3M layout, jpg+txt) of SEEN (color, shape) pairs
only (``data/compositional.py:is_held_out`` split).

Eval: SugarCREPE-format probes (``eval/sugar_crepe.py`` JSON contract) over
freshly drawn images:

- ``replace_att_unseen`` / ``replace_obj_unseen``: UNSEEN-pair images;
  positive caption names the true unseen composition, negative swaps
  color/shape to a SEEN composition — above-chance accuracy requires
  compositional binding, not pair memorization (the paper's claim).
- ``replace_att_seen`` / ``replace_obj_seen``: seen-pair control at matched
  difficulty.

Usage:
  python -m iterated_learning_for_vlm_tpu_torch.tools.make_compositional_data \
      /tmp/ilvlm_comp --shards 8 --per-shard 500 --eval-per-split 256
"""
from __future__ import annotations

import argparse
import io
import json
import os

import numpy as np
from PIL import Image

from ..data.compositional import (
    COLOR_NAMES, RELATIONS, SHAPES, caption_for, caption_two, distinct_pair2,
    draw, draw_two, negative_pair, opposite_relation, seen_pairs, to_uint8,
    unseen_pairs,
)
from ..data.shards import write_tar_shard


def _jpeg(img_u8: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--per-shard", type=int, default=500)
    p.add_argument("--image-size", type=int, default=160)
    p.add_argument("--eval-per-split", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fold", type=int, default=4)
    p.add_argument("--single-frac", type=float, default=0.6)
    p.add_argument("--and-frac", type=float, default=0.25)
    args = p.parse_args(argv)

    train_dir = os.path.join(args.out_dir, "train")
    eval_dir = os.path.join(args.out_dir, "eval")
    img_dir = os.path.join(eval_dir, "images")
    for d in (train_dir, eval_dir, img_dir):
        os.makedirs(d, exist_ok=True)

    seen = seen_pairs(args.fold)
    unseen = unseen_pairs(args.fold)
    print(f"compositions: {len(seen)} seen / {len(unseen)} unseen "
          f"({len(COLOR_NAMES)} colors x {len(SHAPES)} shapes)")

    # ---- train shards (seen pairs only) -----------------------------------
    # Mix: 60% single-object, 25% two-object "and" conjunctions, 15% spatial
    # relations — the caption constructions the add/swap/replace_rel probes
    # use must appear in training (over SEEN pairs only) for the probes to
    # measure binding rather than unseen syntax.
    rng = np.random.default_rng(args.seed)

    def train_sample():
        u = rng.uniform()
        if u < args.single_frac:
            c, sh = seen[int(rng.integers(0, len(seen)))]
            img = draw(c, sh, args.image_size, rng)
            return img, caption_for(COLOR_NAMES[c], SHAPES[sh])
        p1 = seen[int(rng.integers(0, len(seen)))]
        p2 = distinct_pair2(p1, seen, rng)
        rel = ("and" if u < args.single_frac + args.and_frac
               else RELATIONS[int(rng.integers(0, len(RELATIONS)))])
        img = draw_two(p1, p2, rel, args.image_size, rng)
        cap = caption_two(COLOR_NAMES[p1[0]], SHAPES[p1[1]],
                          COLOR_NAMES[p2[0]], SHAPES[p2[1]], rel)
        return img, cap

    k = 0
    for s in range(args.shards):
        samples = []
        for _ in range(args.per_shard):
            img, cap = train_sample()
            samples.append({
                "__key__": f"{k:08d}",
                "jpg": _jpeg(to_uint8(img)),
                "txt": cap.encode(),
            })
            k += 1
        path = os.path.join(train_dir, f"{s:05d}.tar")
        write_tar_shard(path, iter(samples))
        print(f"wrote {path}")

    # ---- eval probes (fresh noise stream) ---------------------------------
    # 9 splits mirroring the reference SugarCREPE contract types
    # (eval/sugar_crepe.py:13-63: add/replace/swap x obj/att/rel), each in
    # the {filename, caption, negative_caption} JSON shape the evaluator
    # consumes.  replace_{att,obj} keep the round-3 unseen/seen controls.
    ev_rng = np.random.default_rng((args.seed, 0xC0117))

    def cn(ci):
        return COLOR_NAMES[ci]

    def sn(si):
        return SHAPES[si]

    def gen_replace(pool, swap):
        def g(i):
            c, sh = pool[i % len(pool)]
            img = draw(c, sh, args.image_size, ev_rng)
            nc, nsh = negative_pair(c, sh, swap, ev_rng, args.fold)
            return (img, caption_for(cn(c), sn(sh)),
                    caption_for(cn(nc), sn(nsh)))
        return g

    def gen_add_obj(i):
        # unseen-pair single object; the negative ADDS an absent (seen) one
        c, sh = unseen[i % len(unseen)]
        img = draw(c, sh, args.image_size, ev_rng)
        ec, esh = distinct_pair2((c, sh), seen, ev_rng)
        return (img, caption_for(cn(c), sn(sh)),
                caption_two(cn(c), sn(sh), cn(ec), sn(esh)))

    def gen_add_att(i):
        # two objects; positive leaves object 2's color unstated (true),
        # negative ADDS a wrong color for it (false)
        p1 = seen[i % len(seen)]
        p2 = distinct_pair2(p1, seen, ev_rng)
        img = draw_two(p1, p2, "and", args.image_size, ev_rng)
        wrong = [ci for ci in range(len(COLOR_NAMES))
                 if ci not in (p2[0], p1[0])]
        c3 = wrong[int(ev_rng.integers(0, len(wrong)))]
        pos = f"a photo of a {cn(p1[0])} {sn(p1[1])} and a {sn(p2[1])}"
        neg = (f"a photo of a {cn(p1[0])} {sn(p1[1])} and a "
               f"{cn(c3)} {sn(p2[1])}")
        return img, pos, neg

    def _two_seen_swappable(i):
        """Two seen pairs whose cross-bound combinations are ALSO seen where
        possible — so a pair-memorizing model prefers the swapped negative."""
        p1 = seen[i % len(seen)]
        for _ in range(64):
            p2 = distinct_pair2(p1, seen, ev_rng)
            if (p2[0], p1[1]) in set(seen) and (p1[0], p2[1]) in set(seen):
                return p1, p2
        return p1, distinct_pair2(p1, seen, ev_rng)

    def gen_swap_att(i):
        p1, p2 = _two_seen_swappable(i)
        img = draw_two(p1, p2, "and", args.image_size, ev_rng)
        pos = caption_two(cn(p1[0]), sn(p1[1]), cn(p2[0]), sn(p2[1]))
        neg = caption_two(cn(p2[0]), sn(p1[1]), cn(p1[0]), sn(p2[1]))
        return img, pos, neg

    def gen_swap_obj(i):
        p1, p2 = _two_seen_swappable(i)
        img = draw_two(p1, p2, "and", args.image_size, ev_rng)
        pos = caption_two(cn(p1[0]), sn(p1[1]), cn(p2[0]), sn(p2[1]))
        neg = caption_two(cn(p1[0]), sn(p2[1]), cn(p2[0]), sn(p1[1]))
        return img, pos, neg

    def gen_replace_rel(i):
        p1 = seen[i % len(seen)]
        p2 = distinct_pair2(p1, seen, ev_rng)
        rel = RELATIONS[int(ev_rng.integers(0, len(RELATIONS)))]
        img = draw_two(p1, p2, rel, args.image_size, ev_rng)
        pos = caption_two(cn(p1[0]), sn(p1[1]), cn(p2[0]), sn(p2[1]), rel)
        neg = caption_two(cn(p1[0]), sn(p1[1]), cn(p2[0]), sn(p2[1]),
                          opposite_relation(rel))
        return img, pos, neg

    split_gens = [
        ("replace_att_unseen", gen_replace(unseen, "color")),
        ("replace_obj_unseen", gen_replace(unseen, "shape")),
        ("replace_att_seen", gen_replace(seen, "color")),
        ("replace_obj_seen", gen_replace(seen, "shape")),
        ("add_obj", gen_add_obj),
        ("add_att", gen_add_att),
        ("swap_att", gen_swap_att),
        ("swap_obj", gen_swap_obj),
        ("replace_rel", gen_replace_rel),
    ]
    for split, gen in split_gens:
        data = {}
        for i in range(args.eval_per_split):
            img, pos, neg = gen(i)
            fname = f"{split}_{i:05d}.jpg"
            Image.fromarray(to_uint8(img)).save(
                os.path.join(img_dir, fname), format="JPEG", quality=92)
            data[str(i)] = {
                "filename": fname, "caption": pos, "negative_caption": neg,
            }
        with open(os.path.join(eval_dir, f"{split}.json"), "w") as f:
            json.dump(data, f)
        print(f"wrote {split}.json ({len(data)} items)")
    meta = {"seed": args.seed, "fold": args.fold, "image_size": args.image_size,
            "shards": args.shards, "per_shard": args.per_shard,
            "num_samples": args.shards * args.per_shard,
            "seen": len(seen), "unseen": len(unseen),
            "single_frac": args.single_frac, "and_frac": args.and_frac,
            "splits": [s for s, _ in split_gens]}
    with open(os.path.join(args.out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
