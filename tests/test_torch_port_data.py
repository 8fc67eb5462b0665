"""The port's data pipeline and host utilities vs the JAX package's, on the CPU.

Shards are written once per module by the port's ``tools/make_train_shards``
(class captions, and every seventh sample's caption three times over, so the
context buckets take both sizes): 4 x 16 samples at 64 px and 3 x 12 at 32 px. Both
packages read the same shards, with the same config, seed, epoch and rank.

Tolerances: none, except the device normalize. Shards, samplers, plans,
augment outputs (both tiers, both wires), AutoAugment images, batches and
the utilities must equal JAX's exactly (``np.array_equal``, same dtype): the
port runs the same numpy, PIL and C code in the same order. The uint8 wire's
device normalize ``x * scale + offset`` is held within one fp32 ulp of its
larger term, max(|x * scale|, |offset|), of JAX's jitted one: XLA may fuse
the multiply and the add into one FMA, where the port rounds the product
first (half an ulp of the product), as the host float path does.
"""
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from iterated_learning_for_vlm_tpu.data import augment as jaug
from iterated_learning_for_vlm_tpu.data import auto_augment as jauto
from iterated_learning_for_vlm_tpu.data import pipeline as jpipe
from iterated_learning_for_vlm_tpu.data import samplers as jsamplers
from iterated_learning_for_vlm_tpu.data import shards as jshards
from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu.utils import config as jconfig
from iterated_learning_for_vlm_tpu.utils import misc as jmisc
from iterated_learning_for_vlm_tpu_torch import cli_entry
from iterated_learning_for_vlm_tpu_torch.data import augment as aug
from iterated_learning_for_vlm_tpu_torch.data import auto_augment
from iterated_learning_for_vlm_tpu_torch.data import native
from iterated_learning_for_vlm_tpu_torch.data import pipeline as pipe
from iterated_learning_for_vlm_tpu_torch.data import samplers
from iterated_learning_for_vlm_tpu_torch.data import shards
from iterated_learning_for_vlm_tpu_torch.eval import encode
from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.tools.make_train_shards import write_shards
from iterated_learning_for_vlm_tpu_torch.utils import debug, misc, profiling
from iterated_learning_for_vlm_tpu_torch.utils import config as pconfig

REPO = Path(__file__).resolve().parents[1]


def lengthened(k, caption):
    """Every seventh caption three times over: 23 tokens, past a 16-token bucket."""
    return " ".join([caption] * 3) if k % 7 == 3 else caption


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    write_shards(str(root / "px64"), 4, 16, image_size=64, num_classes=16, caption_fn=lengthened)
    write_shards(str(root / "px32"), 3, 12, image_size=32, num_classes=8, caption_fn=lengthened)
    return {"px64": str(root / "px64" / "{00000..00003}.tar"),
            "px32": str(root / "px32" / "{00000..00002}.tar")}


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (i, k)


# -- (a) shards -------------------------------------------------------------------
@pytest.mark.parametrize("pattern", ["data/cc3m/{00000..00331}.tar", "x/{7..12}.tar",
                                     "plain.tar", "s3/{0001..0001}-a.tar"])
def test_shard_lists_match_jax(pattern):
    """Brace expansion, the (seed, epoch) shuffle, the round-robin split and
    the shard sample are JAX's."""
    got, want = shards.expand_shard_pattern(pattern), jshards.expand_shard_pattern(pattern)
    assert got == want
    for seed, epoch in ((0, 0), (0, 1), (5, 3)):
        assert shards.detshuffle(got, seed, epoch) == jshards.detshuffle(want, seed, epoch)
    for index, count in ((0, 1), (1, 2), (2, 3)):
        assert shards.split_shards(got, index, count) == jshards.split_shards(want, index, count)
    for factor, seed in ((1, 0), (3, 0), (10, 7)):
        assert (shards.sample_shard_paths(got, factor, seed)
                == jshards.sample_shard_paths(want, factor, seed))


def test_tar_shards_read_across_packages(shard_dirs, tmp_path):
    """A shard written by either package's ``write_tar_shard`` reads back the
    same through both ``iter_tar_samples``, and the two writers give the same
    bytes."""
    path = shards.expand_shard_pattern(shard_dirs["px32"])[0]
    got, want = list(shards.iter_tar_samples(path)), list(jshards.iter_tar_samples(path))
    assert len(got) == 12 and got == want
    assert set(got[0]) == {"__key__", "jpg", "txt"}
    jshards.write_tar_shard(str(tmp_path / "j.tar"), iter(got))
    shards.write_tar_shard(str(tmp_path / "p.tar"), iter(got))
    assert (tmp_path / "j.tar").read_bytes() == (tmp_path / "p.tar").read_bytes()
    assert list(shards.iter_tar_samples(str(tmp_path / "j.tar"))) == got
    assert list(jshards.iter_tar_samples(str(tmp_path / "p.tar"))) == got
    (tmp_path / "bad.tar").write_bytes(b"not a tar")
    assert list(shards.iter_tar_samples(str(tmp_path / "bad.tar"))) == []


def test_make_train_shards_matches_jax_tool(tmp_path):
    """The port's shard writer gives the bytes of ``tools/make_train_shards.py``
    for the same arguments."""
    args = ["--shards", "2", "--per-shard", "5", "--image-size", "32", "--num-classes", "4",
            "--seed", "3"]
    res = subprocess.run([sys.executable, str(REPO / "tools" / "make_train_shards.py"),
                          str(tmp_path / "jax"), *args], capture_output=True, text=True,
                         timeout=300, check=False, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr
    from iterated_learning_for_vlm_tpu_torch.tools import make_train_shards

    make_train_shards.main([str(tmp_path / "port"), *args])
    for name in ("00000.tar", "00001.tar"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# -- (b) samplers -----------------------------------------------------------------------
@pytest.mark.parametrize("world,rank,seed", [(1, 0, 0), (2, 0, 1), (2, 1, 1), (3, 2, 7)])
def test_samplers_match_jax(world, rank, seed):
    """Both samplers' index streams (per epoch; from a resume iteration) and
    ``batched`` with and without ``drop_last`` are JAX's."""
    got = samplers.DistributedSampler(23, rank, world, seed=seed)
    want = jsamplers.DistributedSampler(23, rank, world, seed=seed)
    for epoch in (0, 1, 4):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want) and len(got) == len(want)
    for last_iter in (0, 3):
        kw = dict(dataset_size=17, total_iter=6, batch_size=5, rank=rank, world_size=world,
                  last_iter=last_iter, seed=seed)
        g, w = samplers.DistributedGivenIterationSampler(**kw), \
            jsamplers.DistributedGivenIterationSampler(**kw)
        assert list(g) == list(w) and len(g) == len(w)
    for drop in (True, False):
        assert (list(samplers.batched(iter(range(11)), 4, drop))
                == list(jsamplers.batched(iter(range(11)), 4, drop)))


# -- (c) augment --------------------------------------------------------------------------
def _image(seed, size):
    rng = np.random.default_rng(1000 + seed)
    h, w = (137, 211) if size == 32 else (300, 260)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("size", [224, 32])
@pytest.mark.parametrize("out_u8", [False, True])
@pytest.mark.parametrize("tier", ["native", "pil"])
def test_augment_matches_jax_bit_for_bit(tier, out_u8, size):
    """``mocov2_single`` and ``onecrop`` on the same image and generator seed
    give JAX's array bit for bit, for 20 seeds, on the PIL image and on the
    uint8 array input, with the generators left in the same state."""
    use_native = tier == "native"
    if use_native:
        assert native.available() and jaug._native_lib() is not None
    for seed in range(20):
        arr = _image(seed, size)
        src = Image.fromarray(arr) if seed % 2 else arr
        g, w = np.random.default_rng(seed), np.random.default_rng(seed)
        got = aug.mocov2_single(src, g, size=size, native=use_native, out_u8=out_u8)
        want = jaug.mocov2_single(src, w, size=size, native=use_native, out_u8=out_u8)
        assert got.dtype == want.dtype == (np.uint8 if out_u8 else np.float32)
        assert got.shape == (size, size, 3) and np.array_equal(got, want), seed
        assert g.bit_generator.state == w.bit_generator.state
        resize = round(size * 256 / 224)
        got = aug.onecrop(src, None, resize, size, native=use_native, out_u8=out_u8)
        want = jaug.onecrop(src, None, resize, size, native=use_native, out_u8=out_u8)
        assert got.dtype == want.dtype and np.array_equal(got, want), seed


def test_augment_plans_consume_the_rng_as_jax():
    """``rrc_box``, ``jitter_plan`` and ``mocov2_plan`` draw the same values in
    the same order (the contract that pins both tiers' streams)."""
    for seed in range(30):
        w, h = 40 + 17 * seed, 300 - 5 * seed
        pairs = [(np.random.default_rng(seed), np.random.default_rng(seed)) for _ in range(3)]
        assert aug.rrc_box(w, h, pairs[0][0]) == jaug.rrc_box(w, h, pairs[0][1])
        assert aug.jitter_plan(pairs[1][0]) == jaug.jitter_plan(pairs[1][1])
        assert vars(aug.mocov2_plan(w, h, pairs[2][0])) == vars(jaug.mocov2_plan(w, h,
                                                                                 pairs[2][1]))
        for g, j in pairs:
            assert g.bit_generator.state == j.bit_generator.state
    for name in ("_NORM_SCALE", "_NORM_OFFSET", "_U8_SCALE", "_U8_OFFSET"):
        assert np.array_equal(getattr(aug, name), getattr(jaug, name)), name


def test_native_source_is_the_jax_copy_and_builds_in_the_checkout():
    """``fused_augment.c`` is the JAX package's byte for byte; the library is
    built under ``build/torch_native/``, named by a hash of source, CPU and
    flags."""
    port_src = REPO / "iterated_learning_for_vlm_tpu_torch/data/native/fused_augment.c"
    jax_src = REPO / "iterated_learning_for_vlm_tpu/data/native/fused_augment.c"
    assert port_src.read_bytes() == jax_src.read_bytes()
    assert native.available()
    lib = native.library_path()
    assert lib.parent == REPO / "build" / "torch_native" and lib.is_file()
    assert "-ffp-contract=off" in native._CFLAGS


def test_native_kernels_match_jax():
    """The port's bound C entries on the same inputs as JAX's: the bicubic box
    resize and the fused chain with every jitter op, gray, blur and flip."""
    from iterated_learning_for_vlm_tpu.data import native as jnative

    arr = _image(5, 32)
    for box, w, h in (((3.0, 7.5, 120.0, 99.0), 32, 32), ((0.0, 0.0, 211.0, 137.0), 50, 40)):
        assert np.array_equal(native.resize_box(arr, box, w, h), jnative.resize_box(arr, box, w, h))
    args = (arr, (10.0, 5.0, 150.0, 120.0), 48, [3, 0, 2, 1], [0.05, 1.3, 0.6, 0.8], True, 1.2,
            True, aug._NORM_SCALE, aug._NORM_OFFSET)
    assert np.array_equal(native.fused_augment(*args), jnative.fused_augment(*args))


def test_env_gate_forces_pil(monkeypatch):
    """``ILVLM_NATIVE_AUGMENT=0`` turns the native tier off: the default then
    gives the PIL tier's array."""
    arr = _image(3, 32)
    native_out = aug.mocov2_single(arr, np.random.default_rng(0), size=32)
    monkeypatch.setenv("ILVLM_NATIVE_AUGMENT", "0")
    assert not native.available() and aug._native_lib() is None
    got = aug.mocov2_single(arr, np.random.default_rng(0), size=32)
    assert np.array_equal(got, aug.mocov2_single(arr, np.random.default_rng(0), size=32,
                                                 native=False))
    monkeypatch.delenv("ILVLM_NATIVE_AUGMENT")
    assert native.available()
    assert np.array_equal(native_out, aug.mocov2_single(arr, np.random.default_rng(0), size=32,
                                                        native=True))


def test_native_augment_runs_without_pillow():
    """The native tier on a uint8 array imports no PIL (the pipeline's path
    on a machine without Pillow), in a fresh interpreter."""
    code = ("import sys, numpy as np\n"
            "sys.modules['PIL'] = None\n"
            "from iterated_learning_for_vlm_tpu_torch.data import augment, pipeline\n"
            "x = np.zeros((40, 50, 3), np.uint8)\n"
            "out = augment.mocov2_single(x, np.random.default_rng(0), size=32, out_u8=True)\n"
            "assert out.shape == (32, 32, 3) and out.dtype == np.uint8\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=False)
    assert res.returncode == 0, res.stderr


# -- (d) auto augment -----------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["imagenet_auto_augment", "rand_augment",
                                    "clsa_strong_augment"])
def test_auto_augment_matches_jax(policy):
    for seed in range(8):
        img = Image.fromarray(_image(seed, 32))
        got = getattr(auto_augment, policy)(img, np.random.default_rng(seed))
        want = getattr(jauto, policy)(img, np.random.default_rng(seed))
        assert np.array_equal(np.asarray(got), np.asarray(want)), seed


# -- (e) the shard loader ---------------------------------------------------------------------
def _cfg(path, **kw):
    cfg = {"data_path": path, "batch_size": 4, "num_samples": 64, "workers": 1,
           "transforms": "MOCOV2_single", "image_size": 32, "context_length": 32}
    cfg.update(kw)
    return cfg


def _epochs(info, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        info.set_epoch(epoch)
        out.append(list(info.dataloader))
    return out


@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1)])
@pytest.mark.parametrize("seed", [0, 3])
def test_wds_batches_match_jax(shard_dirs, seed, world, rank, workers, wire):
    """For epochs 0 and 1, every batch's image, tokens and pad mask are JAX's
    (``np.array_equal``, same dtype), and so are ``num_batches`` and
    ``num_samples``."""
    cfg = _cfg(shard_dirs["px64"], workers=workers, wire_dtype=wire)
    got = pipe.get_wds_dataset(cfg, world, rank, seed=seed)
    want = jpipe.get_wds_dataset(cfg, world, rank, seed=seed)
    assert (got.num_batches, got.num_samples) == (want.num_batches, want.num_samples)
    g, w = _epochs(got), _epochs(want)
    for ge, we in zip(g, w):
        assert len(ge) == got.num_batches
        assert_batches_equal(ge, we)
    assert g[0][0]["image"].dtype == (np.uint8 if wire == "uint8" else np.float32)
    assert not np.array_equal(g[0][0]["image"], g[1][0]["image"])  # epochs differ


def test_wds_context_buckets_match_jax(shard_dirs):
    """With ``context_buckets: [16, 32]`` at ctx 32 the bucket falls on the
    same batches as JAX's, and both sizes occur."""
    cfg = _cfg(shard_dirs["px32"], num_samples=36, workers=3, context_buckets=[16, 32])
    got, want = pipe.get_wds_dataset(cfg, seed=1), jpipe.get_wds_dataset(cfg, seed=1)
    g, w = _epochs(got), _epochs(want)
    for ge, we in zip(g, w):
        assert_batches_equal(ge, we)
    assert {b["tokens"].shape[1] for e in g for b in e} == {16, 32}


def test_unshuffled_wds_matches_jax(shard_dirs):
    """The unshuffled loader (float32 wire by default) is JAX's, in shard order."""
    cfg = _cfg(shard_dirs["px32"], num_samples=36)
    got, want = pipe.get_unshuffled_wds_dataset(cfg), jpipe.get_unshuffled_wds_dataset(cfg)
    assert got.num_batches == want.num_batches == 9
    g, w = list(got.dataloader), list(want.dataloader)
    assert_batches_equal(g, w)
    assert g[0]["image"].dtype == np.float32


# -- (f) the device normalize ----------------------------------------------------------------
def test_normalize_matches_jax_within_one_ulp():
    """``normalize_device_batch`` on the CPU against JAX's jitted
    ``_device_normalize_fn`` over every uint8 value and channel: within one
    fp32 ulp of the multiply-add's larger term (JAX may fuse it into an FMA;
    the port rounds the product first, as the host float path does, to which
    it is exact). The float32 wire passes through untouched."""
    x = np.arange(256, dtype=np.uint8).repeat(3).reshape(2, 8, 16, 3)
    got = pipe.normalize_device_batch({"image": torch.from_numpy(x),
                                       "image_v2": torch.from_numpy(x[::-1].copy()),
                                       "tokens": torch.zeros(2, 3, dtype=torch.int32)})
    want = np.asarray(jpipe._device_normalize_fn()(jnp.asarray(x)))
    host = x.astype(np.float32) * aug._NORM_SCALE + aug._NORM_OFFSET
    img = got["image"].numpy()
    assert img.dtype == np.float32
    term = np.maximum(np.abs(x.astype(np.float32) * aug._NORM_SCALE), np.abs(aug._NORM_OFFSET))
    assert np.all(np.abs(img - want) <= np.spacing(term))
    assert np.array_equal(img, host)
    assert np.array_equal(got["image_v2"].numpy(), host[::-1])
    f32 = {"image": torch.from_numpy(host)}
    assert pipe.normalize_device_batch(f32) is f32


# -- (g) the prefetcher on the CPU ---------------------------------------------------------------
def _producer_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_prefetch_keeps_order_and_values():
    batches = [{"x": np.full((3,), i, np.float32), "image": np.full((1, 2, 2, 3), i, np.uint8)}
               for i in range(7)]
    out = list(pipe.prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert b["x"].device.type == "cpu" and torch.equal(b["x"], torch.full((3,), float(i)))
        want = pipe.normalize_device_batch({"image": torch.from_numpy(batches[i]["image"])})
        assert torch.equal(b["image"], want["image"]) and b["image"].dtype == torch.float32


def test_prefetch_reraises_producer_exception():
    def loader():
        yield {"x": np.zeros(2, np.float32)}
        raise KeyError("decode exploded")

    it = pipe.prefetch_to_device(loader(), "cpu", size=2)
    next(it)
    with pytest.raises(KeyError, match="decode exploded"):
        next(it)


def test_prefetch_abandoned_consumer_releases_producer():
    """Breaking out mid-stream lets the producer thread end within 2 s and
    closes the loader."""
    closed = threading.Event()

    def loader():
        try:
            for i in range(100):
                yield {"x": np.full((2,), i, np.float32)}
        finally:
            closed.set()

    before = set(_producer_threads())
    it = pipe.prefetch_to_device(loader(), "cpu", size=2)
    assert float(next(it)["x"][0]) == 0.0
    mine = [t for t in _producer_threads() if t not in before]
    assert len(mine) == 1
    it.close()
    assert closed.wait(timeout=2.0), "the abandoned prefetch did not close the loader"
    mine[0].join(timeout=2.0)
    assert not mine[0].is_alive()


@pytest.mark.parametrize("size", [1, 3])
def test_prefetch_size_bounds_the_run_ahead(size):
    """After the consumer takes k batches, the producer has drawn at most
    k + size + 1 (``size`` queued, one in hand), and does run that far ahead."""
    pulled = []

    def loader():
        for i in range(50):
            pulled.append(i)
            yield {"x": np.full((1,), i, np.float32)}

    it = pipe.prefetch_to_device(loader(), "cpu", size=size)
    taken = 0
    for k in (1, 4):
        while taken < k:
            next(it)
            taken += 1
        time.sleep(0.5)
        assert len(pulled) == k + size + 1, (k, len(pulled))
    it.close()


def test_prefetch_never_moves_cuda_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pipe.prefetch_to_device(iter([{"x": np.zeros(1)}]), "cuda"))


# -- (h) context buckets ------------------------------------------------------------------------
def test_bucket_choice_and_cut_match_jax():
    """``pick_context_bucket`` and ``bucket_context`` give JAX's answers on
    random pad masks and bucket lists (token keys cut, others untouched), and
    the serving encoder takes the one definition in ``data/pipeline.py``."""
    assert encode.pick_context_bucket is pipe.pick_context_bucket
    rng = np.random.default_rng(5)
    for _ in range(40):
        ctx = int(rng.integers(4, 40))
        lens = rng.integers(1, ctx + 1, int(rng.integers(1, 6)))
        pad = np.where(np.arange(ctx)[None] < lens[:, None], 0.0, -np.inf).astype(np.float32)
        buckets = [int(b) for b in rng.integers(1, 48, int(rng.integers(0, 4)))]
        assert pipe.pick_context_bucket(pad, buckets or [ctx]) == jpipe.pick_context_bucket(
            pad, buckets or [ctx])
        batch = {"tokens": rng.integers(0, 99, pad.shape).astype(np.int32), "pad_mask": pad,
                 "mlm_labels": np.ones(pad.shape, np.int32), "image": np.zeros((len(pad), 2))}
        got, want = pipe.bucket_context(batch, buckets), jpipe.bucket_context(batch, buckets)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]) and got[k].shape == want[k].shape, k


# -- (i) utils ------------------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["clip_fdt_tiny_cpu_cluster", "clip_tiny_cpu_cluster"])
def test_count_params_matches_jax(name):
    """The port model's parameter total is the JAX params tree's, from a
    module and from its state dict."""
    path = str(REPO / "configs" / f"{name}.yaml")
    jcfg = jconfig.load_config(path).model
    jmodel = jax_model_entry(jcfg)
    v, t = jcfg.kwargs.image_encode, jcfg.kwargs.text_encode
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, v.input_resolution, v.input_resolution, 3)),
                         jnp.zeros((1, t.context_length), jnp.int32),
                         jnp.zeros((1, t.context_length)))["params"]
    want = jmisc.count_params(params)
    model = model_entry(pconfig.load_config(path).model, device="cpu")
    got = misc.count_params(model)
    assert got["total"] == want["total"] and got["total_M"] == want["total_M"]
    assert misc.count_params({n: p.detach().numpy() for n, p in model.named_parameters()}) == got


def test_misc_functions_match_jax():
    """``accuracy``, ``mixup``, ``cutmix``, ``strip_prefix`` and the FLOP
    estimates give JAX's values for the same inputs and generators."""
    rng = np.random.default_rng(0)
    logits, labels = rng.standard_normal((32, 10)), rng.integers(0, 10, 32)
    assert misc.accuracy(logits, labels, (1, 3, 5)) == jmisc.accuracy(logits, labels, (1, 3, 5))
    images = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    for alpha in (0.0, 0.4):
        for fn in ("mixup", "cutmix"):
            got = getattr(misc, fn)(images, labels[:6], alpha, np.random.default_rng(3))
            want = getattr(jmisc, fn)(images, labels[:6], alpha, np.random.default_rng(3))
            for g, w in zip(got, want):
                assert np.array_equal(g, w), (fn, alpha)
    state = {"module.a": 1, "b": 2, "module.module.c": 3}
    assert misc.strip_prefix(state) == jmisc.strip_prefix(state)
    assert misc.clip_b32_flops_per_pair() == jmisc.clip_b32_flops_per_pair()
    assert (misc.count_transformer_flops(77, 512, 12, 4, True)
            == jmisc.count_transformer_flops(77, 512, 12, 4, True))


def test_profiling_on_the_cpu(tmp_path):
    """``StepTimer`` skips its warm-up ticks and fences on CPU tensors;
    ``fence`` refuses what it cannot wait on; ``trace`` writes a Chrome trace;
    ``device_memory_stats`` is empty without a card."""
    timer = profiling.StepTimer(warmup=1)
    for _ in range(4):
        timer.tick(torch.ones(2) * 2)
    summary = timer.summary()
    assert summary["steps"] == 2 and set(summary) == {"steps", "mean_s", "p50_s", "p90_s",
                                                      "steps_per_sec"}
    with pytest.raises(TypeError):
        profiling.fence(3.0)
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_debug_flag_installs_the_crash_handler(tmp_path, monkeypatch):
    """``cli_entry --debug`` installs ``utils/debug.install_crash_handler``'s
    hook before it builds the Solver."""
    import iterated_learning_for_vlm_tpu_torch.train.solver as solver_mod

    class Stop(Exception):
        pass

    def refuse(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(solver_mod, "Solver", refuse)
    monkeypatch.setattr(sys, "excepthook", sys.__excepthook__)
    cfg = tmp_path / "c.yaml"
    cfg.write_text((REPO / "configs" / "clip_tiny_cpu_cluster.yaml").read_text())
    with pytest.raises(Stop):
        cli_entry.train_main(["--config", str(cfg), "--output_path", str(tmp_path), "--debug"])
    assert sys.excepthook is debug._hook


# -- (j) what is not ported ---------------------------------------------------------------------
@pytest.mark.parametrize("case", ["neg_loader", "mlm", "two_views", "mocov2_two_views",
                                  "synced_buckets_across_hosts"])
def test_unported_options_raise(shard_dirs, case):
    cfg = _cfg(shard_dirs["px32"])
    world = 1
    if case == "neg_loader":
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            pipe.get_neg_wds_dataset(cfg)
        return
    if case == "mlm":
        cfg["mask_type"] = "MLM"
    elif case == "two_views":
        cfg["two_views"] = True
    elif case == "mocov2_two_views":
        cfg["transforms"] = "MOCOV2"
    else:
        cfg.update(context_buckets=[16, 32], context_buckets_sync=True)
        world = 2
    with pytest.raises(NotImplementedError, match="Queue 1 item"):
        pipe.get_wds_dataset(cfg, world, 0)
