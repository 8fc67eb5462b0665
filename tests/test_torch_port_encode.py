"""The port's serving encoder (``TorchEncoder``) vs the JAX ``JitEncoder``.

Both encode the same images and captions with the same small CLIP-FDT
weights (the config of ``tests/test_torch_port_slice.py``), with the kernels
on, fixed batches of 4 (so the last batch is partial and padded) and a text
context bucket of 8 below the full 12: the first batch of captions fits the
bucket, the second needs the full context. Tolerance: atol 1e-4 on unit-norm
fp32 embeddings, for the reasons given in the slice tests. PIL images go
through each package's ONECROP transform (the same native code, so the same
arrays) before the towers.

The bf16 serving cast (``weight_dtype``) is held bit for bit against the same
bf16 model without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.eval.encode import JitEncoder
from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from PIL import Image

from iterated_learning_for_vlm_tpu.eval.encode import _CAST_KEEP_FP32 as JAX_CAST_KEEP_FP32
from iterated_learning_for_vlm_tpu_torch.eval.encode import (
    _CAST_KEEP_FP32, TorchEncoder, pick_context_bucket,
)
from iterated_learning_for_vlm_tpu_torch.models.layers import LayerNorm
from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import load_jax_params
from test_torch_port_slice import CTX, VOCAB, make_batch, small_cfg
from torch_port_graph_stub import stub_graphs  # noqa: F401 (fixture)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4


class WordTokenizer:
    """A deterministic stand-in tokenizer over the small vocabulary: SOT,
    one id per word, EOT (the highest id), zero pads."""

    vocab_size = VOCAB

    def __call__(self, texts, context_length=CTX):
        tokens = np.zeros((len(texts), context_length), np.int32)
        pad = np.full((len(texts), context_length), -np.inf, np.float32)
        for i, text in enumerate(texts):
            ids = [sum(map(ord, w)) % (VOCAB - 3) + 1 for w in text.split()]
            ids = [VOCAB - 2] + ids[:context_length - 2] + [VOCAB - 1]
            tokens[i, :len(ids)] = ids
            pad[i, :len(ids)] = 0.0
        return tokens, pad


CAPTIONS = [
    "a dog on the grass", "two cats", "a red car parked", "sunset over water",
    "a very long caption that needs the full context", "the end",
]


@pytest.fixture(scope="module")
def encoders():
    model = jax_model_entry(small_cfg(fused=True))
    images, tokens, pad = make_batch(0, 2)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(images), jnp.asarray(tokens),
                        jnp.asarray(pad))["params"]
    kw = dict(batch_size=4, text_buckets=(8,), sd_temperature=0.7)
    jit = JitEncoder(model, params, is_fdt=True, tokenizer=WordTokenizer(),
                     transform="ONECROP", num_workers=1, **kw)
    port = TorchEncoder(load_jax_params(model_entry(small_cfg(fused=True), device="cpu"), params),
                        tokenizer=WordTokenizer(), **kw)
    return jit, port


def test_bucket_choice_matches_pipeline():
    from iterated_learning_for_vlm_tpu.data.pipeline import pick_context_bucket as ref

    rng = np.random.default_rng(5)
    for _ in range(20):
        ctx = int(rng.integers(4, 20))
        lens = rng.integers(1, ctx + 1, int(rng.integers(1, 6)))
        pad = np.where(np.arange(ctx)[None] < lens[:, None], 0.0, -np.inf)
        buckets = tuple(int(b) for b in rng.integers(1, 24, 3))
        assert pick_context_bucket(pad, buckets) == ref(pad, buckets)


def test_encode_images_matches_jit_encoder(encoders):
    jit, port = encoders
    images = make_batch(7, 6)[0]
    want = jit.encode_images(images)
    got = port.encode_images(images)
    assert got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_encode_texts_matches_jit_encoder(encoders):
    jit, port = encoders
    tokens, pad = WordTokenizer()(CAPTIONS)
    assert pick_context_bucket(pad[:4], port.text_buckets) == 8
    assert pick_context_bucket(pad[4:], port.text_buckets) is None
    want = jit.encode_texts(CAPTIONS)
    np.testing.assert_allclose(port.encode_texts(CAPTIONS), want, atol=ATOL)
    np.testing.assert_allclose(port.encode_texts_tokens(tokens, pad), want, atol=ATOL)


def test_runtime_temperature_and_raw_features(encoders):
    """``sd_temperature`` is read at every call; ``normalize=False`` returns
    the raw codebook features."""
    jit, port = encoders
    images = make_batch(8, 4)[0]
    try:
        jit.sd_temperature = port.sd_temperature = 3.0
        np.testing.assert_allclose(port.encode_images(images, normalize=False),
                                   jit.encode_images(images, normalize=False), atol=ATOL)
    finally:
        jit.sd_temperature = port.sd_temperature = 0.7


def _pil_images(seed, n):
    rng = np.random.default_rng(seed)
    sizes = [(80, 64), (64, 97), (130, 130), (71, 90), (64, 64), (100, 75)]
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for h, w in sizes[:n]]


def test_encode_pil_images_matches_jit_encoder(encoders):
    """PIL images of several sizes (ONECROP to 64 px on both sides, two
    threads on the port's): JAX's embeddings within ``ATOL``, and the same
    as the port's own preprocess-then-encode."""
    jit, port = encoders
    images = _pil_images(3, 6)
    want = jit.encode_images(images)
    got = port.encode_images(images)
    assert got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    pre = port.preprocess(images)
    assert pre.dtype == np.float32 and np.array_equal(pre, jit.preprocess(images))
    assert np.array_equal(port.encode_images(pre), got)


def _bf16_cfg():
    cfg = small_cfg(fused=True)
    cfg["kwargs"]["dtype"] = "bfloat16"
    return cfg


def test_serving_cast_is_bit_exact():
    """``weight_dtype=torch.bfloat16`` on a bf16 model gives the uncast
    encoder's image and text embeddings bit for bit; it casts a copy (the
    model keeps its fp32 weights), keeps every parameter named by JAX's
    ``_CAST_KEEP_FP32`` and every LayerNorm's in fp32, and casts the rest."""
    assert _CAST_KEEP_FP32 == JAX_CAST_KEEP_FP32
    model = model_entry(_bf16_cfg(), device="cpu", generator=torch.Generator().manual_seed(0))
    kw = dict(tokenizer=WordTokenizer(), batch_size=4, text_buckets=(8,), num_workers=2)
    plain, cast = TorchEncoder(model, **kw), TorchEncoder(model, weight_dtype=torch.bfloat16, **kw)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ln = {f"{m}.{n}" for m, mod in cast.model.named_modules() if isinstance(mod, LayerNorm)
          for n, _ in mod.named_parameters(recurse=False)}
    kept = set()
    for name, p in cast.model.named_parameters():
        if name in ln or any(k in name.lower() for k in _CAST_KEEP_FP32):
            assert p.dtype == torch.float32, name
            kept.add(name)
        else:
            assert p.dtype == torch.bfloat16, name
    assert "space_dict" in kept and "logit_scale" in kept and "img_query_model.q_map.0.weight" in kept
    images = _pil_images(4, 6)
    assert np.array_equal(cast.encode_images(images), plain.encode_images(images))
    assert np.array_equal(cast.encode_texts(CAPTIONS), plain.encode_texts(CAPTIONS))


def test_serving_cast_refuses_an_fp32_model():
    """The cast is exact only where the towers compute in bf16: an fp32 model
    raises, as JAX's ``JitEncoder`` does."""
    model = model_entry(small_cfg(fused=True), device="cpu")
    with pytest.raises(ValueError, match="weight_dtype"):
        TorchEncoder(model, tokenizer=WordTokenizer(), weight_dtype=torch.bfloat16)


# -- CUDA graphs of the text encode: the key's rules, through a stand-in -----
# (``stub_graphs``, torch_port_graph_stub.py)

def _graph_counts(enc):
    return enc.text_graphs.eager, enc.text_graphs.captures, enc.text_graphs.replays


def _small_encoder(seed=0):
    model = model_entry(small_cfg(fused=True), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return TorchEncoder(model, tokenizer=WordTokenizer(), batch_size=4, text_buckets=(8,),
                        sd_temperature=0.7, num_workers=1)


def test_cpu_encoder_never_captures():
    """On the CPU every text call runs eager: no graph, no key kept."""
    enc = _small_encoder()
    first = enc.encode_texts(CAPTIONS)
    for _ in range(2):
        assert np.array_equal(enc.encode_texts(CAPTIONS), first)
    assert _graph_counts(enc) == (6, 0, 0)
    assert not enc.text_graphs._graphs


def test_text_graph_captures_on_a_keys_second_call(stub_graphs):
    """A key's first call runs eager, its second captures, the rest replay;
    each bucket is its own key; every result equals the eager encoder's."""
    enc, plain = _small_encoder(), _small_encoder()
    want = plain.encode_texts(CAPTIONS)
    for n in range(1, 5):
        assert np.array_equal(enc.encode_texts(CAPTIONS[:4]), want[:4])
        assert _graph_counts(enc) == (1, int(n >= 2), max(n - 2, 0))
    assert stub_graphs == [(4, 8)]
    assert np.array_equal(enc.encode_texts(CAPTIONS), want)  # ctx 8 replays, ctx 12 is new
    assert _graph_counts(enc) == (2, 1, 3)
    assert stub_graphs == [(4, 8)]


@pytest.mark.parametrize("change,mode", [
    ("nothing", "replay"), ("param_in_place", "replay"), ("param_replaced", "eager"),
    ("model_cast_and_back", "eager"), ("temperature", "eager"), ("normalize", "eager"),
    ("rows", "eager"),
])
def test_text_graph_key(stub_graphs, change, mode):
    """After a key's capture, the next call replays unless what the graph
    read changed: a parameter replaced by a new tensor (another address) or
    the temperature starts a new key, as do another ``normalize`` or shape; a
    parameter updated in place keeps its address, and the replay reads it."""
    enc = _small_encoder()
    tokens, pad = WordTokenizer()(CAPTIONS[:4])
    tokens = torch.from_numpy(tokens.astype(np.int64))[:, :8]
    pad = torch.from_numpy(pad)[:, :8]
    for _ in range(2):
        enc.text_batch(tokens, pad)
    assert _graph_counts(enc) == (1, 1, 0)
    weight = enc.model.encode_text.text_projection.weight
    normalize = None
    with torch.no_grad():
        if change == "param_in_place":
            weight.mul_(2.0)
        elif change == "param_replaced":
            weight.data = weight.data * 2.0
        elif change == "model_cast_and_back":
            enc.model.to(torch.float64).to(torch.float32)
        elif change == "temperature":
            enc.sd_temperature = 0.9
        elif change == "normalize":
            normalize = False
        elif change == "rows":
            tokens, pad = tokens[:3], pad[:3]
    got = enc.text_batch(tokens, pad, normalize)
    assert enc.text_graphs.mode == mode
    assert _graph_counts(enc) == ((1, 1, 1) if mode == "replay" else (2, 1, 0))
    fresh = _small_encoder()
    fresh.model.load_state_dict(enc.model.state_dict())
    fresh.sd_temperature = enc.sd_temperature
    assert torch.equal(got, fresh.text_batch(tokens, pad, normalize))


def test_text_batch_span_names_the_graph_mode(stub_graphs):
    """Under a profiler each ``encode.text_batch`` span carries ``graph``:
    eager, capture, then replay."""
    from torch.profiler import ProfilerActivity, profile

    from iterated_learning_for_vlm_tpu_torch.utils import profiling

    enc = _small_encoder()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            enc.encode_texts(CAPTIONS[:4])
    modes = [s["attrs"]["graph"] for s in profiling.spans() if s["name"] == "encode.text_batch"]
    profiling.clear()
    assert modes == ["eager", "capture", "replay"]
