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
