"""The port's serving encoder (``TorchEncoder``) vs the JAX ``JitEncoder``.

Both encode the same images and captions with the same small CLIP-FDT
weights (the config of ``tests/test_torch_port_slice.py``), with the kernels
on, fixed batches of 4 (so the last batch is partial and padded) and a text
context bucket of 8 below the full 12: the first batch of captions fits the
bucket, the second needs the full context. Tolerance: atol 1e-4 on unit-norm
fp32 embeddings, for the reasons given in the slice tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.eval.encode import JitEncoder
from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder, pick_context_bucket
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
