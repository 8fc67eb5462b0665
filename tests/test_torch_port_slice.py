"""The CLIP-FDT serving slice of the PyTorch port vs the JAX package.

``model_entry`` builds the same small CLIP-FDT on both sides (2 layers per
tower; vision width 64, 2 heads, 64 px, patch 16 -> S=17; text width 64,
2 heads, ctx 12, vocab 128; codebook 96 x 32), with the kernels on
(``use_fused_kernel`` and ``fused_attn``, the serving config) and off (the
flagship form). The JAX params go into the port through the weight bridge;
both sides run fp32 on the CPU, the JAX Pallas kernels in interpret mode.

Tolerance: atol 1e-4 for the slice outputs (embeddings and codebook
attention weights): fp32 on both sides, but the differences of summation
order compound through two transformer layers, the query head and the
sparsemax threshold. atol 1e-5 for single towers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu.tools.torch_checkpoint import convert_reference_state_dict
from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import (
    load_jax_params, state_dict_from_jax_params,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SLICE_ATOL = 1e-4
TOWER_ATOL = 1e-5
VOCAB, CTX, RES = 128, 12, 64


def small_cfg(fused: bool, temperature: float = 0.5) -> dict:
    return {
        "type": "clip_fdt_vitb32",
        "kwargs": {
            "image_encode": {"input_resolution": RES, "patch_size": 16, "width": 64,
                             "layers": 2, "heads": 2, "embed_dim": 32, "fused_attn": fused},
            "text_encode": {"context_length": CTX, "vocab_size": VOCAB, "width": 64,
                            "heads": 2, "layers": 2, "embed_dim": 32, "fused_attn": fused},
            "fdt": {"sd_num": 96, "sd_dim": 32, "raw_img_ft_dim": 64, "raw_txt_ft_dim": 64,
                    "att_func_type": "sparsemax", "pool_type": "max",
                    "sparsemax_method": "bisect", "sd_temperature": temperature,
                    "use_fused_kernel": fused, "use_allgather": True},
            "dtype": "float32",
            "unroll": True,
        },
    }


def make_batch(seed: int, n: int):
    """Images [n, 64, 64, 3]; token rows SOT .. EOT then zero pads, with
    the pad mask (0 real / -inf pad); EOT is the highest id in each row."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, RES, RES, 3)).astype(np.float32)
    lens = rng.integers(3, CTX + 1, n)
    tokens = np.zeros((n, CTX), np.int32)
    pad = np.full((n, CTX), -np.inf, np.float32)
    for i, ln in enumerate(lens):
        tokens[i, 0] = VOCAB - 2
        tokens[i, 1:ln - 1] = rng.integers(1, VOCAB - 2, ln - 2)
        tokens[i, ln - 1] = VOCAB - 1
        pad[i, :ln] = 0.0
    return images, tokens, pad


@pytest.fixture(scope="module")
def jax_params():
    """One param tree for both forms (the kernel flags do not change it),
    with noise on every leaf so zero biases and unit LN scales are live."""
    model = jax_model_entry(small_cfg(fused=False))
    images, tokens, pad = make_batch(0, 2)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(tokens),
                        jnp.asarray(pad))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                        .astype(np.float32), params)


def _port(jax_params, fused, temperature=0.5):
    return load_jax_params(model_entry(small_cfg(fused, temperature), device="cpu"),
                           jax_params).eval()


def _np(x):
    return x.detach().float().numpy()


def test_weight_bridge_round_trip(jax_params):
    """JAX params -> port state_dict -> the JAX package's torch-checkpoint
    converter gives the original params back bit for bit."""
    back = convert_reference_state_dict(state_dict_from_jax_params(jax_params))
    flat_a = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_port_state_dict_has_reference_names(jax_params):
    port = model_entry(small_cfg(True), device="cpu")
    assert set(port.state_dict()) == set(state_dict_from_jax_params(jax_params))
    assert not port.visual.conv1.weight.requires_grad
    assert "visual.transformer.resblocks.1.attn.in_proj_weight" in port.state_dict()
    assert "img_query_model.q_map.4.bias" in port.state_dict()


def test_model_entry_names_unported_types():
    with pytest.raises(KeyError, match="not ported"):
        model_entry({"type": "clip_vitL14", "kwargs": {}})
    with pytest.raises(KeyError, match="unknown"):
        model_entry({"type": "no_such_model", "kwargs": {}})


def test_model_entry_defaults_to_cuda(monkeypatch):
    """No device named means the CUDA card: with CUDA hidden, ``model_entry``
    and the public constructors raise rather than build on the CPU, and
    ``device="cpu"`` still builds there."""
    from iterated_learning_for_vlm_tpu_torch import models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_cfg(True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_entry(cfg)
    for ctor in (models.clip_vitb32, models.clip_vitb16, models.clip_fdt_vitb32):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctor(**cfg["kwargs"])
    port = model_entry(cfg, device="cpu")
    assert {p.device.type for p in port.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert models.resolve_device() == torch.device("cuda")
    assert models.resolve_device("cpu") == torch.device("cpu")


def test_model_entry_seeded_init_is_reproducible():
    cfg = small_cfg(True)
    a = model_entry(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    b = model_entry(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    c = model_entry(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["space_dict"], c["space_dict"])


@pytest.mark.parametrize("fused", [True, False])
def test_towers_match_jax(jax_params, fused):
    model = jax_model_entry(small_cfg(fused))
    port = _port(jax_params, fused)
    images, tokens, pad = make_batch(2, 3)
    p = {"params": jax_params}
    want_v = model.apply(p, jnp.asarray(images), method=lambda m, x: m.visual(x))
    want_t = model.apply(p, jnp.asarray(tokens), jnp.asarray(pad),
                         method=lambda m, t, k: m.text(t, k))
    with torch.no_grad():
        got_v = port.visual(torch.from_numpy(images))
        got_t = port.encode_text(torch.from_numpy(tokens).long(), torch.from_numpy(pad))
    for key in ("embed", "patches", "pooled_raw", "patches_proj"):
        np.testing.assert_allclose(_np(got_v[key]), np.asarray(want_v[key]),
                                   atol=TOWER_ATOL, err_msg=key)
    for key in ("embed", "words", "words_proj", "pooled_raw"):
        np.testing.assert_allclose(_np(got_t[key]), np.asarray(want_t[key]),
                                   atol=TOWER_ATOL, err_msg=key)


@pytest.mark.parametrize("fused", [True, False])
def test_extract_features_match_jax(jax_params, fused):
    model = jax_model_entry(small_cfg(fused))
    port = _port(jax_params, fused)
    images, tokens, pad = make_batch(3, 3)
    p = {"params": jax_params}
    want_img = model.apply(p, jnp.asarray(images), method="extract_img_sd_ft", temperature=0.3)
    want_txt = model.apply(p, jnp.asarray(tokens), jnp.asarray(pad),
                           method="extract_txt_sd_ft", temperature=0.3)
    with torch.no_grad():
        got_img = port.extract_img_sd_ft(torch.from_numpy(images), temperature=0.3)
        got_txt = port.extract_txt_sd_ft(torch.from_numpy(tokens).long(),
                                         torch.from_numpy(pad), temperature=0.3)
    for got, want in zip(got_img + got_txt, want_img + want_txt):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=SLICE_ATOL)


def test_token_attention_matches_jax(jax_params):
    """``return_token_att`` takes the plain branch even with the kernel on and
    returns the masked, scaled [B, T, sd_num] token scores."""
    model = jax_model_entry(small_cfg(True))
    port = _port(jax_params, True)
    _, tokens, pad = make_batch(5, 3)
    want = model.apply({"params": jax_params}, jnp.asarray(tokens), jnp.asarray(pad),
                       method="extract_txt_sd_ft", return_token_att=True)
    with torch.no_grad():
        got = port.extract_txt_sd_ft(torch.from_numpy(tokens).long(), torch.from_numpy(pad),
                                     return_token_att=True)
    assert got[0].shape == (3, CTX, 96)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=SLICE_ATOL)


@pytest.mark.parametrize("fused", [True, False])
def test_forward_matches_jax(jax_params, fused):
    model = jax_model_entry(small_cfg(fused))
    port = _port(jax_params, fused)
    images, tokens, pad = make_batch(4, 4)
    want = model.apply({"params": jax_params}, jnp.asarray(images), jnp.asarray(tokens),
                       jnp.asarray(pad))
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(tokens).long(),
                   torch.from_numpy(pad))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=SLICE_ATOL,
                                   err_msg=key)
    norms = np.linalg.norm(_np(got["image_embed"]), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
