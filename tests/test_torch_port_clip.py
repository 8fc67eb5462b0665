"""The baseline CLIP of the PyTorch port vs the JAX package, on both kernel routes.

``model_entry`` builds the same small ``clip_vitb32`` on both sides (2 layers
per tower; vision width 64, 2 heads, 64 px, patch 16 -> S=17; text width 64,
2 heads, ctx 12, vocab 128), on the flash route (``use_flash`` with
``fused_attn`` also set: flash wins, as in JAX) and on the fused route
(``fused_attn`` alone, the shipped ``configs/clip_cc3m.yaml``). JAX params go
into the port through the weight bridge; both sides run fp32 on the CPU, the
JAX Pallas kernels in interpret mode and jitted. Also: a CLIP-FDT forward on
the flash route (the knob is tower-wide), and ``clip_vitb16``-shaped towers at
48 px, patch 4 (S=145, past the fused kernels' 128).

Tolerances: atol 1e-5 on embeddings and towers (fp32 on both sides, summation
order only); the train-step bounds of ``tests/test_torch_port_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.eval.encode import JitEncoder
from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu.tools.torch_checkpoint import convert_reference_state_dict
from iterated_learning_for_vlm_tpu.train import optim as joptim
from iterated_learning_for_vlm_tpu.train import schedule as jsched
from iterated_learning_for_vlm_tpu.train.loss import clip_info_nce as j_info_nce
from iterated_learning_for_vlm_tpu.train.step import make_eval_step as j_make_eval_step
from iterated_learning_for_vlm_tpu.train.step import make_train_step as j_make_train_step
from iterated_learning_for_vlm_tpu.train.train_state import TrainState as JTrainState
from iterated_learning_for_vlm_tpu_torch.eval.encode import TorchEncoder
from iterated_learning_for_vlm_tpu_torch.models import CLIP, layers, model_entry
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import (
    load_jax_params, state_dict_from_jax_params,
)
from iterated_learning_for_vlm_tpu_torch.train import optim, schedule
from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce
from iterated_learning_for_vlm_tpu_torch.train.step import make_eval_step, make_train_step
from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState
from test_torch_port_encode import CAPTIONS, WordTokenizer
from test_torch_port_grads import noisy_params
from test_torch_port_slice import CTX, RES, VOCAB, make_batch, small_cfg

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-5
ROUTES = ["flash", "fused"]
PCONFIG = {"ln_w": {"weight_decay": 0}, "ln_b": {"weight_decay": 0},
           "bias": {"weight_decay": 0}, "logit_scale": {"weight_decay": 0}}


def clip_cfg(route: str, mtype: str = "clip_vitb32", **image) -> dict:
    kw = {
        "image_encode": {"input_resolution": RES, "patch_size": 16, "width": 64, "layers": 2,
                         "heads": 2, "embed_dim": 32, "fused_attn": True, **image},
        "text_encode": {"context_length": CTX, "vocab_size": VOCAB, "width": 64, "heads": 2,
                        "layers": 2, "embed_dim": 32, "fused_attn": True},
        "clip": {"use_allgather": True},
        "dtype": "float32",
        "unroll": True,
    }
    if route == "flash":
        kw["use_flash"] = True
    return {"type": mtype, "kwargs": kw}


def _jax_params(cfg, images):
    """Params of the JAX model, with noise on every leaf so zero biases and
    unit LayerNorm scales are live."""
    model = jax_model_entry(cfg)
    _, tokens, pad = make_batch(0, 2)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                 jnp.asarray(tokens), jnp.asarray(pad))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                        .astype(np.float32), params)


@pytest.fixture(scope="module")
def jax_params():
    """One tree for both routes: the kernel knobs do not change it."""
    return _jax_params(clip_cfg("fused"), make_batch(0, 2)[0])


def _port(jax_params, cfg):
    return load_jax_params(model_entry(cfg, device="cpu"), jax_params)


def _np(x):
    return x.detach().float().numpy()


def _torch_batch(batch):
    return {"image": torch.from_numpy(batch[0]), "tokens": torch.from_numpy(batch[1]).long(),
            "pad_mask": torch.from_numpy(batch[2])}


def test_clip_builds_with_reference_names(jax_params):
    """``clip_vitb32`` and ``clip_vitb16`` build; the state_dict names are the
    bridged JAX tree's, and the bridge round-trips through the JAX package's
    torch-checkpoint converter bit for bit."""
    port = model_entry(clip_cfg("flash"), device="cpu")
    assert isinstance(port, CLIP)
    assert set(port.state_dict()) == set(state_dict_from_jax_params(jax_params))
    assert not port.visual.conv1.weight.requires_grad
    b16 = model_entry({"type": "clip_vitb16", "kwargs": {"image_encode": {"layers": 1},
                                                        "text_encode": {"layers": 1}}},
                      device="cpu")
    assert b16.visual.positional_embedding.shape == (197, 768)
    back = convert_reference_state_dict(state_dict_from_jax_params(jax_params))
    flat_a = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_flash_route_takes_no_fused_kernel(jax_params, monkeypatch):
    """With ``use_flash`` and ``fused_attn`` both set, attention goes through
    flash attention only (the JAX precedence)."""
    calls = []
    monkeypatch.setattr(layers, "fused_tiny_attention", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(layers, "flash_attention",
                        lambda *a, causal=False: calls.append(0) or layers.attention_reference(
                            torch.cat([t.flatten(2) for t in a[:3]], -1), a[0].shape[2],
                            layers.causal_bias(a[0].shape[1]) if causal else None
                        ).unflatten(2, a[0].shape[2:]))
    images, tokens, pad = make_batch(1, 2)
    with torch.no_grad():
        _port(jax_params, clip_cfg("flash"))(torch.from_numpy(images),
                                             torch.from_numpy(tokens).long(),
                                             torch.from_numpy(pad))
    assert calls == [0] * 4  # 2 layers per tower


@pytest.mark.parametrize("route", ROUTES)
def test_clip_forward_matches_jax(jax_params, route):
    """``forward``, ``encode_image`` and ``encode_text(...)["embed"]``."""
    model = jax_model_entry(clip_cfg(route))
    port = _port(jax_params, clip_cfg(route)).eval()
    images, tokens, pad = make_batch(4, 4)
    jp = {"params": jax_params}
    ji, jt, jk = jnp.asarray(images), jnp.asarray(tokens), jnp.asarray(pad)
    want = jax.jit(model.apply)(jp, ji, jt, jk)
    want_img = jax.jit(lambda p, x: model.apply(p, x, method="encode_image"))(jp, ji)
    want_txt = jax.jit(lambda p, t, k: model.apply(p, t, k, method="encode_text"))(jp, jt, jk)
    ti, tt, tk = torch.from_numpy(images), torch.from_numpy(tokens).long(), torch.from_numpy(pad)
    with torch.no_grad():
        got = port(ti, tt, tk)
        got_img = port.encode_image(ti)
        got_txt = port.encode_text(tt, tk)["embed"]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=ATOL, err_msg=key)
    np.testing.assert_allclose(_np(got_img), np.asarray(want_img), atol=ATOL)
    np.testing.assert_allclose(_np(got_txt), np.asarray(want_txt), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(_np(got["image_embed"]), axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
def test_clip_encoder_matches_jit_encoder(jax_params, route):
    """``TorchEncoder`` (CLIP detected from the model) against
    ``JitEncoder(is_fdt=False)``: batches of 4 (the last one padded) and a
    text context bucket of 8 below the full 12."""
    kw = dict(batch_size=4, text_buckets=(8,))
    jit = JitEncoder(jax_model_entry(clip_cfg(route)), jax_params, is_fdt=False,
                     tokenizer=WordTokenizer(), transform="ONECROP", num_workers=1, **kw)
    port = TorchEncoder(_port(jax_params, clip_cfg(route)), tokenizer=WordTokenizer(), **kw)
    assert not port.is_fdt
    images = make_batch(7, 6)[0]
    got = port.encode_images(images)
    assert got.shape == (6, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, jit.encode_images(images), atol=ATOL)
    np.testing.assert_allclose(port.encode_texts(CAPTIONS), jit.encode_texts(CAPTIONS),
                               atol=ATOL)
    np.testing.assert_allclose(port.encode_images(images, normalize=False),
                               jit.encode_images(images, normalize=False), atol=ATOL)


@pytest.mark.parametrize("route", ROUTES)
def test_clip_eval_step_matches_jax(jax_params, route):
    batch = make_batch(10, 3)
    want = j_make_eval_step(jax_model_entry(clip_cfg(route)), is_fdt=False)(
        jax.tree.map(jnp.asarray, jax_params), {k: jnp.asarray(v) for k, v in
                                                zip(("image", "tokens", "pad_mask"), batch)})
    got = make_eval_step(_port(jax_params, clip_cfg(route)), is_fdt=False)(_torch_batch(batch))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL)


def _schedule(m):
    """Warmup to 1e-4 in 3 steps (tests/test_torch_port_train.py)."""
    return m.cosine(1e-5, 1e-4, 0.0, 3, 100, reset_steps=0)


@pytest.mark.parametrize("route", ROUTES)
def test_clip_train_steps_match_jax(jax_params, route):
    """1 and 3 steps of ``make_train_step(is_fdt=False)`` from the same params
    and batch, with no codebook and ``TrainState.create(..., None)``. Loss
    atol 1e-5 and equal accuracies at each step. After steps 1 and 3 every
    parameter element lies within 2 * (sum of the lrs) + 1e-7 of JAX's (AdamW
    moves an element with a gradient at noise level by ~lr * sign(noise)),
    and at least 99% of them within 5e-2 of that, so a step that does not
    move the parameters, or uses another lr, fails. mu as in the FDT test:
    atol 2e-5 + 1e-3 max|mu| per parameter; counts exact."""
    cfg = clip_cfg(route)
    batch = make_batch(8, 4)
    params_j = jax.tree.map(jnp.asarray, jax_params)
    state_j = JTrainState.create(params_j, joptim.adamw_init(params_j),
                                 joptim.trainable_mask_tree(params_j, frozenset()))
    step_j = j_make_train_step(jax_model_entry(cfg), _schedule(jsched),
                               joptim.build_wd_tree(params_j, 0.1, PCONFIG), is_fdt=False,
                               grad_clip_type="logit_scale_param_value", grad_clip_value=3.0,
                               grad_clip_max_value=6.0, donate=False)
    port = _port(jax_params, cfg)
    params = dict(port.named_parameters())
    state = TrainState.create(params, optim.adamw_init(params),
                              optim.trainable_mask_tree(params, frozenset()), None)
    step = make_train_step(port, _schedule(schedule), optim.build_wd_tree(params, 0.1, PCONFIG),
                           is_fdt=False, grad_clip_type="logit_scale_param_value",
                           grad_clip_value=3.0, grad_clip_max_value=6.0)
    jb = {k: jnp.asarray(v) for k, v in zip(("image", "tokens", "pad_mask"), batch)}
    lr_sum = 0.0
    for i in (1, 2, 3):
        state_j, mj = step_j(state_j, jb, jnp.float32(0.0))
        m = step(state, _torch_batch(batch), 0.0)
        assert abs(m["loss"].item() - float(mj["loss"])) <= 1e-5, i
        assert (m["acc1"].item(), m["acc5"].item()) == (float(mj["acc1"]), float(mj["acc5"]))
        np.testing.assert_allclose(m["lr"], float(mj["lr"]), rtol=1e-6)
        lr_sum += m["lr"]
        if i == 2:
            continue
        want_p = state_dict_from_jax_params(state_j.params)
        want_mu = state_dict_from_jax_params(state_j.opt_state["mu"])
        want_n = state_dict_from_jax_params(state_j.opt_state["count"], {"visual": 2, "text": 2})
        tight = total = 0
        for name, p in params.items():
            err = np.abs(_np(p) - want_p[name])
            assert np.all(err <= 2 * lr_sum + 1e-7), (i, name, err.max() / lr_sum)
            tight += int((err <= 5e-2 * lr_sum + 1e-7).sum())
            total += err.size
            mu = want_mu[name]
            np.testing.assert_allclose(_np(state.opt_state["mu"][name]), mu,
                                       atol=2e-5 + 1e-3 * np.abs(mu).max(), err_msg=name)
            assert state.opt_state["count"][name] == float(want_n[name]), name
        assert tight >= 0.99 * total, (i, tight / total)
    assert state.step == 3 and state.opt_state["count"]["visual.proj"] == 3.0


def _loss_grads_match(jax_params, cfg, batch):
    """InfoNCE loss and every parameter gradient of ``cfg`` against
    ``jax.grad`` (atol 2e-5 + 1e-3 max|grad| per parameter, as the CLIP-FDT
    gradient test; conv1 frozen on both sides)."""
    model = jax_model_entry(cfg)

    def loss_fn(p, images, tokens, pad):
        out = model.apply({"params": p}, images, tokens, pad)
        return j_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax_params, *(jnp.asarray(x) for x in batch))
    want = state_dict_from_jax_params(grads)
    port = _port(jax_params, cfg)
    out = port(torch.from_numpy(batch[0]), torch.from_numpy(batch[1]).long(),
               torch.from_numpy(batch[2]))
    loss, _ = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    for name, p in port.named_parameters():
        if name == "visual.conv1.weight":
            assert p.grad is None and np.all(want[name] == 0)
            continue
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-5 + 1e-3 * np.abs(w).max(),
                                   err_msg=name)
        assert np.abs(w).max() > 0, name
    return out


def test_clip_vitb16_flash_route_matches_jax():
    """``clip_vitb16`` with its factory's patch overridden to 4 at 48 px:
    145 vision tokens, which only the flash route takes. Forward embeddings
    and every gradient against JAX."""
    cfg = clip_cfg("flash", "clip_vitb16", input_resolution=48, patch_size=4)
    images = np.random.default_rng(5).standard_normal((3, 48, 48, 3)).astype(np.float32)
    params = _jax_params(cfg, images[:2])
    assert params["visual"]["positional_embedding"].shape == (145, 64)
    _, tokens, pad = make_batch(6, 3)
    want = jax.jit(jax_model_entry(cfg).apply)({"params": params}, jnp.asarray(images),
                                               jnp.asarray(tokens), jnp.asarray(pad))
    out = _loss_grads_match(params, cfg, (images, tokens, pad))
    for key in ("image_embed", "text_embed"):
        np.testing.assert_allclose(_np(out[key]), np.asarray(want[key]), atol=ATOL, err_msg=key)


def test_fdt_forward_on_the_flash_route_matches_jax():
    """``use_flash`` is tower-wide: CLIP-FDT takes the flash route too."""
    cfg = small_cfg(fused=True)
    cfg["kwargs"]["use_flash"] = True
    params = noisy_params()
    images, tokens, pad = make_batch(4, 4)
    want = jax.jit(jax_model_entry(cfg).apply)({"params": params}, jnp.asarray(images),
                                               jnp.asarray(tokens), jnp.asarray(pad))
    with torch.no_grad():
        got = _port(params, cfg)(torch.from_numpy(images), torch.from_numpy(tokens).long(),
                                 torch.from_numpy(pad))
    for key in want:  # the slice tolerance: sparsemax and the query heads follow the towers
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=1e-4, err_msg=key)
