"""The port's attention maps, token features, ``clip_fdt_vitb16``, the codebook
visualizer and the feature dump against the JAX package, on the CPU.

The same numpy inputs (``default_rng`` seeds) and the same weights (JAX params
carried into the port by ``tools/torch_checkpoint.py``) go through both
packages, fp32 on the CPU; the JAX Pallas kernels run in interpret mode,
jitted, and the port's kernel wrappers take their plain versions.

- ``return_attn`` on both towers (``attn_weights`` [L, B, S, S],
  ``cls_attn`` [L, B, S]), the Transformer's ``return_hidden_states`` /
  ``return_attn_weights``, and ``extract_patch_ft`` / ``extract_word_ft`` of
  CLIP and CLIP-FDT: atol ``ATOL`` = 1e-5 (fp32 on both sides, summation
  order only). A call that asks for the weights takes the plain path, as in
  JAX, launches no kernel route and counts no plain route.
- A narrow ``clip_fdt_vitb16`` (patch 16, 25 patches, the tower-wide
  ``fused_attn`` with ``image_encode: {use_flash: true}``): flash attention in
  the image tower, the fused kernels in the text tower, K1 in both heads. Its
  forward within 1e-4 (the slice tolerance: sparsemax and the query heads
  follow the towers), its gradients as ``test_torch_port_grads.py``'s.
- The visualizer: the tracker and renderers are copies, so the same inputs
  give the same PNG and JSON bytes. Through the two models, the sweeps keep
  the same top-k sets in the same order (weights within ``WEIGHT_ATOL``, each
  decision's margin asserted greater than twice it) with the token maps
  within ``TOKEN_ATOL`` = 1e-4; the images rendered from each side's own maps then differ
  by at most one 8-bit level (the maps are quantized to 8 bits after a
  min-max normalization, whose maximum sits on a rounding edge by design:
  ``att / (att.max() + 1e-8) * 255``).
"""
import json
import os
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu.models.layers import Transformer as JTransformer
from iterated_learning_for_vlm_tpu.models.text import TextConfig as JTextConfig
from iterated_learning_for_vlm_tpu.models.text import TextTransformer as JTextTransformer
from iterated_learning_for_vlm_tpu.tools import inference as jinference
from iterated_learning_for_vlm_tpu.tools import visualization as jviz
from iterated_learning_for_vlm_tpu.train.loss import clip_info_nce as j_info_nce
from iterated_learning_for_vlm_tpu_torch.models import clip_fdt_vitb16, clip_fdt_vitb32
from iterated_learning_for_vlm_tpu_torch.models import fdt as fdt_model
from iterated_learning_for_vlm_tpu_torch.models import layers, model_entry
from iterated_learning_for_vlm_tpu_torch.models.layers import Transformer
from iterated_learning_for_vlm_tpu_torch.models.text import TextConfig, TextTransformer
from iterated_learning_for_vlm_tpu_torch.tools import inference as pinference
from iterated_learning_for_vlm_tpu_torch.tools import run_codebook_viz as pviz_sweep
from iterated_learning_for_vlm_tpu_torch.tools import visualization as pviz
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import (
    _to_torch_layout, jax_path, load_jax_params, state_dict_from_jax_params,
)
from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce
from test_torch_port_clip import _jax_params, clip_cfg
from test_torch_port_grads import UNREAD, noisy_params
from test_torch_port_slice import make_batch, small_cfg

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-5
# sparsemax weights of the two models' pooled logits (fp32): on the small
# CLIP-FDT with noisy params (measured <= 1.8e-6), and on the tiny config's
# random init, whose weights sit closer together (measured <= 2e-8)
WEIGHT_ATOL = 5e-6
TINY_WEIGHT_ATOL = 1e-6
# token maps q.sd / sqrt(D) of magnitude up to ~10: the slice tolerance of the
# query heads' outputs, which follow the towers (measured <= 1.3e-5)
TOKEN_ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.detach().float().cpu().numpy()


def _close(got, want, atol=ATOL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=msg)


@pytest.fixture(scope="module")
def params():
    """One noisy param tree per model kind (the kernel knobs do not change it)."""
    return {"clip": _jax_params(clip_cfg("fused"), make_batch(0, 2)[0]), "fdt": noisy_params()}


def _cfg(kind, route):
    if kind == "clip":
        return clip_cfg(route)
    cfg = small_cfg(fused=True)
    if route == "flash":
        cfg["kwargs"]["use_flash"] = True
    return cfg


def _routes():
    return layers.attention_route.plain_routes, fdt_model.codebook_route.plain_routes


@pytest.fixture
def no_kernel_routes(monkeypatch):
    """Fail on any call of a kernel route's wrapper from the towers."""
    def refuse(*a, **k):
        raise AssertionError("a call that asked for the weights took a kernel route")

    monkeypatch.setattr(layers, "fused_tiny_attention", refuse)
    monkeypatch.setattr(layers, "flash_attention", refuse)


# -- attention maps ----------------------------------------------------------------
@pytest.mark.parametrize("kind,route", [("clip", "fused"), ("clip", "flash"), ("fdt", "fused"),
                                        ("fdt", "flash")])
def test_tower_attention_maps_match_jax(params, kind, route, no_kernel_routes):
    """``visual(images, return_attn=True)`` and the text tower's
    ``(tokens, pad_mask, return_attn=True)``: every output against JAX's;
    each row of ``attn_weights`` sums to 1; ``cls_attn`` is its CLS row."""
    cfg = _cfg(kind, route)
    jmodel = jax_model_entry(cfg)
    jp = {"params": params[kind]}
    images, tokens, pad = make_batch(3, 3)
    want_v = jax.jit(lambda p, x: jmodel.apply(
        p, x, method=lambda m, y: m.visual(y, return_attn=True)))(jp, jnp.asarray(images))
    want_t = jax.jit(lambda p, t, k: jmodel.apply(
        p, t, k, method=lambda m, a, b: m.text(a, b, return_attn=True)))(
        jp, jnp.asarray(tokens), jnp.asarray(pad))
    port = load_jax_params(model_entry(cfg, device="cpu"), params[kind]).eval()
    ti, tt, tp = torch.from_numpy(images), torch.from_numpy(tokens).long(), torch.from_numpy(pad)
    before = _routes()
    with torch.no_grad():
        got_v = port.visual(ti, return_attn=True)
        got_t = port.encode_text(tt, tp, return_attn=True)
    assert _routes() == before
    assert set(got_v) == set(want_v) and set(got_t) == set(want_t)
    for got, want in ((got_v, want_v), (got_t, want_t)):
        for key in want:
            if key != "pad_mask":
                _close(_np(got[key]), want[key], msg=key)
    assert got_v["attn_weights"].shape == (2, 3, 17, 17)
    assert got_t["attn_weights"].shape == (2, 3, 12, 12)
    for w in (got_v["attn_weights"], got_t["attn_weights"]):
        assert w.dtype == torch.float32
        _close(_np(w.sum(-1)), np.ones(w.shape[:-1], np.float32), msg="row sums")
    assert torch.equal(got_v["cls_attn"], got_v["attn_weights"][:, :, 0, :])
    # causal: no weight above the diagonal
    assert not torch.triu(got_t["attn_weights"], diagonal=1).any()


@pytest.mark.parametrize("kind,route", [("clip", "fused"), ("fdt", "flash")])
def test_return_attn_embed_matches_the_kernel_route(params, kind, route):
    """The embeddings of a ``return_attn`` call (the plain path) against the
    same call without it (the knob's route; its plain version here)."""
    port = load_jax_params(model_entry(_cfg(kind, route), device="cpu"), params[kind]).eval()
    images, tokens, pad = make_batch(4, 3)
    ti, tt, tp = torch.from_numpy(images), torch.from_numpy(tokens).long(), torch.from_numpy(pad)
    with torch.no_grad():
        for a, b in ((port.visual(ti), port.visual(ti, return_attn=True)),
                     (port.encode_text(tt, tp), port.encode_text(tt, tp, return_attn=True))):
            for key in ("embed", "pooled_raw"):
                _close(_np(b[key]), _np(a[key]), msg=key)


@pytest.mark.parametrize("causal", [False, True])
def test_transformer_hidden_states_and_weights_match_jax(causal):
    """``Transformer(x, return_hidden_states, return_attn_weights)`` in all
    four combinations against the JAX module, three layers."""
    jmod = JTransformer(width=32, layers=3, heads=2, causal=causal)
    x = np.random.default_rng(7).standard_normal((2, 9, 32)).astype(np.float32)
    p = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(8)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                     .astype(np.float32), p)
    prefix = "encode_text.transformer."
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in
          state_dict_from_jax_params({"text": {"transformer": p}}).items()}
    port = Transformer(32, 3, 2, causal=causal, device="cpu")
    port.load_state_dict(sd, strict=True)
    tx = torch.from_numpy(x)
    for hidden, attn in ((False, False), (True, False), (False, True), (True, True)):
        want = jax.jit(lambda q, y: jmod.apply({"params": q}, y, return_hidden_states=hidden,
                                               return_attn_weights=attn))(p, jnp.asarray(x))
        with torch.no_grad():
            got = port(tx, return_hidden_states=hidden, return_attn_weights=attn)
        if not (hidden or attn):
            _close(_np(got), want)
            continue
        assert len(got) == len(want) == (3 if attn else 2)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                _close(_np(g), w)
        if hidden:
            assert got[1].shape == (3, 2, 9, 32)
            _close(_np(got[1][-1]), _np(got[0]))
        if attn:
            assert got[-1].shape == (3, 2, 9, 9)


@pytest.mark.parametrize("kind", ["clip", "fdt"])
def test_extract_token_features_match_jax(params, kind):
    """``extract_patch_ft`` (CLIP: ln_post + proj per patch; CLIP-FDT: the
    image query head's ``q_map``) and ``extract_word_ft`` (the projected or
    query-mapped word tokens, and the pad mask passed through)."""
    cfg = _cfg(kind, "fused")
    jmodel = jax_model_entry(cfg)
    jp = {"params": params[kind]}
    images, tokens, pad = make_batch(5, 3)
    want_p = jax.jit(lambda q, x: jmodel.apply(q, x, method="extract_patch_ft"))(
        jp, jnp.asarray(images))
    want_w, want_m = jax.jit(lambda q, t, k: jmodel.apply(q, t, k, method="extract_word_ft"))(
        jp, jnp.asarray(tokens), jnp.asarray(pad))
    port = load_jax_params(model_entry(cfg, device="cpu"), params[kind]).eval()
    tp = torch.from_numpy(pad)
    with torch.no_grad():
        got_p = port.extract_patch_ft(torch.from_numpy(images))
        got_w, got_m = port.extract_word_ft(torch.from_numpy(tokens).long(), tp)
    width = 32
    assert got_p.shape == (3, 16, width) and got_w.shape == (3, 12, width)
    _close(_np(got_p), want_p, msg="patch")
    _close(_np(got_w), want_w, msg="word")
    assert got_m is tp
    np.testing.assert_array_equal(np.asarray(want_m), pad)


# -- clip_fdt_vitb16 ------------------------------------------------------------------
B16_RES = 80  # patch 16: a 5 x 5 grid, T = 25 image tokens, S = 26


def b16_cfg():
    """``clip_fdt_vitb16`` narrowed (two layers, width 64) with the smoke's
    routing: the tower-wide ``fused_attn`` and ``image_encode: {use_flash:
    true}``, K1 in both heads."""
    cfg = small_cfg(fused=True)
    cfg["type"] = "clip_fdt_vitb16"
    kw = cfg["kwargs"]
    for tower in ("image_encode", "text_encode"):
        del kw[tower]["fused_attn"]
    del kw["image_encode"]["patch_size"]  # the factory's 16
    kw["image_encode"].update(input_resolution=B16_RES, use_flash=True)
    kw["fused_attn"] = True
    return cfg


def b16_batch(seed, n):
    _, tokens, pad = make_batch(seed, n)
    images = np.random.default_rng(seed).standard_normal((n, B16_RES, B16_RES, 3))
    return images.astype(np.float32), tokens, pad


@pytest.fixture(scope="module")
def b16_params():
    model = jax_model_entry(b16_cfg())
    images, tokens, pad = (jnp.asarray(x) for x in b16_batch(0, 2))
    p = jax.jit(model.init)(jax.random.PRNGKey(0), images, tokens, pad)["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
                        .astype(np.float32), p)


@pytest.fixture
def route_calls(monkeypatch):
    """Calls of each kernel route's wrapper, passed through to it."""
    calls = {"flash": 0, "fused": 0, "codebook": 0}

    def wrap(mod, name, key):
        orig = getattr(mod, name)

        def call(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, call)

    wrap(layers, "flash_attention", "flash")
    wrap(layers, "fused_tiny_attention", "fused")
    wrap(fdt_model.codebook_attention, "fused_codebook_attention", "codebook")
    return calls


def test_clip_fdt_vitb16_forward_matches_jax(b16_params, route_calls):
    """The registry builds ``clip_fdt_vitb16`` with JAX's per-tower knobs
    (``_common``'s ``setdefault``: the image tower's ``use_flash`` wins over
    the tower-wide default); a forward routes vision attention to flash, text
    attention to the fused kernels and both heads to K1, counts no plain
    route, and matches JAX within 1e-4."""
    cfg = b16_cfg()
    jmodel = jax_model_entry(cfg)
    assert jmodel.vision_cfg.use_flash and jmodel.vision_cfg.fused_attn
    assert not jmodel.text_cfg.use_flash and jmodel.text_cfg.fused_attn
    port = load_jax_params(model_entry(cfg, device="cpu"), b16_params).eval()
    assert asdict(port.vision_cfg) == asdict(jmodel.vision_cfg)
    assert asdict(port.text_cfg) == asdict(jmodel.text_cfg)
    assert port.visual.positional_embedding.shape == ((B16_RES // 16) ** 2 + 1, 64)
    images, tokens, pad = b16_batch(4, 4)
    want = jax.jit(jmodel.apply)({"params": b16_params}, jnp.asarray(images),
                                 jnp.asarray(tokens), jnp.asarray(pad))
    before = _routes()
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(tokens).long(),
                   torch.from_numpy(pad))
    assert _routes() == before
    assert route_calls == {"flash": 2, "fused": 2, "codebook": 2}
    assert set(got) == set(want)
    for key in want:
        _close(_np(got[key]), want[key], atol=1e-4, msg=key)


def test_clip_fdt_vitb16_gradients_match_jax(b16_params):
    """Every parameter's gradient of the InfoNCE loss against ``jax.grad``,
    with ``test_model_gradients_match_jax``'s tolerance (atol 2e-5 + 1e-3 *
    max|grad| of the parameter); unread leaves None here, zero there; conv1
    frozen on both sides."""
    cfg = b16_cfg()
    jmodel = jax_model_entry(cfg)
    batch = b16_batch(6, 4)

    def loss_fn(p, images, tokens, pad):
        out = jmodel.apply({"params": p}, images, tokens, pad)
        return j_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        b16_params, *(jnp.asarray(x) for x in batch))
    want = state_dict_from_jax_params(grads)
    port = load_jax_params(model_entry(cfg, device="cpu"), b16_params)
    out = port(torch.from_numpy(batch[0]), torch.from_numpy(batch[1]).long(),
               torch.from_numpy(batch[2]))
    loss, _ = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name]
        if name.startswith(UNREAD) or name == "visual.conv1.weight":
            assert p.grad is None and np.all(w == 0), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, atol=2e-5 + 1e-3 * np.abs(w).max(),
                                   err_msg=name)
        assert np.abs(w).max() > 0, name


def test_full_size_vitb16_tree_crosses_the_bridge():
    """At full size (shapes only: ``jax.eval_shape`` and a port model on the
    meta device), the ``clip_fdt_vitb16`` tree differs from ``clip_fdt_vitb32``'s
    only in ``conv1`` and ``positional_embedding``, and each of its leaves maps
    to a port parameter of the same shape through the bridge's names and
    layouts."""
    def jax_shapes(mtype):
        model = jax_model_entry({"type": mtype, "kwargs": {}})
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32),
                              jnp.zeros((1, 77)))["params"]
        return {tuple(str(getattr(k, "key", k)) for k in path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    b16, b32 = jax_shapes("clip_fdt_vitb16"), jax_shapes("clip_fdt_vitb32")
    assert set(b16) == set(b32)
    assert {p for p in b16 if b16[p] != b32[p]} == {("visual", "conv1", "kernel"),
                                                    ("visual", "positional_embedding")}
    assert b16[("visual", "positional_embedding")] == (197, 768)
    for factory, tree in ((clip_fdt_vitb16, b16), (clip_fdt_vitb32, b32)):
        port = factory(device="meta")
        names = dict(port.named_parameters())
        seen = set()
        for name, p in names.items():
            path = jax_path(name)
            shape = tree[path][1:] if ".resblocks." in name else tree[path]
            layout = _to_torch_layout(path, np.empty(shape, np.float32)).shape
            assert layout == tuple(p.shape), (name, layout, p.shape)
            seen.add(path)
        assert seen == set(tree)


# -- the visualizer ---------------------------------------------------------------
def test_renderers_and_tracker_are_copies(tmp_path):
    """The same inputs through both packages' tracker, heatmap, grid, JSON
    and attention-map renderers: equal arrays, equal files byte for byte."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((6, 32, 32, 3)).astype(np.float32)
    token_att = rng.random((6, 16, 10)).astype(np.float32)
    weights = rng.random((6, 10)).astype(np.float32)
    weights[weights < 0.3] = 0.0
    trackers = {}
    for side, mod in (("jax", jviz), ("port", pviz)):
        t = mod.TopKCodeTracker(10, k=3)
        t.update(weights, [(images[b], token_att[b]) for b in range(6)])
        trackers[side] = t
        np.testing.assert_array_equal(
            mod.heatmap_overlay((images[0] * 60 + 128).clip(0, 255).astype(np.uint8),
                                token_att[0, :, 0].reshape(4, 4)),
            jviz.heatmap_overlay((images[0] * 60 + 128).clip(0, 255).astype(np.uint8),
                                 token_att[0, :, 0].reshape(4, 4)))
        for code in t.active_codes():
            mod.render_code_grid(t, code, str(tmp_path / side), cell=24, cols=2)
        tt = mod.TopKCodeTracker(10, k=2)
        tt.update(weights, [f"caption {b}" for b in range(6)])
        mod.dump_text_codes(tt, str(tmp_path / side / "codes.json"), min_items=1)
        attn = rng.random((7, 7)).astype(np.float32) if side == "jax" else attn
        mod.render_attention_map(attn, str(tmp_path / side / "attn.png"), cell=3)
    assert trackers["port"].active_codes() == trackers["jax"].active_codes()
    for code in trackers["jax"].active_codes():
        assert [w for w, _ in trackers["port"].top(code)] == [
            w for w, _ in trackers["jax"].top(code)]
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) > 3
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def assert_tracker_margins(weights, k, tol, keys=None):
    """Every decision ``TopKCodeTracker.update`` takes on ``weights`` [N, C]
    (rows streamed in order) is more than ``2 * tol`` from a tie: each row's
    k-th and (k+1)-th weights (where the k-th is positive), a kept weight
    against 0, and, for each code, the order of its candidates down to the
    first one it drops. So weights within ``tol`` of these keep the same
    sets in the same order. ``keys`` [N] name each row's payload: two rows of
    one payload (a caption drawn twice) may tie, since either order renders
    the same."""
    keys = list(range(len(weights))) if keys is None else list(keys)
    gaps = []
    srt = -np.sort(-weights, axis=-1)
    kept_kth = srt[:, k - 1]
    gaps += list((kept_kth - srt[:, k])[kept_kth > 0])
    top = np.argsort(-weights, axis=-1)[:, :k]
    cand = {}
    for b in range(len(weights)):
        for code in top[b]:
            w = float(weights[b, code])
            if w > 0:
                gaps.append(w)
                cand.setdefault(int(code), []).append((w, keys[b]))
    for ws in cand.values():
        ws = sorted(ws, key=lambda e: -e[0])[:k + 1]
        gaps += [a[0] - b[0] for a, b in zip(ws, ws[1:]) if a[1] != b[1]]
    margin = float(min(gaps))
    assert margin > 2 * tol, f"a near-tie: the smallest margin {margin} is within 2 x {tol}"


def assert_trackers_agree(port, jax_t, num_codes, payload_close, tol=WEIGHT_ATOL):
    assert port.active_codes() == jax_t.active_codes()
    for code in range(num_codes):
        got, want = port.top(code), jax_t.top(code)
        assert len(got) == len(want), code
        for (wg, pg), (ww, pw) in zip(got, want):
            assert abs(wg - ww) <= tol, (code, wg, ww)
            payload_close(pg, pw)


def assert_pngs_within_one_level(port_dir, jax_dir, names):
    for name in names:
        a = np.asarray(Image.open(os.path.join(port_dir, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(jax_dir, name)), np.int16)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1, name


def _image_payload_close(pg, pw):
    np.testing.assert_array_equal(pg[0], pw[0])
    _close(pg[1], pw[1], atol=TOKEN_ATOL, msg="token map")


def test_codebook_sweeps_match_jax(params, tmp_path):
    """``sweep_image_codes`` and ``sweep_text_codes`` over three batches of
    the small CLIP-FDT on both sides (``extract_img_sd_ft`` with and without
    ``return_token_att``, ``extract_txt_sd_ft``; the port's codebook call
    takes K1's plain version): the same top-k sets in the same order with
    the margins asserted, the token maps within ATOL, and each side's grids
    within one 8-bit level."""
    cfg = _cfg("fdt", "fused")
    jmodel = jax_model_entry(cfg)
    jp = {"params": params["fdt"]}
    port = load_jax_params(model_entry(cfg, device="cpu"), params["fdt"]).eval()
    j_maps = jax.jit(lambda q, x: jmodel.apply(q, x, method="extract_img_sd_ft",
                                               return_token_att=True))
    j_img = jax.jit(lambda q, x: jmodel.apply(q, x, method="extract_img_sd_ft"))
    j_txt = jax.jit(lambda q, t, k: jmodel.apply(q, t, k, method="extract_txt_sd_ft"))
    seen = {"jax": [], "port": [], "jax_txt": [], "port_txt": []}

    def jax_img(images):
        out = np.asarray(j_maps(jp, images)[0]), np.asarray(j_img(jp, images)[0])
        seen["jax"].append(out[1])
        return out

    @torch.no_grad()
    def port_img(images):
        x = torch.from_numpy(images)
        out = (_np(port.extract_img_sd_ft(x, return_token_att=True)[0]),
               _np(port.extract_img_sd_ft(x)[0]))
        seen["port"].append(out[1])
        return out

    def jax_txt(tokens, pad):
        out = np.asarray(j_txt(jp, tokens, pad)[0])
        seen["jax_txt"].append(out)
        return None, out

    @torch.no_grad()
    def port_txt(tokens, pad):
        out = _np(port.extract_txt_sd_ft(torch.from_numpy(tokens).long(),
                                         torch.from_numpy(pad))[0])
        seen["port_txt"].append(out)
        return None, out

    batches, texts = [], []
    for seed in range(3):
        images, tokens, pad = make_batch(20 + seed, 4)
        batches.append({"image": images, "tokens": tokens, "pad_mask": pad})
        texts.append([f"caption {seed}.{b}" for b in range(4)])
    k, codes = 4, 96
    trackers = {"jax": jviz.sweep_image_codes(jax_img, batches, codes, k),
                "port": pviz.sweep_image_codes(port_img, batches, codes, k)}
    ttrackers = {"jax": jviz.sweep_text_codes(jax_txt, batches, texts, codes, k),
                 "port": pviz.sweep_text_codes(port_txt, batches, texts, codes, k)}
    for side in ("", "_txt"):
        want, got = np.concatenate(seen["jax" + side]), np.concatenate(seen["port" + side])
        _close(got, want, atol=WEIGHT_ATOL, msg="att_weight" + side)
        assert_tracker_margins(want, k, WEIGHT_ATOL)
    assert_trackers_agree(trackers["port"], trackers["jax"], codes, _image_payload_close)
    assert_trackers_agree(ttrackers["port"], ttrackers["jax"], codes,
                          lambda a, b: (a == b) or pytest.fail(f"{a!r} != {b!r}"))
    active = trackers["jax"].active_codes()
    assert len(active) >= 4
    for side, mod in (("jax", jviz), ("port", pviz)):
        for code in active:
            mod.render_code_grid(trackers[side], code, str(tmp_path / side))
        mod.dump_text_codes(ttrackers[side], str(tmp_path / side / "codes.json"), min_items=1)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert_pngs_within_one_level(tmp_path / "port", tmp_path / "jax",
                                 [n for n in names if n.endswith(".png")])
    codes_j, codes_p = (json.loads((tmp_path / s / "codes.json").read_text())
                        for s in ("jax", "port"))
    assert list(codes_p) == list(codes_j)
    for code, items in codes_j.items():
        assert [i["text"] for i in codes_p[code]] == [i["text"] for i in items]
        _close([i["weight"] for i in codes_p[code]], [i["weight"] for i in items],
               atol=WEIGHT_ATOL)
    # a grid rendered from JAX's own tracker by the port's renderer: JAX's bytes
    pviz.render_code_grid(trackers["jax"], active[0], str(tmp_path / "cross"))
    name = f"code_{active[0]:05d}.png"
    assert (tmp_path / "cross" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_text_attention_maps_and_pngs_match_jax(tmp_path):
    """``text_attention_maps`` / ``dump_text_attention`` on JAX's visualizer
    test tower (two layers, width 32, ctx 12), its weights carried into a port
    ``TextTransformer``: maps within ATOL, one PNG per (caption, layer),
    trimmed to each caption, within one 8-bit level of JAX's, and JAX's maps
    rendered by the port's renderer give JAX's bytes."""
    jcfg = JTextConfig(context_length=12, vocab_size=200, width=32, heads=2, layers=2,
                       embed_dim=16)
    jmodel = JTextTransformer(jcfg)
    rng = np.random.RandomState(0)
    tokens = np.zeros((2, 12), np.int32)
    pad_mask = np.full((2, 12), -np.inf, np.float32)
    for i, n in enumerate((5, 8)):
        tokens[i, :n] = rng.randint(1, 199, n)
        tokens[i, n - 1] = 199
        pad_mask[i, :n] = 0.0
    variables = jmodel.init(jax.random.PRNGKey(0), tokens, pad_mask)
    prefix = "encode_text."
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in
          state_dict_from_jax_params({"text": variables["params"]}).items()}
    port = TextTransformer(TextConfig(context_length=12, vocab_size=200, width=32, heads=2,
                                      layers=2, embed_dim=16), device="cpu")
    port.load_state_dict(sd, strict=True)
    want = jviz.text_attention_maps(jmodel, variables, tokens, pad_mask)
    got = pviz.text_attention_maps(port, tokens, pad_mask)
    assert got.shape == want.shape == (2, 2, 12, 12) and got.dtype == np.float32
    _close(got, want)
    jpaths = jviz.dump_text_attention(jmodel, variables, tokens, pad_mask, str(tmp_path / "j"))
    ppaths = pviz.dump_text_attention(port, tokens, pad_mask, str(tmp_path / "p"))
    names = [os.path.basename(p) for p in jpaths]
    assert [os.path.basename(p) for p in ppaths] == names and len(names) == 4
    assert Image.open(ppaths[0]).size == (5 * 24, 5 * 24)
    assert_pngs_within_one_level(tmp_path / "p", tmp_path / "j", names)
    pviz.render_attention_map(want[1, 0, :5, :5], str(tmp_path / "x.png"))
    assert (tmp_path / "x.png").read_bytes() == (tmp_path / "j" / names[1]).read_bytes()


# -- the sweep script and the feature dump over a checkpoint ------------------------
@pytest.fixture(scope="module")
def viz_setup(tmp_path_factory):
    """32-px shards, the tiny CLIP-FDT config pointed at them (float32 wire,
    ONECROP, ctx 16) and a port checkpoint of random weights."""
    import yaml

    from iterated_learning_for_vlm_tpu_torch.tools.make_train_shards import write_shards
    from iterated_learning_for_vlm_tpu_torch.train.checkpoint import save_checkpoint
    from iterated_learning_for_vlm_tpu_torch.train.optim import adamw_init, trainable_mask_tree
    from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState
    from iterated_learning_for_vlm_tpu_torch.utils.config import load_config

    root = tmp_path_factory.mktemp("viz")
    write_shards(str(root / "shards"), 2, 16, image_size=32, num_classes=8)
    cfg = load_config(os.path.join(REPO, "configs", "clip_fdt_tiny_cpu_cluster.yaml"))
    with open(os.path.join(REPO, "configs", "clip_fdt_tiny_cpu_cluster.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["data"] = {"train": {
        "data_path": str(root / "shards" / "{00000..00001}.tar"), "batch_size": 8,
        "num_samples": 32, "workers": 0, "transforms": "ONECROP", "image_size": 32,
        "context_length": 16, "wire_dtype": "float32", "epoch": 1}}
    config = root / "viz.yaml"
    config.write_text(yaml.safe_dump(raw))
    model = model_entry(cfg.model, device="cpu", generator=torch.Generator().manual_seed(3))
    ps = dict(model.named_parameters())
    state = TrainState.create(ps, adamw_init(ps), trainable_mask_tree(ps), ps["space_dict"])
    ckpt = save_checkpoint(str(root / "ckpt"), model, state, 4)
    return {"root": root, "config": str(config), "ckpt": ckpt}


def _load_script(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_codebook_viz_matches_jax(viz_setup, tmp_path, monkeypatch):
    """The port's ``tools/run_codebook_viz.py`` against the top-level JAX
    script over the same shards and checkpoint: the same batches, the same
    top-k sets in the same order (margins asserted), the same grid files and
    ``text_codes.json`` (codes, captions, order; weights within
    TINY_WEIGHT_ATOL), and each grid within one 8-bit level of JAX's."""
    captured = {}
    for side, mod in (("jax", jviz), ("port", pviz)):
        for fn in ("sweep_image_codes", "sweep_text_codes"):
            def wrapped(encoder_fn, batches, *a, _orig=getattr(mod, fn), _key=(side, fn), **kw):
                seen = []

                def rec(*args):
                    out = encoder_fn(*args)
                    seen.append(np.asarray(out[1]))
                    return out
                tracker = _orig(rec, batches, *a, **kw)
                captured[_key] = (tracker, np.concatenate(seen), list(batches))
                return tracker
            monkeypatch.setattr(mod, fn, wrapped)
    argv = ["--config", viz_setup["config"], "--ckpt", viz_setup["ckpt"], "--batches", "3",
            "--topk", "3", "--max_codes", "6"]
    script = _load_script(os.path.join(REPO, "tools", "run_codebook_viz.py"), "jax_viz_sweep")
    monkeypatch.setattr("sys.argv", ["run_codebook_viz.py", *argv, "--out",
                                     str(tmp_path / "jax")])
    script.main()
    wrote = pviz_sweep.run(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert wrote["text_codes"] == str(tmp_path / "port" / "text_codes.json")
    for fn in ("sweep_image_codes", "sweep_text_codes"):
        tj, wj, bj = captured[("jax", fn)]
        tp, wp, bp = captured[("port", fn)]
        assert len(bj) == len(bp) == 3
        for a, b in zip(bp, bj):
            for key in ("tokens", "pad_mask"):
                np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a["image"], b["image"])
        _close(wp, wj, atol=TINY_WEIGHT_ATOL, msg=fn)
        keys = [row.tobytes() for b in bj for row in
                (b["image"] if fn == "sweep_image_codes" else b["tokens"])]
        assert_tracker_margins(wj, 3, TINY_WEIGHT_ATOL, keys)
        assert_trackers_agree(tp, tj, wj.shape[1], _image_payload_close
                              if fn == "sweep_image_codes" else
                              lambda a, b: (a == b) or pytest.fail(f"{a!r} != {b!r}"),
                              TINY_WEIGHT_ATOL)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    grids = [n for n in names if n.endswith(".png")]
    assert grids and [os.path.join(tmp_path / "port", n) for n in grids] == sorted(wrote["grids"])
    assert_pngs_within_one_level(tmp_path / "port", tmp_path / "jax", grids)
    codes_j, codes_p = (json.loads((tmp_path / s / "text_codes.json").read_text())
                        for s in ("jax", "port"))
    assert list(codes_p) == list(codes_j) and codes_j
    for code, items in codes_j.items():
        assert [i["text"] for i in codes_p[code]] == [i["text"] for i in items]
        _close([i["weight"] for i in codes_p[code]], [i["weight"] for i in items],
               atol=TINY_WEIGHT_ATOL)


def test_dump_features_matches_jax_and_the_encoder(viz_setup, tmp_path):
    """``tools/inference.py``: the port's ``dump_features`` writes exactly
    ``TorchEncoder``'s outputs; its CLI (``--device cpu``) gives the JAX
    tool's arrays within the loader tolerance of ``test_torch_port_eval.py``
    (1e-4)."""
    from iterated_learning_for_vlm_tpu.eval.model_loader import load_eval_encoder as jload
    from iterated_learning_for_vlm_tpu_torch.eval.model_loader import load_eval_encoder

    rng = np.random.default_rng(9)
    image_dir = tmp_path / "images"
    image_dir.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
            image_dir / f"{i}.png")
    captions = tmp_path / "caps.txt"
    captions.write_text("a photo of a cat\n\nthe dog runs\na red ring on a blue mat\n")
    out = tmp_path / "port.npz"
    assert pinference.main(["--model_config", viz_setup["config"], "--pretrained",
                            viz_setup["ckpt"], "--image_dir", str(image_dir),
                            "--captions_file", str(captions), "--out", str(out),
                            "--batch_size", "2", "--device", "cpu"]) == str(out)
    got = np.load(out)
    enc = load_eval_encoder(viz_setup["config"], viz_setup["ckpt"], batch_size=2, device="cpu")
    images = [Image.open(image_dir / f"{i}.png").convert("RGB") for i in range(5)]
    texts = ["a photo of a cat", "the dog runs", "a red ring on a blue mat"]
    direct = pinference.dump_features(enc, images, texts, str(tmp_path / "direct.npz"))
    ref = np.load(direct)
    assert sorted(got) == sorted(ref) == ["image_embeds", "text_embeds"]
    np.testing.assert_array_equal(ref["image_embeds"], enc.encode_images(images))
    np.testing.assert_array_equal(ref["text_embeds"], enc.encode_texts(texts))
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    jenc = jload(viz_setup["config"], viz_setup["ckpt"], batch_size=2, num_workers=1)
    want = np.load(jinference.dump_features(jenc, images, texts, str(tmp_path / "jax.npz")))
    for key in want:
        _close(got[key], want[key], atol=1e-4, msg=key)
