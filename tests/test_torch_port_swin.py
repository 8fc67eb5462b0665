"""CLIP with the Swin-MoE image tower: the PyTorch port vs the JAX package and vs
the benchmark's plain reference, on the CPU in float32.

The layers (window attention with and without the shift mask, patch merging,
the top-1 MoE MLP with forced overflow) take the JAX modules' parameters
(kernels transposed to torch's ``[out, in]``); the whole small CLIP
(Swin-MoE tower of two stages at 48 px, window 6, head width 32, 4 experts
in one block of each stage; a 2-layer text tower) goes through the weight
bridge. On the card, window attention runs on K4 instead: the kernels are
held to their plain versions in ``tests/test_torch_port_gpu.py``.

Tolerances: fp32 on both sides, the sums taken in another order: 1e-5 of
the larger of 1 and the tensor's largest magnitude on layer outputs and
their gradients; the whole model's loss within 1e-5 and each gradient leaf
within 1e-4 of its own scale (a leaf's gradient sums many products, and the
router's softmax sits under every expert's output); the expert each token
takes must agree exactly (no gate logit here is within rounding of a tie).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu.models import swin as jswin
from iterated_learning_for_vlm_tpu.train.loss import clip_info_nce as j_info_nce
from iterated_learning_for_vlm_tpu_torch.models import clip_swinMoE_B, model_entry, swin
from iterated_learning_for_vlm_tpu_torch.ops import window_attention as wa
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import (
    jax_path, load_jax_params, state_dict_from_jax_params,
)
from iterated_learning_for_vlm_tpu_torch.train import optim
from iterated_learning_for_vlm_tpu_torch.train.step import MOE_AUX_WEIGHT, make_train_step
from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState
from test_torch_port_slice import CTX, VOCAB, make_batch

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
GRAD_RTOL = 1e-4
RES, WS = 48, 6
PCONFIG = {"ln_w": {"weight_decay": 0}, "ln_b": {"weight_decay": 0},
           "bias": {"weight_decay": 0}, "logit_scale": {"weight_decay": 0}}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol):
    """Every element within ``rtol`` of the larger of 1 and ``want``'s largest
    magnitude (a sum's rounding scales with its terms, not with its value)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _noisy(params, seed=1, scale=0.02):
    rng = _rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape)
                        .astype(np.float32), params)


# -- layers --------------------------------------------------------------------------
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_matches_jax(shifted):
    dim, heads, nw_img, n_img = 64, 2, 4, 2
    x = _rng(0).standard_normal((nw_img * n_img, WS * WS, dim)).astype(np.float32)
    mask = wa.shift_mask(2 * WS, WS, WS // 2) if shifted else None
    jmod = jswin.WindowAttention(dim, heads, WS, v2=False)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask)["params"], scale=0.1)
    r = _rng(2).standard_normal((nw_img * n_img, WS * WS, dim)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jmod.apply({"params": p}, x, mask) * r)

    jout = jmod.apply({"params": params}, jnp.asarray(x), mask)
    jgrad, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))

    port = swin.WindowAttention(dim, heads, WS)
    with torch.no_grad():
        port.qkv.weight.copy_(_t(params["qkv"]["kernel"]).t())
        port.qkv.bias.copy_(_t(params["qkv"]["bias"]))
        port.proj.weight.copy_(_t(params["proj"]["kernel"]).t())
        port.proj.bias.copy_(_t(params["proj"]["bias"]))
        port.relative_position_bias_table.copy_(_t(params["relative_position_bias_table"]))
    xt = _t(x).requires_grad_()
    out = port(xt, None if mask is None else torch.from_numpy(mask))
    _close(out.detach().numpy(), jout, ATOL)
    (out * _t(r)).sum().backward()
    _close(xt.grad.numpy(), jdx, ATOL)
    _close(port.relative_position_bias_table.grad.numpy(),
           jgrad["relative_position_bias_table"], ATOL)
    _close(port.qkv.weight.grad.numpy(), np.asarray(jgrad["qkv"]["kernel"]).T, ATOL)


def test_shift_mask_and_index_match_jax():
    block = jswin.SwinBlock(dim=64, heads=2, resolution=4 * WS, window_size=WS, shift=WS // 2,
                            mlp_ratio=4.0, v2=False)
    np.testing.assert_array_equal(wa.shift_mask(4 * WS, WS, WS // 2),
                                  np.asarray(block._shift_mask(4 * WS, WS, WS // 2)))
    rel = jswin._relative_coords(WS)
    want = (rel[..., 0] + WS - 1) * (2 * WS - 1) + rel[..., 1] + WS - 1
    np.testing.assert_array_equal(wa.relative_position_index(WS), want)


def test_window_attention_function_matches_autograd():
    """The kernels' autograd path with their plain versions (what a CPU tensor
    takes): ``WindowAttentionFn`` and the table's gradient by diagonal sums
    against autograd through the plain forward and the indexed gather."""
    heads, n = 2, WS * WS
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(8, n, 3 * 32 * heads, generator=g)
    table = 0.5 * torch.randn((2 * WS - 1) ** 2, heads, generator=g)
    mask = torch.from_numpy(wa.shift_mask(2 * WS, WS, WS // 2))
    index = torch.from_numpy(wa.relative_position_index(WS))
    dout = torch.randn(8, n, 32 * heads, generator=g)
    got, want = [], []
    for kernel_path, sink in ((True, got), (False, want)):
        x, t = qkv.clone().requires_grad_(), table.clone().requires_grad_()
        if kernel_path:
            out = wa.WindowAttentionFn.apply(x, wa.RelativePositionBias.apply(t, index, WS),
                                             mask, heads)
        else:
            rel = t[index.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
            out = wa.window_attention_reference(x, wa.combined_bias(rel, mask), heads)
        out.backward(dout)
        sink += [out.detach(), x.grad, t.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_patch_merging_matches_jax():
    dim, res = 32, 8
    x = _rng(3).standard_normal((2, res * res, dim)).astype(np.float32)
    jmod = jswin.PatchMerging(dim=dim, resolution=res, v2=False)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], scale=0.3)
    jout = jmod.apply({"params": params}, jnp.asarray(x))
    port = swin.PatchMerging(dim, res)
    with torch.no_grad():
        port.norm.weight.copy_(_t(params["norm"]["norm"]["scale"]))
        port.norm.bias.copy_(_t(params["norm"]["norm"]["bias"]))
        port.reduction.weight.copy_(_t(params["reduction"]["kernel"]).t())
    _close(port(_t(x)).detach().numpy(), jout, ATOL)


def test_moe_with_drops_matches_jax():
    """Capacity factor 0.5 forces overflow: the dropped tokens' outputs are
    0 on both sides, and the output, the aux term and every gradient agree."""
    dim, hidden, experts, cf = 64, 128, 4, 0.5
    x = _rng(4).standard_normal((2, 36, dim)).astype(np.float32)
    r = _rng(5).standard_normal((2, 36, dim)).astype(np.float32)
    jmod = jswin.MoEMlp(dim=dim, hidden=hidden, num_experts=experts, top_k=1,
                        capacity_factor=cf)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], scale=0.3)

    def jloss(p, x):
        y, aux = jmod.apply({"params": p}, x)
        return jnp.sum(y * r) + 3.0 * aux

    jy, jaux = jmod.apply({"params": params}, jnp.asarray(x))
    jgrad, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))

    port = swin.MoEMlp(dim, hidden, experts, capacity_factor=cf)
    with torch.no_grad():
        port.gate.weight.copy_(_t(params["gate"]["kernel"]).t())
        for name in ("w1", "b1", "w2", "b2"):
            getattr(port, name).copy_(_t(params[name]))
    xt = _t(x).requires_grad_()
    y, aux = port(xt)
    dropped = (np.abs(np.asarray(jy)).sum(-1) == 0).sum()
    assert dropped > 0 and port.capacity(72) == 9
    _close(y.detach().numpy(), jy, ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=ATOL)
    ((y * _t(r)).sum() + 3.0 * aux).backward()
    _close(xt.grad.numpy(), jdx, ATOL)
    _close(port.gate.weight.grad.numpy(), np.asarray(jgrad["gate"]["kernel"]).T, ATOL)
    for name in ("w1", "b1", "w2", "b2"):
        _close(getattr(port, name).grad.numpy(), jgrad[name], ATOL)
    routed, kept, slots, largest = port.counters.tolist()
    assert (routed, slots) == (72, 36) and kept == 72 - dropped and largest >= 9


# -- the whole model -----------------------------------------------------------------------
def swin_cfg(**image) -> dict:
    kw = {"image_encode": {"input_resolution": RES, "window_size": WS, "depths": (2, 2),
                           "num_heads": (4, 8), "num_experts": 4, "embed_dim": 32,
                           "moe_blocks": ((1,), (1,)), **image},
          "text_encode": {"context_length": CTX, "vocab_size": VOCAB, "width": 64, "heads": 2,
                          "layers": 2, "embed_dim": 32},
          "dtype": "float32"}
    return {"type": "clip_swinMoE_B", "kwargs": kw}


def swin_batch(seed, n=4):
    _, tokens, pad = make_batch(seed, n)
    images = _rng(seed + 100).standard_normal((n, RES, RES, 3)).astype(np.float32)
    return images, tokens, pad


@pytest.fixture(scope="module")
def jax_clip():
    model = jax_model_entry(swin_cfg())
    images, tokens, pad = (jnp.asarray(x) for x in swin_batch(0))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), images, tokens, pad)["params"]
    return model, _noisy(params)


def _port_model(params):
    model = model_entry(swin_cfg(), device="cpu")
    return load_jax_params(model, params)


def test_bridge_and_weight_decay_follow_jax(jax_clip):
    """Every Swin leaf crosses the bridge and back (``jax_path``), and its
    weight-decay category is the JAX package's."""
    from iterated_learning_for_vlm_tpu.train import optim as joptim

    _, params = jax_clip
    model = _port_model(params)
    wd = optim.build_wd_tree(dict(model.named_parameters()), 0.1, PCONFIG)
    flat = {tuple(str(getattr(k, "key", k)) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    jwd = joptim.build_wd_tree(params, 0.1, PCONFIG)
    jflat = {tuple(str(getattr(k, "key", k)) for k in path): float(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jwd)[0]}
    for name in wd:
        path = jax_path(name)
        if path[:3] == ("text", "transformer", "resblocks"):
            continue  # layer-stacked leaves: checked by the CLIP tests
        assert path in flat, name
        assert wd[name] == jflat[path], name
    assert wd["visual.layers.0.blocks.1.mlp.b1"] == 0.1
    assert wd["visual.layers.0.blocks.1.norm2.weight"] == 0.0


def _jax_loss_and_grads(model, params, batch):
    def loss_fn(p):
        out = model.apply({"params": p}, *batch)
        loss, _ = j_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])
        return loss + 0.01 * out["moe_aux"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), state_dict_from_jax_params(grads)


def test_train_step_loss_and_grads_match_jax(jax_clip):
    """``make_train_step`` on the port's CLIP Swin-MoE: the loss (InFoNCE plus
    ``0.01 * moe_aux``) and every parameter's gradient against JAX's
    ``value_and_grad`` of the same objective."""
    model, params = jax_clip
    batch = swin_batch(1)
    jloss, jgrads = _jax_loss_and_grads(model, params, tuple(jnp.asarray(x) for x in batch))
    port = _port_model(params)
    named = dict(port.named_parameters())
    wd = optim.build_wd_tree(named, 0.1, PCONFIG)
    state = TrainState.create(named, optim.adamw_init(named), optim.trainable_mask_tree(named))
    step = make_train_step(port, lambda s: 0.0, wd, is_fdt=False)
    images, tokens, pad = (torch.from_numpy(x) for x in batch)
    metrics = step(state, {"image": images, "tokens": tokens, "pad_mask": pad}, 0.0)
    assert MOE_AUX_WEIGHT == 0.01
    np.testing.assert_allclose(float(metrics["loss"]), jloss, atol=ATOL)
    for name, p in named.items():
        want = jgrads[name]
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=GRAD_RTOL * scale, err_msg=name)


def test_model_matches_the_benchmark_reference(jax_clip):
    """The benchmark's plain reference (``benchmark_torch/reference/swin_moe.py``,
    which imports nothing of the port) on the port's parameters: the same
    loss, gradients and per-token experts."""
    sys.path[:0] = [str(ROOT / "benchmark_torch")]
    try:
        from reference import swin_moe as ref
    finally:
        sys.path.remove(str(ROOT / "benchmark_torch"))
    _, params = jax_clip
    port = _port_model(params)
    cfg = swin_cfg()
    cfg["model"] = {"type": cfg.pop("type"), "kwargs": cfg.pop("kwargs")}
    images, tokens, pad = (torch.from_numpy(x) for x in swin_batch(2))
    batch = {"image": images, "tokens": tokens, "pad_mask": pad}
    routes = []
    hooks = [layer.register_forward_pre_hook(
        lambda m, a: routes.append((a[0].reshape(-1, a[0].shape[-1]) @ m.gate.weight.t())
                                   .argmax(-1))) for layer in port.visual.moe_layers()]
    out = port(images, tokens, pad)
    for h in hooks:
        h.remove()
    from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce

    loss = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])[0]
    loss = loss + 0.01 * out["moe_aux"]
    loss.backward()
    P = {n: p.detach().clone().requires_grad_() for n, p in port.named_parameters()}
    assert set(P) == {name for name, *_ in ref.param_specs(cfg)}
    ref_routes = []
    ref_loss = ref.SwinNet(cfg).swin_loss(P, batch, ref_routes)
    ref_loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss.detach()), atol=ATOL)
    for a, b in zip(routes, ref_routes):
        assert torch.equal(a, b)
    for name, p in port.named_parameters():
        want = P[name].grad
        scale = max(float(want.abs().max()), 1e-6)
        torch.testing.assert_close(p.grad, want, atol=GRAD_RTOL * scale, rtol=0, msg=name)


def test_solver_trains_the_recipe(tmp_path):
    """A few ``Solver`` steps of ``configs/clip_swinmoe_b_cc3m.yaml`` with the
    towers cut to the CPU tests' size and synthetic batches: the loss is
    finite, every parameter of the tower moves, the MoE layers counted."""
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import load_config

    cfg = load_config(str(ROOT / "configs" / "clip_swinmoe_b_cc3m.yaml"))
    small = swin_cfg()["kwargs"]
    cfg.model.kwargs.image_encode.update(small["image_encode"])
    cfg.model.kwargs.text_encode.update(small["text_encode"], vocab_size=49409)  # real ids
    cfg.data.train = {"synthetic": True, "batch_size": 4, "num_batches": 3, "epoch": 1}
    cfg.saver = {"print_freq": 1, "save_freq": 0, "val_freq": 0}
    cfg.data.test = {"sc_image_root": None, "sc_data_root": None}
    solver = Solver(cfg, output_path=str(tmp_path), seed=3, device="cpu")
    before = {n: p.detach().clone() for n, p in solver.model.named_parameters()}
    losses = []
    step = solver.train_step
    solver.train_step = lambda *a: losses.append(float(step(*a)["loss"])) or {"loss": torch.tensor(
        losses[-1]), "lr": 0.0, "logit_scale": torch.tensor(0.0), "acc1": torch.tensor(0.0),
        "acc5": torch.tensor(0.0)}
    solver.train()
    assert len(losses) == 3 and all(np.isfinite(losses))
    moved = [n for n, p in solver.model.named_parameters()
             if n.startswith("visual.") and not torch.equal(p, before[n])]
    assert len(moved) == sum(1 for n in before if n.startswith("visual."))
    assert sum(int(m.counters[0]) for m in solver.model.visual.moe_layers()) == 3 * 4 * (144 + 36)


def test_recipe_builds_the_published_tower():
    """The recipe's model block at its published widths (on the meta device):
    192 px, window 12, head width 32 in every stage, 32 experts in the 10
    MOE_BLOCKS, 1.00 B parameters."""
    from iterated_learning_for_vlm_tpu_torch.utils.config import load_config

    kw = load_config(str(ROOT / "configs" / "clip_swinmoe_b_cc3m.yaml")).model.to_dict()["kwargs"]
    model = clip_swinMoE_B(device="meta", **kw)
    cfg = model.visual.cfg
    assert (cfg.input_resolution, cfg.window_size, cfg.embed_dim) == (192, 12, 128)
    assert all((128 << i) // h == 32 for i, h in enumerate(cfg.num_heads))
    moe = model.visual.moe_layers()
    assert len(moe) == 10 and all(m.num_experts == 32 for m in moe)
    placed = [(s, b) for s, layer in enumerate(model.visual.layers)
              for b, block in enumerate(layer.blocks) if block.moe]
    assert placed == [(2, b) for b in range(1, 18, 2)] + [(3, 1)]
    assert round(sum(p.numel() for p in model.parameters()) / 1e6) == 997


def test_other_swin_towers_still_raise():
    for mtype in ("clip_swinL", "clip_swinB_v2", "clip_swinMLP_B", "clip_fdt_swinB_v2"):
        with pytest.raises(KeyError, match="not ported.*clip_swinMoE_B"):
            model_entry({"type": mtype, "kwargs": {}}, device="cpu")
    with pytest.raises(NotImplementedError, match="v2"):
        swin.SwinTransformer(swin.SwinConfig(v2=True), device="meta")
