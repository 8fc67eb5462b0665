"""CLIP with the Swin-MoE and Swin V2 image towers: the PyTorch port vs the JAX
package and vs the benchmark's plain references, on the CPU in float32.

The layers (window attention of both forms with and without the shift mask,
the v2 block, patch merging of both orders, the top-1 MoE MLP with forced
overflow) take the JAX modules' parameters (kernels transposed to torch's
``[out, in]``); the whole small CLIP (Swin-MoE tower of two stages at 48 px,
window 6, head width 32, 4 experts in one block of each stage; a 2-layer
text tower) and the small CLIP-FDT with a Swin V2 tower of the same shape go
through the weight bridge. On the card, window attention runs on K4
instead: the kernels are held to their plain versions in
``tests/test_torch_port_gpu.py``.

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
from iterated_learning_for_vlm_tpu_torch.models import (
    clip_fdt_swinB_v2, clip_swinMoE_B, model_entry, swin,
)
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


def _load_v2_attention(port, params):
    with torch.no_grad():
        port.qkv.weight.copy_(_t(params["qkv"]["kernel"]).t())
        port.qkv.bias.copy_(_t(params["qkv"]["bias"]))
        port.proj.weight.copy_(_t(params["proj"]["kernel"]).t())
        port.proj.bias.copy_(_t(params["proj"]["bias"]))
        port.logit_scale.copy_(_t(params["logit_scale"]))
        port.cpb_mlp[0].weight.copy_(_t(params["cpb_fc1"]["kernel"]).t())
        port.cpb_mlp[0].bias.copy_(_t(params["cpb_fc1"]["bias"]))
        port.cpb_mlp[2].weight.copy_(_t(params["cpb_fc2"]["kernel"]).t())


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_v2_matches_jax(shifted):
    """Cosine attention with the continuous position bias: the port's table
    form of the bias MLP against JAX's per-pair form, forward and every
    gradient (one head's logit scale above the ln 100 clamp, so its gradient
    is 0 on both sides)."""
    dim, heads, nw_img, n_img = 64, 2, 4, 2
    x = _rng(10).standard_normal((nw_img * n_img, WS * WS, dim)).astype(np.float32)
    mask = wa.shift_mask(2 * WS, WS, WS // 2) if shifted else None
    jmod = jswin.WindowAttention(dim, heads, WS, v2=True)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask)["params"], scale=0.1)
    params["logit_scale"] = np.array([[[5.0]], [[1.5]]], np.float32)
    r = _rng(12).standard_normal((nw_img * n_img, WS * WS, dim)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jmod.apply({"params": p}, x, mask) * r)

    jout = jmod.apply({"params": params}, jnp.asarray(x), mask)
    jgrad, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))

    port = swin.WindowAttentionV2(dim, heads, WS)
    _load_v2_attention(port, params)
    xt = _t(x).requires_grad_()
    out = port(xt, None if mask is None else torch.from_numpy(mask))
    _close(out.detach().numpy(), jout, ATOL)
    (out * _t(r)).sum().backward()
    _close(xt.grad.numpy(), jdx, ATOL)
    _close(port.qkv.weight.grad.numpy(), np.asarray(jgrad["qkv"]["kernel"]).T, ATOL)
    _close(port.logit_scale.grad.numpy(), jgrad["logit_scale"], ATOL)
    assert float(port.logit_scale.grad[0]) == 0.0 and float(port.logit_scale.grad[1]) != 0.0
    _close(port.cpb_mlp[0].weight.grad.numpy(), np.asarray(jgrad["cpb_fc1"]["kernel"]).T, ATOL)
    _close(port.cpb_mlp[0].bias.grad.numpy(), jgrad["cpb_fc1"]["bias"], ATOL)
    _close(port.cpb_mlp[2].weight.grad.numpy(), np.asarray(jgrad["cpb_fc2"]["kernel"]).T, ATOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_cosine_window_attention_function_matches_autograd(shifted):
    """The cosine form of the kernels' autograd path with their plain versions
    (what a CPU tensor takes), against autograd through the normalisation:
    dqkv, the bias table's gradient and the scale's."""
    heads, n, windows = 2, WS * WS, 8
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(windows, n, 3 * 32 * heads, generator=g)
    table = 0.5 * torch.randn((2 * WS - 1) ** 2, heads, generator=g)
    mask = torch.from_numpy(wa.shift_mask(2 * WS, WS, WS // 2)) if shifted else None
    index = torch.from_numpy(wa.relative_position_index(WS))
    dout = torch.randn(windows, n, 32 * heads, generator=g)
    got, want = [], []
    for kernel_path, sink in ((True, got), (False, want)):
        x, t = qkv.clone().requires_grad_(), table.clone().requires_grad_()
        ls = torch.tensor([2.3, 1.1], requires_grad=True)
        rel = wa.RelativePositionBias.apply(t, index, WS)
        if kernel_path:
            out = wa.WindowAttentionFn.apply(x, rel, mask, heads, ls.exp())
        else:
            q, k, v = (u.reshape(windows, n, heads, 32) for u in x.split(32 * heads, dim=-1))
            q = q / (q.norm(dim=-1, keepdim=True) + 1e-12)
            k = k / (k.norm(dim=-1, keepdim=True) + 1e-12)
            logits = torch.einsum("wqhc,wkhc->whqk", q, k) * ls.exp()[:, None, None]
            logits = logits + wa._per_window(wa.combined_bias(rel, mask), windows)
            out = torch.einsum("whqk,wkhc->wqhc", logits.softmax(-1), v).reshape(windows, n, -1)
        out.backward(dout)
        sink += [out.detach(), x.grad, t.grad, ls.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)


def test_v2_block_matches_jax():
    """A shifted res-post-norm block (norm after attention and after the MLP)
    against JAX's ``SwinBlock(v2=True)``: output and input gradient."""
    dim, heads, res = 64, 2, 2 * WS
    x = _rng(14).standard_normal((2, res * res, dim)).astype(np.float32)
    r = _rng(15).standard_normal((2, res * res, dim)).astype(np.float32)
    jmod = jswin.SwinBlock(dim=dim, heads=heads, resolution=res, window_size=WS, shift=WS // 2,
                           mlp_ratio=4.0, v2=True)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], scale=0.1)

    def jloss(p, x):
        return jnp.sum(jmod.apply({"params": p}, x)[0] * r)

    jout = jmod.apply({"params": params}, jnp.asarray(x))[0]
    jgrad, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    port = swin.SwinBlock(dim, heads, res, WS, WS // 2, 4.0, v2=True)
    _load_v2_attention(port.attn, params["attn"])
    with torch.no_grad():
        for ln in ("norm1", "norm2"):
            getattr(port, ln).weight.copy_(_t(params[ln]["norm"]["scale"]))
            getattr(port, ln).bias.copy_(_t(params[ln]["norm"]["bias"]))
        for fc in ("fc1", "fc2"):
            getattr(port.mlp, fc).weight.copy_(_t(params[f"mlp_{fc}"]["kernel"]).t())
            getattr(port.mlp, fc).bias.copy_(_t(params[f"mlp_{fc}"]["bias"]))
    xt = _t(x).requires_grad_()
    out, aux = port(xt)
    assert aux is None
    _close(out.detach().numpy(), jout, ATOL)
    (out * _t(r)).sum().backward()
    _close(xt.grad.numpy(), jdx, ATOL)
    _close(port.norm1.weight.grad.numpy(), jgrad["norm1"]["norm"]["scale"], ATOL)
    _close(port.attn.cpb_mlp[2].weight.grad.numpy(),
           np.asarray(jgrad["attn"]["cpb_fc2"]["kernel"]).T, ATOL)


def test_shift_mask_and_index_match_jax():
    block = jswin.SwinBlock(dim=64, heads=2, resolution=4 * WS, window_size=WS, shift=WS // 2,
                            mlp_ratio=4.0, v2=False)
    np.testing.assert_array_equal(wa.shift_mask(4 * WS, WS, WS // 2),
                                  np.asarray(block._shift_mask(4 * WS, WS, WS // 2)))
    rel = jswin._relative_coords(WS)
    want = (rel[..., 0] + WS - 1) * (2 * WS - 1) + rel[..., 1] + WS - 1
    np.testing.assert_array_equal(wa.relative_position_index(WS), want)


# -- K4's walk plan: which windows each block of a launch walks --------------
# (windows, heads, nbias, SMs, blocks an SM holds). Swin-B at 192 px and 256
# images on an H100's 132 SMs, one K4 block an SM at N = 144 (stage 0
# shifted, stage 1 shifted and not, stage 2) and 4 or 6 at N = 36 (stage 3);
# the GPU tests' walking shapes (68 windows: the blocks of a head share them
# unevenly); launches the card holds whole (the digest shapes); a card
# smaller than a (slice, head) each.
WALK_CASES = [(4096, 4, 16, 132, 1), (1024, 8, 4, 132, 1), (1024, 8, 1, 132, 1),
              (256, 16, 1, 132, 1), (256, 32, 1, 132, 6), (256, 32, 1, 132, 4),
              (64, 16, 1, 132, 1), (256, 4, 16, 132, 1), (68, 16, 1, 132, 1),
              (32, 4, 16, 132, 1), (16, 32, 1, 132, 4), (12, 2, 4, 2, 1), (7, 3, 1, 5, 2)]


@pytest.mark.parametrize("windows,heads,nbias,sms,per_sm", WALK_CASES)
def test_walk_plan_covers_every_window_once(windows, heads, nbias, sms, per_sm):
    """Every (window, head) lands in exactly one block; a block's windows
    share one bias slice (``w % nbias``, the block's own) and ascend; no
    block walks more than the plan's longest walk; a launch the card holds
    whole takes one window a block, a larger one at most the blocks the card
    holds (or one a (slice, head))."""
    plan = wa.walk_plan(windows, heads, nbias, sms, per_sm)
    assert plan.blocks == nbias * plan.per * heads
    seen = []
    for block in range(nbias * plan.per):  # a block of each head walks the same windows
        walked = wa.block_windows(block, windows, nbias, plan.per)
        assert 1 <= len(walked) <= plan.walk and walked == sorted(walked)
        assert {w % nbias for w in walked} == {block % nbias}
        seen += walked
    assert sorted(seen) == list(range(windows))
    assert max(len(wa.block_windows(b, windows, nbias, plan.per))
               for b in range(nbias * plan.per)) == plan.walk
    if windows * heads <= sms * per_sm:
        assert plan.walk == 1 and plan.blocks == windows * heads
    else:
        assert plan.walk > 1 and plan.blocks <= max(sms * per_sm, nbias * heads)


@pytest.mark.parametrize("windows,heads,nbias,sms,per_sm,want", [
    (4096, 4, 16, 132, 1, (2, 128, 128)), (1024, 8, 4, 132, 1, (4, 128, 64)),
    (1024, 8, 1, 132, 1, (16, 128, 64)), (256, 16, 1, 132, 1, (8, 128, 32)),
    (256, 32, 1, 132, 6, (24, 768, 11)), (68, 16, 1, 132, 1, (8, 128, 9))])
def test_walk_plan_at_the_swin_b_stages(windows, heads, nbias, sms, per_sm, want):
    """The plans at Swin-B's stages on an H100 (``WALK_CASES``): per, blocks
    and the longest walk; at N = 144 the blocks fill 128 of the 132 SMs."""
    assert tuple(wa.walk_plan(windows, heads, nbias, sms, per_sm)) == want


@pytest.mark.parametrize("args", [(10, 2, 3, 132, 1), (0, 2, 1, 132, 1), (8, 2, 1, 132, 0)])
def test_walk_plan_refuses_what_no_launch_takes(args):
    """nbias must divide the windows; every count is at least 1."""
    with pytest.raises(ValueError, match="walk_plan"):
        wa.walk_plan(*args)


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


def test_patch_merging_v2_matches_jax():
    """v2 merging: the reduction, then the LayerNorm of its 2C outputs."""
    dim, res = 32, 8
    x = _rng(13).standard_normal((2, res * res, dim)).astype(np.float32)
    jmod = jswin.PatchMerging(dim=dim, resolution=res, v2=True)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], scale=0.3)
    jout = jmod.apply({"params": params}, jnp.asarray(x))
    port = swin.PatchMerging(dim, res, v2=True)
    assert port.norm.weight.shape == (2 * dim,)
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
    for mtype in ("clip_swinL", "clip_swinL_v2", "clip_swinMLP_B"):
        with pytest.raises(KeyError, match="not ported.*clip_swinMoE_B"):
            model_entry({"type": mtype, "kwargs": {}}, device="cpu")
    with pytest.raises(NotImplementedError, match="Swin-MLP"):
        swin.SwinTransformer(swin.SwinConfig(mlp_mix=True), device="meta")


# -- Swin V2-B: CLIP and CLIP-FDT ------------------------------------------------------------
PARAMS_M = 154.3  # CLIP-FDT Swin V2-B: 87.4 M in the tower, the text tower, codebook and heads
V2_TOWER = {"input_resolution": RES, "window_size": WS, "depths": (2, 2), "num_heads": (4, 8),
            "embed_dim": 32}


def swin_v2_cfg(mtype="clip_fdt_swinB_v2") -> dict:
    """A two-stage V2 tower at 48 px (stage 0: 12 x 12 tokens of 128 channels,
    shifted windows of 6; stage 1: one 6 x 6 window of 256), a 2-layer text
    tower; CLIP-FDT's codebook of 96 x 32 reads the last stage's 36 tokens."""
    kw = {"image_encode": dict(V2_TOWER),
          "text_encode": {"context_length": CTX, "vocab_size": VOCAB, "width": 64, "heads": 2,
                          "layers": 2, "embed_dim": 32},
          "dtype": "float32"}
    if mtype == "clip_fdt_swinB_v2":
        kw["fdt"] = {"sd_num": 96, "sd_dim": 32, "raw_img_ft_dim": 256, "raw_txt_ft_dim": 64,
                     "att_func_type": "sparsemax", "pool_type": "max",
                     "sparsemax_method": "bisect", "sd_temperature": 0.5}
    return {"type": mtype, "kwargs": kw}


@pytest.fixture(scope="module")
def jax_v2():
    """Noisy JAX params of both small V2 models (CLIP and CLIP-FDT)."""
    out = {}
    images, tokens, pad = (jnp.asarray(x) for x in swin_batch(0))
    for mtype in ("clip_swinB_v2", "clip_fdt_swinB_v2"):
        model = jax_model_entry(swin_v2_cfg(mtype))
        params = jax.jit(model.init)(jax.random.PRNGKey(0), images, tokens, pad)["params"]
        out[mtype] = (model, _noisy(params, seed=3))
    return out


@pytest.mark.parametrize("mtype", ["clip_swinB_v2", "clip_fdt_swinB_v2"])
def test_v2_train_step_loss_and_grads_match_jax(jax_v2, mtype):
    """``make_train_step`` on the port's small V2 models: the InfoNCE and every
    parameter's gradient against JAX's ``value_and_grad`` (leaves the loss
    never reads, such as CLIP-FDT's ``visual.proj``, get None here and zeros
    in JAX)."""
    model, params = jax_v2[mtype]
    batch = swin_batch(4)
    jbatch = tuple(jnp.asarray(x) for x in batch)

    def loss_fn(p):
        out = model.apply({"params": p}, *jbatch)
        return j_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = state_dict_from_jax_params(jgrads)
    port = load_jax_params(model_entry(swin_v2_cfg(mtype), device="cpu"), params)
    named = dict(port.named_parameters())
    wd = optim.build_wd_tree(named, 0.1, PCONFIG)
    state = TrainState.create(named, optim.adamw_init(named), optim.trainable_mask_tree(named))
    is_fdt = mtype == "clip_fdt_swinB_v2"
    step = make_train_step(port, lambda s: 0.0, wd, is_fdt=is_fdt)
    images, tokens, pad = (torch.from_numpy(x) for x in batch)
    metrics = step(state, {"image": images, "tokens": tokens, "pad_mask": pad},
                   0.5 if is_fdt else None)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), atol=ATOL)
    assert set(named) == set(jgrads)
    for name, p in named.items():
        want = jgrads[name]
        if p.grad is None:
            assert not np.any(want), name
            continue
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=GRAD_RTOL * scale, err_msg=name)


def test_v2_bridge_round_trip_and_il_roots(jax_v2):
    """Every V2 leaf goes flax -> port -> flax unchanged through the bridge and
    ``jax_path``; its weight-decay category is JAX's; the IL vision reset
    finds exactly the tower's and the image query head's leaves."""
    from iterated_learning_for_vlm_tpu.train import optim as joptim
    from iterated_learning_for_vlm_tpu_torch.train import il

    _, params = jax_v2["clip_fdt_swinB_v2"]
    port = load_jax_params(model_entry(swin_v2_cfg(), device="cpu"), params)
    flat = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    jwd = {tuple(str(getattr(k, "key", k)) for k in path): float(v) for path, v in
           jax.tree_util.tree_flatten_with_path(joptim.build_wd_tree(params, 0.1, PCONFIG))[0]}
    wd = optim.build_wd_tree(dict(port.named_parameters()), 0.1, PCONFIG)
    back = {}
    for name, p in port.named_parameters():
        path = jax_path(name)
        if path[:3] == ("text", "transformer", "resblocks"):
            continue  # layer-stacked leaves: checked by the CLIP tests
        value = p.detach().numpy()
        back[path] = value.T if path[-1] == "kernel" and value.ndim == 2 else (
            value.transpose(2, 3, 1, 0) if path[-1] == "kernel" else value)
        assert wd[name] == jwd[path], name
    assert set(back) == {k for k in flat if k[:3] != ("text", "transformer", "resblocks")}
    for path, value in back.items():
        np.testing.assert_array_equal(value, flat[path], err_msg="/".join(path))
    assert wd["visual.layers.0.blocks.0.attn.logit_scale"] == 0.0
    assert wd["visual.layers.0.blocks.0.attn.cpb_mlp.0.bias"] == 0.0
    assert wd["visual.layers.0.blocks.0.attn.cpb_mlp.2.weight"] == 0.1
    named = dict(port.named_parameters())
    mask = il.weight_reset_tree(named, optim.VISION_ROOTS, (0, 6, "vision"))
    assert {n for n in mask if jax_path(n)[0] in optim.VISION_ROOTS} == {
        n for n in named if n.startswith(("visual.", "img_query_model."))}
    assert mask["visual.layers.0.blocks.0.norm1.weight"] and not mask["encode_text.ln_final.bias"]


def test_v2_model_matches_the_benchmark_reference(jax_v2):
    """The benchmark's plain reference (``benchmark_torch/reference/fdt_swinv2.py``,
    which imports nothing of the port) on the port's CLIP-FDT parameters:
    the same loss and gradients."""
    sys.path[:0] = [str(ROOT / "benchmark_torch")]
    try:
        from reference import fdt_swinv2 as ref
    finally:
        sys.path.remove(str(ROOT / "benchmark_torch"))
    from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce

    _, params = jax_v2["clip_fdt_swinB_v2"]
    port = load_jax_params(model_entry(swin_v2_cfg(), device="cpu"), params)
    cfg = swin_v2_cfg()
    cfg = {"model": {"type": cfg["type"], "kwargs": cfg["kwargs"]}}
    images, tokens, pad = (torch.from_numpy(x) for x in swin_batch(5))
    out = port(images, tokens, pad, sd_temperature=0.5)
    loss = clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])[0]
    loss.backward()
    P = {n: p.detach().clone().requires_grad_() for n, p in port.named_parameters()}
    specs = {name: shape for name, shape, *_ in ref.param_specs(cfg)}
    assert specs == {n: tuple(p.shape) for n, p in P.items()}
    batch = {"image": images, "tokens": tokens, "pad_mask": pad}
    ref_loss = ref.SwinV2Net(cfg).loss(P, batch, 0.5)
    ref_loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss.detach()), atol=ATOL)
    for name, p in port.named_parameters():
        want = P[name].grad
        if p.grad is None:
            assert want is None or not want.any(), name
            continue
        scale = max(float(want.abs().max()), 1e-6)
        torch.testing.assert_close(p.grad, want, atol=GRAD_RTOL * scale, rtol=0, msg=name)


def test_v2_solver_trains_the_recipe(tmp_path):
    """Six ``Solver`` steps of ``configs/clip_fdt_swinv2_b_cc3m.yaml`` with the
    towers cut to the CPU tests' size, synthetic batches and an IL reset
    after step 4: the loss is finite, the image tower moves, and through
    the smoothing step (5) the codebook is held and the vision tower frozen."""
    from iterated_learning_for_vlm_tpu_torch.train.solver import Solver
    from iterated_learning_for_vlm_tpu_torch.utils.config import load_config

    cfg = load_config(str(ROOT / "configs" / "clip_fdt_swinv2_b_cc3m.yaml"))
    small = swin_v2_cfg()["kwargs"]
    cfg.model.kwargs.image_encode.update(small["image_encode"])
    cfg.model.kwargs.text_encode.update(small["text_encode"], vocab_size=49409)  # real ids
    cfg.model.kwargs.fdt.update(small["fdt"], sd_temperature=1000)
    cfg.data.train = {"synthetic": True, "batch_size": 4, "num_batches": 6, "epoch": 1}
    cfg.saver = {"print_freq": 1, "save_freq": 0, "val_freq": 0}
    cfg.data.test = {"sc_image_root": None, "sc_data_root": None}
    cfg.reset.update(reset_steps=2, reset_nums=3, smooth_steps=1)
    solver = Solver(cfg, output_path=str(tmp_path), seed=3, device="cpu")
    before = {n: p.detach().clone() for n, p in solver.model.named_parameters()}
    codebooks, towers, losses = [], [], []
    step = solver.train_step

    def spy(*a):
        out = step(*a)
        losses.append(float(out["loss"]))
        codebooks.append(solver.model.space_dict.detach().clone())
        towers.append(solver.model.visual.layers[0].blocks[0].attn.logit_scale.detach().clone())
        return out

    solver.train_step = spy
    solver.train()
    assert len(losses) == 6 and all(np.isfinite(losses))
    moved = [n for n, p in solver.model.named_parameters()
             if n.startswith("visual.layers.") and not torch.equal(p, before[n])]
    assert len(moved) == sum(1 for n in before if n.startswith("visual.layers."))
    # index k holds the state after step k + 1
    assert not torch.equal(codebooks[3], codebooks[2])
    assert torch.equal(codebooks[4], codebooks[3]) and torch.equal(towers[4], towers[3])
    assert not torch.equal(codebooks[5], codebooks[4]) and not torch.equal(towers[5], towers[4])


def test_v2_recipe_builds_the_published_tower():
    """The recipe's model block at its published widths (on the meta device):
    192 px, window 12, head width 32 in every stage, cosine attention in all
    24 blocks, a 1024-wide image query head over the 6 x 6 last-stage grid."""
    from iterated_learning_for_vlm_tpu_torch.utils.config import load_config

    recipe = load_config(str(ROOT / "configs" / "clip_fdt_swinv2_b_cc3m.yaml"))
    model = clip_fdt_swinB_v2(device="meta", **recipe.model.to_dict()["kwargs"])
    cfg = model.visual.cfg
    assert cfg.v2 and (cfg.input_resolution, cfg.window_size, cfg.embed_dim) == (192, 12, 128)
    assert all((128 << i) // h == 32 for i, h in enumerate(cfg.num_heads))
    blocks = [b for layer in model.visual.layers for b in layer.blocks]
    assert len(blocks) == 24 and all(isinstance(b.attn, swin.WindowAttentionV2) for b in blocks)
    assert model.img_query_model.ft_dim == model.visual.num_features == 1024
    assert round(sum(p.numel() for p in model.parameters()) / 1e6, 1) == PARAMS_M
