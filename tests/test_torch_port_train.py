"""PyTorch port vs the JAX package: the training slice.

Loss and metrics, schedules, weight decay and trainable masks, masked AdamW,
gradient clipping and logit-scale clamps, the weight bridge for training
state, the train step over 1 and 3 steps, the eval step and the IL engine,
each fed the same numpy inputs and weights on both sides (fp32 on the CPU;
the JAX Pallas kernels in interpret mode, jitted).

Tolerances are stated per test. The IL engine draws its random numbers from
torch generators, so its parity with JAX is structural: the same transitions,
the same parameters redrawn, their moments zeroed, the held codebook
bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from iterated_learning_for_vlm_tpu.models import model_entry as jax_model_entry
from iterated_learning_for_vlm_tpu.train import il as jil
from iterated_learning_for_vlm_tpu.train import loss as jloss
from iterated_learning_for_vlm_tpu.train import optim as joptim
from iterated_learning_for_vlm_tpu.train import schedule as jsched
from iterated_learning_for_vlm_tpu.train.step import make_eval_step as j_make_eval_step
from iterated_learning_for_vlm_tpu.train.step import make_train_step as j_make_train_step
from iterated_learning_for_vlm_tpu.train.train_state import TrainState as JTrainState
from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import (
    jax_path, load_jax_params, state_dict_from_jax_params,
)
from iterated_learning_for_vlm_tpu_torch.train import il, loss, optim, schedule
from iterated_learning_for_vlm_tpu_torch.train.step import make_eval_step, make_train_step
from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState
from test_torch_port_grads import UNREAD, noisy_params
from test_torch_port_slice import make_batch, small_cfg

LAYERS = {"visual": 2, "text": 2}  # the small model's tower depths
PCONFIG = {"ln_w": {"weight_decay": 0}, "ln_b": {"weight_decay": 0},
           "bias": {"weight_decay": 0}, "logit_scale": {"weight_decay": 0}}


@pytest.fixture(scope="module")
def jax_params():
    return noisy_params()


def bridged(tree):
    """A JAX tree with the params' structure -> {port name: np.ndarray}."""
    return state_dict_from_jax_params(tree, LAYERS)


def port_model(jax_params, fused=False):
    return load_jax_params(model_entry(small_cfg(fused), device="cpu"), jax_params)


def _np(x):
    return x.detach().cpu().float().numpy()


# -- loss ------------------------------------------------------------------------
def _unit(rng, n, d=8):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("case", ["random", "ties", "collapse"])
def test_info_nce_matches_jax(case):
    """Loss (atol 1e-6, fp32) and acc1/acc5 (exact). With ties the label
    ranks past every tied entry: under collapse both accuracies are 0."""
    rng = np.random.default_rng(3)
    img, txt = _unit(rng, 8), _unit(rng, 8)
    if case == "ties":
        txt[1] = txt[0]      # row 0 and row 1 tie on their labels
        txt[5] = img[5]
        txt[6] = img[5]      # row 5's label ties with column 6
    if case == "collapse":
        img[:] = img[0]
        txt[:] = img[0]
    want_loss, want_m = jloss.clip_info_nce(jnp.asarray(img), jnp.asarray(txt), 10.0,
                                            reference_scale=2.0)
    got_loss, got_m = loss.clip_info_nce(torch.from_numpy(img), torch.from_numpy(txt),
                                         torch.tensor(10.0), reference_scale=2.0)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=1e-6)
    for k in ("acc1", "acc5"):
        assert got_m[k].item() == float(want_m[k]), k
    if case == "collapse":
        assert got_m["acc1"].item() == 0.0 and got_m["acc5"].item() == 0.0


# -- schedules -------------------------------------------------------------------
@pytest.mark.parametrize("name,make,steps", [
    ("cosine", lambda m: m.cosine(5e-5, 5e-4, 0.0, 500, 80000, reset_steps=6000),
     [1, 2, 250, 499, 500, 501, 5999, 6000, 6001, 6499, 6500, 12000, 79999, 80000]),
    ("cosine_no_reset", lambda m: m.cosine(1e-4, 1e-3, 1e-5, 10, 100),
     [1, 9, 10, 11, 50, 99, 100]),
    ("cosine_negative_rewarm", lambda m: m.cosine(1e-4, 1e-2, 0.0, 3, 100, reset_steps=10),
     [1, 2, 3, 9, 10, 11, 12, 13, 100]),
    ("step", lambda m: m.step_schedule(1e-4, 1e-3, 5, [10, 20], [0.1, 0.5], 30),
     [1, 4, 5, 9, 10, 19, 20, 30]),
    ("step_decay", lambda m: m.step_decay(1e-4, 1e-3, 5, 7, 0.5, 50), [1, 4, 5, 11, 12, 50]),
    ("poly", lambda m: m.polynomial(1e-4, 1e-3, 5, 2.0, 50), [1, 4, 5, 20, 50]),
    ("cosine_epoch", lambda m: m.scheduler_entry(
        {"type": "CosineEpoch", "kwargs": {"base_lr": 1e-4, "warmup_lr": 1e-3, "min_lr": 0.0,
                                           "warmup_epoch": 0.5, "max_epoch": 10,
                                           "max_iter": 200, "last_iter": -1}}),
     [1, 9, 10, 11, 100, 200]),
    ("step_epoch", lambda m: m.scheduler_entry(
        {"type": "StepEpoch", "kwargs": {"base_lr": 1e-4, "warmup_lr": 1e-3, "warmup_epoch": 1,
                                         "lr_epochs": [3, 6], "lr_mults": [0.1, 0.1],
                                         "max_epoch": 10, "max_iter": 100}}),
     [1, 9, 10, 29, 30, 60, 100]),
])
def test_schedules_match_jax(name, make, steps):
    """At the boundaries: warmup, the IL re-warm at reset_steps, max_iter.
    rtol 1e-5 + atol 1e-10: JAX evaluates in fp32, the port in float64."""
    want_fn, got_fn = make(jsched), make(schedule)
    for step in steps:
        want, got = float(want_fn(jnp.asarray(step))), got_fn(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10, err_msg=f"{name} {step}")


# -- weight decay, trainable masks, the weight bridge -----------------------------
def test_weight_decay_matches_jax(jax_params):
    """Every port parameter's decay equals JAX ``build_wd_tree`` on its JAX
    path; a rule on the port's own names would decay the query heads'
    LayerNorms (``q_map.0`` / ``q_map.3``)."""
    params = dict(port_model(jax_params).named_parameters())
    want = bridged(joptim.build_wd_tree(jax_params, 0.1, PCONFIG))
    got = optim.build_wd_tree(params, 0.1, PCONFIG)
    assert set(got) == set(want) == set(params)
    for name in params:  # the bridge carries JAX's decays as fp32
        assert np.float32(got[name]) == want[name], name
    assert got["img_query_model.q_map.0.weight"] == 0.0
    assert got["txt_query_model.q_map.3.bias"] == 0.0
    assert got["space_dict"] == 0.1 and got["logit_scale_sd"] == 0.0


@pytest.mark.parametrize("groups", [frozenset(), frozenset({"vision"}),
                                    frozenset({"text", "codebook", "logit_scale"})])
def test_trainable_mask_matches_jax(jax_params, groups):
    params = dict(port_model(jax_params).named_parameters())
    want = bridged(joptim.trainable_mask_tree(jax_params, groups))
    got = optim.trainable_mask_tree(params, groups)
    assert {n: bool(v) for n, v in want.items()} == got
    assert not got["visual.conv1.weight"]


def test_bridge_carries_grads_and_adamw_state(jax_params):
    """Gradients and the AdamW ``mu`` / ``nu`` / ``count`` trees cross into the
    port's names and layouts: the packed ``in_proj`` kernel is transposed, a
    layer-stacked leaf splits per layer, and the per-leaf scalar count goes
    to every layer, which needs the tower depths."""
    params = dict(port_model(jax_params).named_parameters())
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jax_params)
    state = joptim.adamw_init(jax_params)
    state["count"] = jax.tree.map(lambda c: c + 3.0, state["count"])
    g = bridged(grads)
    for name, p in params.items():
        assert g[name].shape == tuple(p.shape), name
    stacked = grads["visual"]["transformer"]["resblocks"]["attn"]["in_proj"]["kernel"]
    np.testing.assert_array_equal(g["visual.transformer.resblocks.1.attn.in_proj_weight"],
                                  np.asarray(stacked[1]).T)
    for key in ("mu", "nu"):
        assert {n: a.shape for n, a in bridged(state[key]).items()} == {
            n: tuple(p.shape) for n, p in params.items()}
    counts = bridged(state["count"])
    assert set(counts) == set(params) and all(c.shape == () and c == 3.0
                                              for c in counts.values())
    with pytest.raises(KeyError, match="layers"):
        state_dict_from_jax_params(state["count"])
    assert all(jax_path(n) in traverse_util.flatten_dict(jax_params) for n in params
               if ".resblocks." not in n)


# -- masked AdamW ----------------------------------------------------------------
def _port_state(opt_state_jax):
    mu, nu, count = (bridged(opt_state_jax[k]) for k in ("mu", "nu", "count"))
    return {"mu": {n: torch.from_numpy(a) for n, a in mu.items()},
            "nu": {n: torch.from_numpy(a) for n, a in nu.items()},
            "count": {n: float(c) for n, c in count.items()}}


def test_adamw_update_matches_jax(jax_params):
    """Three steps with used, unused (no gradient) and frozen (vision, conv1)
    parameters. The gradients are given, so both sides do the same fp32
    arithmetic: params, mu and nu within 1e-6 relative plus a few fp32 ulps
    of the O(1) values summed (JAX forms the bias corrections in fp32, the
    port in float64, and either may fuse a multiply-add), counts exact. Unused
    parameters decay by lr * wd and advance their count; frozen ones do not
    move at all."""
    params = {n: torch.from_numpy(a).clone()
              for n, a in bridged(jax_params).items()}
    wd_j = joptim.build_wd_tree(jax_params, 0.1, PCONFIG)
    wd = optim.build_wd_tree(params, 0.1, PCONFIG)
    frozen = frozenset({"vision"})
    trainable_j = joptim.trainable_mask_tree(jax_params, frozen)
    trainable = optim.trainable_mask_tree(params, frozen)
    state_j = joptim.adamw_init(jax_params)
    state = optim.adamw_init(params)
    p_j = jax.tree.map(jnp.asarray, jax_params)
    p0 = {n: p.clone() for n, p in params.items()}
    update_j = jax.jit(joptim.adamw_update)
    rng = np.random.default_rng(9)
    for it, lr in enumerate((1e-3, 2e-3, 5e-4)):
        grads_j = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                               jax_params)
        unread = {jax_path(n) for n in params if n.startswith(UNREAD)}
        grads_j = traverse_util.unflatten_dict({
            k: (np.zeros_like(v) if k in unread else v)
            for k, v in traverse_util.flatten_dict(grads_j).items()})
        grads = {n: None if n.startswith(UNREAD) else torch.from_numpy(a)
                 for n, a in bridged(grads_j).items()}
        p_j, state_j = update_j(grads_j, state_j, p_j, lr=jnp.float32(lr), wd_tree=wd_j,
                                trainable=trainable_j)
        classes, values = optim.adamw_scalars(state, params, trainable, lr)
        optim.adamw_update(grads, state, params, lr=torch.tensor(values, dtype=torch.float32),
                           classes=classes, wd_tree=wd, trainable=trainable)
    want_p, want = bridged(p_j), _port_state(state_j)
    for name, p in params.items():
        np.testing.assert_allclose(_np(p), want_p[name], rtol=1e-6, atol=3e-8, err_msg=name)
        for key in ("mu", "nu"):
            np.testing.assert_allclose(_np(state[key][name]), _np(want[key][name]),
                                       rtol=1e-6, atol=3e-8, err_msg=f"{key} {name}")
        assert state["count"][name] == want["count"][name], name
    assert state["count"]["visual.proj"] == 0.0 and torch.equal(
        params["visual.transformer.resblocks.0.mlp.c_fc.weight"],
        p0["visual.transformer.resblocks.0.mlp.c_fc.weight"])
    unused = "encode_text.text_projection.weight"
    assert state["count"][unused] == 3.0 and not torch.equal(params[unused], p0[unused])


# -- clipping and clamps ---------------------------------------------------------
@pytest.mark.parametrize("mode,value", [("norm", 0.5), ("norm", 1e6), ("value", 0.01),
                                        ("logit_scale_grad", 0.01), ("none", 1.0)])
def test_clip_grads_matches_jax(jax_params, mode, value):
    """Every mode, with the vision tower frozen: its gradients still count in
    the global norm (as in JAX, where the mask only gates the update).
    Missing gradients count as zeros. rtol 1e-6: one fp32 norm in another
    summation order."""
    rng = np.random.default_rng(11)
    grads_j = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                           jax_params)
    grads_j["visual"]["ln_post"] = jax.tree.map(np.zeros_like, grads_j["visual"]["ln_post"])
    want = bridged(joptim.clip_grads(jax.tree.map(jnp.asarray, grads_j), mode, value))
    grads = {n: torch.from_numpy(a).clone() for n, a in bridged(grads_j).items()}
    grads["visual.ln_post.weight"] = grads["visual.ln_post.bias"] = None
    optim.clip_grads(grads, mode, value)
    for name, g in grads.items():
        if g is None:
            assert np.all(want[name] == 0)
            continue
        np.testing.assert_allclose(_np(g), want[name], rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("mode", ["logit_scale_param_value", "logit_scale_param_abs_min",
                                  "norm"])
@pytest.mark.parametrize("start", [1.0, 4.0, 8.0])
def test_clamp_logit_scale_matches_jax(mode, start):
    """Only ``logit_scale`` is clamped, never ``logit_scale_sd``."""
    params_j = {"logit_scale": jnp.full((1,), start), "logit_scale_sd": jnp.full((1,), start)}
    want = joptim.clamp_logit_scale(params_j, mode, 3.0, 6.0)
    params = {"logit_scale": torch.full((1,), start), "logit_scale_sd": torch.full((1,), start)}
    optim.clamp_logit_scale(params, mode, 3.0, 6.0)
    for name in params:
        assert params[name].item() == float(want[name][0]), name
    assert params["logit_scale_sd"].item() == start


# -- the train step ----------------------------------------------------------------
def _schedule(m):
    """Warmup to 1e-4 in 3 steps: gentle enough that the AdamW sign flips
    below stay out of the loss's fifth digit."""
    return m.cosine(1e-5, 1e-4, 0.0, 3, 100, reset_steps=0)


def _jax_run(jax_params, fused, clip, batch, steps, frozen=frozenset()):
    model = jax_model_entry(small_cfg(fused))
    params = jax.tree.map(jnp.asarray, jax_params)
    state = JTrainState.create(params, joptim.adamw_init(params),
                               joptim.trainable_mask_tree(params, frozen),
                               params["space_dict"])
    step = j_make_train_step(model, _schedule(jsched), joptim.build_wd_tree(params, 0.1, PCONFIG),
                             is_fdt=True, grad_clip_type=clip, grad_clip_value=3.0,
                             grad_clip_max_value=6.0, donate=False)
    jb = {"image": jnp.asarray(batch[0]), "tokens": jnp.asarray(batch[1]),
          "pad_mask": jnp.asarray(batch[2])}
    metrics, snaps = [], {}
    for i in range(1, steps + 1):
        state, m = step(state, jb, jnp.float32(0.5))
        metrics.append({k: float(v) for k, v in m.items()})
        snaps[i] = state
    return metrics, snaps


def _port_run(jax_params, fused, clip, batch, steps, frozen=frozenset()):
    model = port_model(jax_params, fused)
    params = dict(model.named_parameters())
    state = TrainState.create(params, optim.adamw_init(params),
                              optim.trainable_mask_tree(params, frozen), params["space_dict"])
    step = make_train_step(model, _schedule(schedule), optim.build_wd_tree(params, 0.1, PCONFIG),
                           is_fdt=True, grad_clip_type=clip, grad_clip_value=3.0,
                           grad_clip_max_value=6.0)
    tb = {"image": torch.from_numpy(batch[0]), "tokens": torch.from_numpy(batch[1]).long(),
          "pad_mask": torch.from_numpy(batch[2])}
    metrics, snaps = [], {}
    for i in range(1, steps + 1):
        m = step(state, tb, 0.5)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps[i] = ({n: p.detach().clone() for n, p in params.items()},
                    {k: {n: (v.clone() if torch.is_tensor(v) else v) for n, v in d.items()}
                     for k, d in state.opt_state.items()}, state.ema_buffer.item())
    return model, metrics, snaps


@pytest.mark.parametrize("fused,clip", [
    (True, "logit_scale_param_value"),
    (False, "logit_scale_param_value"),
    (False, "logit_scale_param_ema"),
    (True, "norm"),
])
def test_train_step_matches_jax(jax_params, fused, clip):
    """1 and 3 steps of ``make_train_step`` from the same params and batch.

    Tolerances. Loss atol 1e-5 and equal accuracies (fp32 noise, and from
    step 2 the flips below, at this small lr). mu and the gradients
    it holds: atol 2e-5 + 1e-3 max|mu| per parameter, nu twice that
    relative (it is quadratic in g): the gradient tolerance of
    test_model_gradients_match_jax. Params: AdamW moves an element by about
    lr * sign(g) on its first step, so an element whose gradient is within
    noise of 0 may move the other way (the key block of ``in_proj_bias``
    has an analytically zero gradient, so its 64 elements per layer do).
    Such an element is one whose JAX mu, at any step so far, is within
    1e-5 of its leaf's largest |mu| (the ones that flip lie below 5e-7) and
    is not exactly 0 on both sides (then neither side moves it): it is held
    at atol 2 * (sum of the lrs so far) + 1e-7. Every other element (over
    99% of them) is held at 5e-2 * (sum of the lrs) + 1e-7, the 1e-7 for
    fp32 rounding of the params, so a step that leaves the parameters where
    they were, or uses another lr, fails. Counts exact; the logit scale, the EMA buffer and the held-off leaves'
    decay as the params."""
    batch = make_batch(8, 4)
    want_m, want_s = _jax_run(jax_params, fused, clip, batch, 3)
    _, got_m, got_s = _port_run(jax_params, fused, clip, batch, 3)
    for w, g in zip(want_m, got_m):
        assert abs(g["loss"] - w["loss"]) <= 1e-5
        assert (g["acc1"], g["acc5"]) == (w["acc1"], w["acc5"])
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        np.testing.assert_allclose(g["logit_scale"], w["logit_scale"], atol=1e-5)
    near_zero = {}  # name -> elements whose JAX mu was within noise of 0 at some step
    for step in (1, 2, 3):
        for name, mu_w in bridged(want_s[step].opt_state["mu"]).items():
            both_zero = (mu_w == 0) & (_np(got_s[step][1]["mu"][name]) == 0)
            near_zero[name] = (near_zero.get(name, False)
                               | ((np.abs(mu_w) <= 1e-5 * np.abs(mu_w).max()) & ~both_zero))
        if step == 2:
            continue
        params, opt, ema = got_s[step]
        want_p = bridged(want_s[step].params)
        want_opt = {k: bridged(want_s[step].opt_state[k]) for k in ("mu", "nu", "count")}
        lr_sum = sum(m["lr"] for m in want_m[:step])
        held_tight = total = 0
        for name, p in params.items():
            err = np.abs(_np(p) - want_p[name])
            tol = np.where(near_zero[name], 2 * lr_sum, 5e-2 * lr_sum) + 1e-7
            assert np.all(err <= tol), f"step {step} {name}: max err / lr_sum {err.max() / lr_sum}"
            held_tight += int((~near_zero[name]).sum())
            total += err.size
            mu_w, nu_w = want_opt["mu"][name], want_opt["nu"][name]
            np.testing.assert_allclose(_np(opt["mu"][name]), mu_w,
                                       atol=2e-5 + 1e-3 * np.abs(mu_w).max(), err_msg=name)
            np.testing.assert_allclose(_np(opt["nu"][name]), nu_w,
                                       atol=1e-9 + 2e-3 * np.abs(nu_w).max(), err_msg=name)
            assert opt["count"][name] == float(want_opt["count"][name]), name
        np.testing.assert_allclose(ema, float(want_s[step].ema_buffer), atol=1e-5)
        assert held_tight >= 0.99 * total  # the tight bound covers the model
    assert got_s[3][1]["count"]["visual.proj"] == 3.0  # never read, still stepped


def test_eval_step_matches_jax(jax_params):
    """Normalised embeddings of ``make_eval_step``; atol 1e-4 as the slice."""
    batch = make_batch(10, 3)
    want = j_make_eval_step(jax_model_entry(small_cfg(True)), is_fdt=True)(
        jax.tree.map(jnp.asarray, jax_params),
        {"image": jnp.asarray(batch[0]), "tokens": jnp.asarray(batch[1]),
         "pad_mask": jnp.asarray(batch[2])})
    got = make_eval_step(port_model(jax_params, True), is_fdt=True)(
        {"image": torch.from_numpy(batch[0]), "tokens": torch.from_numpy(batch[1]).long(),
         "pad_mask": torch.from_numpy(batch[2])})
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4)


def test_unported_step_options_raise(jax_params):
    model = port_model(jax_params)
    with pytest.raises(NotImplementedError):
        make_train_step(model, _schedule(schedule), {}, is_fdt=True, lipreg_lambda=0.1)
    with pytest.raises(NotImplementedError):
        make_train_step(model, _schedule(schedule), {}, is_fdt=True, spectral_norm=True)
    with pytest.raises(NotImplementedError):
        optim.adamw_init(dict(model.named_parameters()), torch.bfloat16)
    params = dict(model.named_parameters())
    with pytest.raises(NotImplementedError):
        TrainState.create(params, {}, {}, batch_stats={})
    with pytest.raises(NotImplementedError):
        _ = TrainState.create(params, {}, {}).spectral_u


# -- the IL engine -----------------------------------------------------------------
def _port_il(jax_params, cfg, fused=False):
    model = port_model(jax_params, fused)
    params = dict(model.named_parameters())
    state = TrainState.create(params, optim.adamw_init(params),
                              optim.trainable_mask_tree(params), params["space_dict"])
    for name in params:  # live moments, so zeroing shows
        state.opt_state["mu"][name].fill_(0.5)
        state.opt_state["count"][name] = 7.0
    return model, params, state, il.ILController(cfg, seed=0, model=model)


def test_on_step_transitions_match_jax(jax_params):
    """A toy schedule (reset every 3 steps, smooth 1, 3 resets): after each
    step the hold flag and the trainable flags equal JAX's."""
    cfg = dict(reset_steps=3, smooth_steps=1, reset_nums=3)
    params_j = jax.tree.map(jnp.asarray, jax_params)
    state_j = JTrainState.create(params_j, joptim.adamw_init(params_j),
                                 joptim.trainable_mask_tree(params_j), params_j["space_dict"])
    ctl_j = jil.ILController(jil.ResetConfig(**cfg), jax.random.PRNGKey(0))
    _, params, state, ctl = _port_il(jax_params, il.ResetConfig(**cfg))
    seen = set()
    for step in range(1, 11):
        state_j = ctl_j.on_step(state_j, step)
        state = ctl.on_step(state, step)
        assert state.hold_codebook == bool(state_j.hold_codebook), step
        assert state.trainable == {n: bool(v) for n, v in
                                   bridged(state_j.trainable).items()}, step
        seen.add((state.hold_codebook, state.trainable["visual.proj"]))
    assert seen == {(False, True), (True, False)}
    assert not state.hold_codebook and all(
        v for n, v in state.trainable.items() if n != "visual.conv1.weight")


@pytest.mark.parametrize("roots,what", [("text", "text"), ("vision", "vision")])
def test_reset_redraws_the_reference_leaves(jax_params, roots, what):
    """The reference reset redraws the same parameters as JAX
    ``weight_reset_tree`` (by bridged name), zeroes their moments and counts,
    and leaves everything else bit-equal. LayerNorms go to (1, 0), Linears
    and conv1 within U(+-1/sqrt(fan_in)); the draw is a function of (seed,
    step) alone."""
    jroots = jil.TEXT_ROOTS if roots == "text" else jil.VISION_ROOTS
    _, mask_j = jil.weight_reset_tree(jax.tree.map(jnp.asarray, jax_params), jroots,
                                      jax.random.PRNGKey(0))
    want = {n for n, v in bridged(mask_j).items() if v}
    _, params, state, ctl = _port_il(jax_params, il.ResetConfig())
    before = {n: p.detach().clone() for n, p in params.items()}
    reset = ctl.reset_text_encoder if roots == "text" else ctl.reset_vision_encoder
    reset(state, 12)
    changed = {n for n, p in params.items() if not torch.equal(p, before[n])}
    assert changed == want
    assert any(".ln_" in n for n in want) and any(".c_fc." in n for n in want)
    assert not any("in_proj" in n or "embedding" in n for n in want)
    for name, p in params.items():
        zeroed = name in want
        assert (state.opt_state["count"][name] == 0.0) == zeroed, name
        assert bool(torch.all(state.opt_state["mu"][name] == 0)) == zeroed, name
        if zeroed and p.dim() > 1:
            bound = 1.0 / np.sqrt(np.prod(p.shape[1:]))
            assert p.abs().max().item() <= bound and p.std().item() > 0.3 * bound, name
    ln = "encode_text.ln_final" if roots == "text" else "visual.ln_pre"
    assert torch.all(params[ln + ".weight"] == 1) and torch.all(params[ln + ".bias"] == 0)
    again = _port_il(jax_params, il.ResetConfig())
    (again[3].reset_text_encoder if roots == "text" else again[3].reset_vision_encoder)(
        again[2], 12)
    assert all(torch.equal(params[n], again[1][n]) for n in want)


def test_full_reset_takes_fresh_params(jax_params):
    """``semantics="full"``: every text parameter from ``init_fn``'s model."""
    def init_fn(generator):
        return model_entry(small_cfg(False), device="cpu", generator=generator).state_dict()

    cfg = il.ResetConfig(semantics="full")
    model, params, state, _ = _port_il(jax_params, cfg)
    ctl = il.ILController(cfg, seed=0, model=model, init_fn=init_fn)
    before = {n: p.detach().clone() for n, p in params.items()}
    ctl.reset_text_encoder(state, 3)
    for name, p in params.items():
        text = jax_path(name)[0] in optim.TEXT_ROOTS
        assert (state.opt_state["count"][name] == 0.0) == text, name
        if not text:
            assert torch.equal(p, before[name]), name
    assert not torch.equal(params["encode_text.token_embedding.weight"],
                           before["encode_text.token_embedding.weight"])


def test_hold_and_freeze_through_steps(jax_params):
    """``ResetConfig(reset_steps=2, smooth_steps=1, reset_nums=3)``: the reset
    after step 4 holds the codebook; after step 5 it is bit-equal to the
    snapshot although it stays trainable (its moments and count advance), and
    the frozen vision tower does not move at all. After step 6 the window
    is over and nothing is held or frozen."""
    model, params, state, ctl = _port_il(
        jax_params, il.ResetConfig(reset_steps=2, smooth_steps=1, reset_nums=3), fused=True)
    step = make_train_step(model, _schedule(schedule), optim.build_wd_tree(params, 0.1, PCONFIG),
                           is_fdt=True)
    batch = make_batch(12, 3)
    tb = {"image": torch.from_numpy(batch[0]), "tokens": torch.from_numpy(batch[1]).long(),
          "pad_mask": torch.from_numpy(batch[2])}
    for i in (1, 2, 3, 4):
        step(state, tb, 0.5)
        state = ctl.on_step(state, i)
    assert state.hold_codebook and not state.trainable["visual.proj"]
    snapshot = state.stored_codebook.clone()
    assert torch.equal(snapshot, params["space_dict"])
    assert snapshot.data_ptr() != params["space_dict"].data_ptr()
    vision = {n: p.detach().clone() for n, p in params.items()
              if jax_path(n)[0] in optim.VISION_ROOTS}
    count_sd = state.opt_state["count"]["space_dict"]
    text_before = params["encode_text.ln_final.bias"].detach().clone()
    step(state, tb, 0.5)
    assert torch.equal(params["space_dict"], snapshot)
    assert state.opt_state["count"]["space_dict"] == count_sd + 1
    assert all(torch.equal(params[n], v) for n, v in vision.items())
    assert not torch.equal(params["encode_text.ln_final.bias"], text_before)
    state = ctl.on_step(state, 5)
    step(state, tb, 0.5)
    state = ctl.on_step(state, 6)
    assert not state.hold_codebook
    assert all(v for n, v in state.trainable.items() if n != "visual.conv1.weight")


def test_swap_vision_and_reset_codebook(jax_params):
    """The first swap resets the vision tower and stores the old one; the
    second swap brings the old one back. ``reset_codebook`` redraws
    ``space_dict`` from N(0, 1), seeded by the step."""
    _, params, state, ctl = _port_il(jax_params, il.ResetConfig())
    name = "visual.transformer.resblocks.0.mlp.c_fc.weight"
    first = params[name].detach().clone()
    ctl.swap_vision_encoder(state, 5)
    assert not torch.equal(params[name], first)
    ctl.swap_vision_encoder(state, 6)
    assert torch.equal(params[name], first)
    ctl.reset_codebook(state, 5)
    a = params["space_dict"].detach().clone()
    ctl.reset_codebook(state, 5)
    assert torch.equal(params["space_dict"], a)
    assert abs(a.std().item() - 1.0) < 0.1
