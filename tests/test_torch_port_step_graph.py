"""The train step's host half and its graph key, on the CPU.

On the card ``make_train_step`` replays each key's step as a CUDA graph
(``train/step.py``); what that needs of the host is held here: AdamW reads
``lr`` and its bias corrections from a tensor and gives, bit for bit, what
the Python scalars gave; the counts stay host floats and a checkpoint
carries them as before; the graph key changes on each of its parts and not
on an in-place update; the EMA clamp updates its tensors in place; a CPU
step never captures. ``tests/test_torch_port_gpu.py`` holds the replays
against eager steps on the card. This file imports no JAX.
"""
import copy

import pytest
import torch

from iterated_learning_for_vlm_tpu_torch.models import model_entry
from iterated_learning_for_vlm_tpu_torch.tools.torch_checkpoint import jax_path
from iterated_learning_for_vlm_tpu_torch.train import optim
from iterated_learning_for_vlm_tpu_torch.train.checkpoint import (checkpoint_dict,
                                                                  restore_checkpoint)
from iterated_learning_for_vlm_tpu_torch.train.loss import clip_info_nce
from iterated_learning_for_vlm_tpu_torch.train.step import graph_key, make_train_step
from iterated_learning_for_vlm_tpu_torch.train.train_state import TrainState
from torch_port_graph_stub import stub_graphs  # noqa: F401 (fixture)

CTX, VOCAB = 16, 300


def tiny_fdt(seed=0):
    """A one-layer float32 CLIP-FDT of width 64 at 32 px (4 patches)."""
    cfg = {"type": "clip_fdt_vitb32", "kwargs": {
        "image_encode": {"input_resolution": 32, "patch_size": 16, "width": 64, "layers": 1,
                         "heads": 1, "embed_dim": 64},
        "text_encode": {"context_length": CTX, "vocab_size": VOCAB, "width": 64, "heads": 1,
                        "layers": 1, "embed_dim": 64},
        "fdt": {"sd_num": 32, "sd_dim": 64, "raw_img_ft_dim": 64, "raw_txt_ft_dim": 64,
                "sd_temperature": 2.0}}}
    return model_entry(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def batch(seed, n=4, ctx=CTX):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, VOCAB - 2, (n, ctx), generator=g)
    tokens[:, 6] = VOCAB - 1
    tokens[:, 7:] = 0
    pad = torch.zeros(n, ctx)
    pad[:, 7:] = float("-inf")
    return {"image": torch.randn(n, 32, 32, 3, generator=g), "tokens": tokens, "pad_mask": pad}


def fresh_state(model):
    params = dict(model.named_parameters())
    return TrainState.create(params, optim.adamw_init(params), optim.trainable_mask_tree(params),
                             params["space_dict"])


def make_step(model, clip_type="logit_scale_param_value"):
    params = dict(model.named_parameters())
    return make_train_step(model, lambda s: 1e-3 * s / (s + 3.0),
                           optim.build_wd_tree(params, 0.1, {}), is_fdt=True,
                           grad_clip_type=clip_type)


def python_scalar_adamw(grads, state, params, *, lr, wd_tree, trainable, b1=0.9, b2=0.98,
                        eps=1e-8):
    """AdamW as the port ran it before the step read its scalars from a
    tensor: Python floats for ``lr`` and the bias corrections, a fresh
    ``zeros_like`` for a missing gradient."""
    names = [n for n in params if trainable[n]]
    ps = [params[n] for n in names]
    gs = [torch.zeros_like(params[n]) if grads.get(n) is None else grads[n].float()
          for n in names]
    mus = [state["mu"][n] for n in names]
    nus = [state["nu"][n] for n in names]
    for n in names:
        state["count"][n] += 1.0
    counts = [state["count"][n] for n in names]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, gs, alpha=1 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
    denom = torch._foreach_div(nus, [1 - b2 ** c for c in counts])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(mus, [1 - b1 ** c for c in counts])
    torch._foreach_div_(step, denom)
    torch._foreach_add_(step, torch._foreach_mul(ps, [wd_tree[n] for n in names]))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(ps, step)


def real_grads(model, seed):
    """The InfoNCE gradients of one batch: None for the parameters the FDT
    forward never reads."""
    model.zero_grad(set_to_none=True)
    b = batch(seed)
    out = model(b["image"], b["tokens"], b["pad_mask"], sd_temperature=2.0)
    clip_info_nce(out["image_embed"], out["text_embed"], out["logit_scale"])[0].backward()
    grads = {n: None if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def _text(name):
    return jax_path(name)[0] in optim.TEXT_ROOTS


@pytest.mark.parametrize("case", ["trainable", "vision_frozen", "text_counts_reset"])
def test_tensor_scalar_adamw_is_the_python_scalar_adamw(case):
    """Four updates from real gradients: the tensor-scalar AdamW gives the
    Python-scalar one's parameters, moments and counts bit for bit, with
    ``conv1`` frozen, the never-read parameters stepping on zero gradients,
    and (per case) the vision tower frozen or the text counts zeroed by an IL
    reset, so that the counts fall into two classes."""
    model = tiny_fdt()
    params = dict(model.named_parameters())
    frozen = {"vision"} if case == "vision_frozen" else set()
    trainable = optim.trainable_mask_tree(params, frozenset(frozen))
    assert not trainable["visual.conv1.weight"]
    wd = optim.build_wd_tree(params, 0.1, {})
    state = optim.adamw_init(params)
    for n in params:
        state["count"][n] = 5.0
        state["mu"][n].normal_(0, 1e-3, generator=torch.Generator().manual_seed(1))
        state["nu"][n].uniform_(0, 1e-6, generator=torch.Generator().manual_seed(2))
    if case == "text_counts_reset":
        optim.reset_opt_state_for(state, {n: _text(n) for n in params})
    got_p = {n: p.detach().clone() for n, p in params.items()}
    want_p = {n: p.detach().clone() for n, p in params.items()}
    got_s, want_s = copy.deepcopy(state), copy.deepcopy(state)
    zeros = {}
    for k in range(4):
        grads = real_grads(model, seed=10 + k)
        assert grads["visual.proj"] is None and grads["logit_scale_sd"] is None
        lr = 1e-3 * (k + 1) / 7.0
        python_scalar_adamw(grads, want_s, want_p, lr=lr, wd_tree=wd, trainable=trainable)
        classes, values = optim.adamw_scalars(got_s, got_p, trainable, lr)
        assert len(classes) == (2 if case == "text_counts_reset" else 1)
        optim.adamw_update(grads, got_s, got_p, lr=torch.tensor(values, dtype=torch.float32),
                           wd_tree=wd, trainable=trainable, classes=classes, zeros=zeros)
        for n in params:
            for got, want in ((got_p[n], want_p[n]), (got_s["mu"][n], want_s["mu"][n]),
                              (got_s["nu"][n], want_s["nu"][n])):
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (k, n)
        assert got_s["count"] == want_s["count"]
    assert set(zeros) == {n for n in params if trainable[n] and grads[n] is None}
    assert all(not z.any() for z in zeros.values())
    for n in params:
        if not trainable[n]:
            assert torch.equal(got_p[n], params[n]) and got_s["count"][n] == state["count"][n]


def test_counts_stay_host_floats_and_a_checkpoint_round_trips():
    """After three steps the counts are host floats (conv1's still 0); a
    checkpoint restored into a fresh model and state carries every tensor,
    count and flag, and the two then take the same next step bit for bit."""
    model = tiny_fdt()
    state, step = fresh_state(model), make_step(model)
    for k in range(3):
        step(state, batch(k), 2.0)
    counts = state.opt_state["count"]
    assert all(type(c) is float for c in counts.values())
    assert counts["visual.conv1.weight"] == 0.0 and counts["visual.proj"] == 3.0
    ckpt = copy.deepcopy(checkpoint_dict(model, state, state.step))
    other = tiny_fdt(seed=5)
    restored = restore_checkpoint(ckpt, other, fresh_state(other))
    assert restored.step == 3 and restored.opt_state["count"] == counts
    assert all(type(c) is float for c in restored.opt_state["count"].values())
    a = step(state, batch(7), 2.0)
    b = make_step(other)(restored, batch(7), 2.0)
    assert torch.equal(a["loss"], b["loss"]) and a["lr"] == b["lr"]
    for (n, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.opt_state["mu"][n], restored.opt_state["mu"][n]), n
    assert state.opt_state["count"] == restored.opt_state["count"]


def _key(state, b, temperature):
    """The step's graph key for this state and batch (the counts as they were)."""
    counts = dict(state.opt_state["count"])
    classes, _ = optim.adamw_scalars(state.opt_state, list(state.opt_state["count"]),
                                     state.trainable, 0.0)
    state.opt_state["count"] = counts
    inputs = {k: b[k] for k in ("image", "tokens", "pad_mask")}
    return graph_key(state, inputs, temperature, classes)


def _rebind_codebook(state, model):
    state.stored_codebook = state.stored_codebook.clone()


def _freeze_vision(state, model):
    state.trainable = optim.trainable_mask_tree(dict(model.named_parameters()),
                                                frozenset({"vision"}))


def _reset_text_counts(state, model):
    optim.reset_opt_state_for(state.opt_state,
                              {n: _text(n) for n, _ in model.named_parameters()})


def _new_opt_state(state, model):
    state.opt_state = optim.adamw_init(dict(model.named_parameters()))


def _rebind_ema(state, model):
    state.ema_buffer = state.ema_buffer.clone()


CHANGES = {
    "context": lambda state, model: None,
    "trainable": _freeze_vision,
    "hold": lambda state, model: setattr(state, "hold_codebook", True),
    "stored_codebook": _rebind_codebook,
    "temperature": lambda state, model: None,
    "opt_state": _new_opt_state,
    "count_classes": _reset_text_counts,
    "ema_buffer": _rebind_ema,
}


@pytest.mark.parametrize("part", sorted(CHANGES))
def test_graph_key_changes_on_each_part(part):
    model = tiny_fdt()
    state = fresh_state(model)
    make_step(model)(state, batch(0), 2.0)  # counts at 1, conv1's at 0
    before = _key(state, batch(0), 2.0)
    CHANGES[part](state, model)
    b = batch(0, ctx=8) if part == "context" else batch(0)
    assert _key(state, b, 1.0 if part == "temperature" else 2.0) != before


def test_graph_key_ignores_in_place_updates():
    """A step's in-place updates (parameters, moments, the EMA tensors, the
    snapshot's values), the step count and another batch of the same shapes
    leave the key as it was."""
    model = tiny_fdt()
    state = fresh_state(model)
    step = make_step(model)
    step(state, batch(0), 2.0)
    before = _key(state, batch(0), 2.0)
    step(state, batch(1), 2.0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        state.stored_codebook.mul_(2.0)
        state.ema_buffer.add_(1.0)
    assert _key(state, batch(2), 2.0) == before


def test_ema_clamp_updates_its_tensors_in_place():
    """The ``logit_scale_param_ema`` clamp writes the EMA buffer and the clip
    count where the next step reads them: the buffer takes the out-of-place
    formula's value each step, and the count the one clamp of the first."""
    model = tiny_fdt()
    state = fresh_state(model)
    step = make_step(model, clip_type="logit_scale_param_ema")
    ls = dict(model.named_parameters())["logit_scale"]
    with torch.no_grad():
        ls.fill_(10.0)  # 6.875 above the buffer: the first step's clamp bites
    buf, count = state.ema_buffer, state.ema_clip_count
    for k in range(3):
        want = 0.9 * buf.clone()
        step(state, batch(k), 2.0)
        assert state.ema_buffer is buf and state.ema_clip_count is count
        assert torch.equal(buf, want + 0.1 * ls.detach().mean()), k
    assert count.item() == ls.numel()


def _graph_counts(step):
    return step.graphs.eager, step.graphs.captures, step.graphs.replays


def test_cpu_step_never_captures():
    """On the CPU every call runs eagerly, spans unchanged: the cache's
    ``eager`` counts them all."""
    model = tiny_fdt()
    state, step = fresh_state(model), make_step(model)
    for k in range(3):
        metrics = step(state, batch(k), 2.0)
    assert _graph_counts(step) == (3, 0, 0)
    assert state.step == 3 and set(metrics) == {"loss", "lr", "logit_scale", "acc1", "acc5"}


def test_step_graph_eager_capture_replay(stub_graphs):
    """Through the CPU stand-in of a graph: a key's first call runs eagerly,
    its second captures, the rest replay, and the five steps give the
    losses, parameters and moments of five eager steps (each a fresh step
    function's first call) bit for bit."""
    model, plain = tiny_fdt(), tiny_fdt()
    state, step = fresh_state(model), make_step(model)
    state_p = fresh_state(plain)
    modes = []
    for k in range(5):
        got, want = step(state, batch(k), 2.0), make_step(plain)(state_p, batch(k), 2.0)
        modes.append(step.graphs.mode)
        assert torch.equal(got["loss"], want["loss"]) and got["lr"] == want["lr"], k
    assert modes == ["eager", "capture", "replay", "replay", "replay"]
    assert _graph_counts(step) == (1, 1, 3) and len(stub_graphs) == 1
    for (n, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.opt_state["nu"][n], state_p.opt_state["nu"][n]), n
    assert state.opt_state["count"] == state_p.opt_state["count"]


def test_step_graph_spans(stub_graphs):
    """``train.step`` holds ``train.forward``, ``train.backward`` and
    ``train.update`` when it runs eagerly or captures, ``train.replay`` when
    it replays (the spans ``step_replay_share.train`` reads)."""
    from torch.profiler import ProfilerActivity, profile

    from iterated_learning_for_vlm_tpu_torch.utils import profiling

    model = tiny_fdt()
    state, step = fresh_state(model), make_step(model)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(4):
            step(state, batch(k), 2.0)
    spans = profiling.spans()
    profiling.clear()
    steps = sorted((s for s in spans if s["name"] == "train.step"), key=lambda s: s["start_ns"])
    children = [[c["name"] for c in sorted((c for c in spans if c["parent"] == s["id"]),
                                            key=lambda c: c["start_ns"])] for s in steps]
    eager = ["train.forward", "train.backward", "train.update"]
    assert children == [eager, eager, ["train.replay"], ["train.replay"]]
