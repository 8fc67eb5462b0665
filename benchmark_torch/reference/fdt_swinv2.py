"""Plain PyTorch reference of CLIP-FDT with the Swin V2-B image tower: training steps.

Written from the published description of the tower (Liu et al., "Swin
Transformer V2", CVPR 2022, and Microsoft Swin-Transformer's
``configs/swinv2/swinv2_base_patch4_window12_192_22k.yaml``: res-post-norm
blocks ``x + LN(attn(x))``, ``x + LN(mlp(x))``; cosine window attention,
``cos(q_i, k_j)`` times a per-head ``exp(min(logit_scale, ln 100))``; the
continuous position bias, a 2 -> 512 -> H MLP over the table of log-spaced
relative offsets, ``16 sigmoid`` of its output gathered per pair; cyclic
shifts masked at -100; patch merging as reduction, then LayerNorm), the FDT
codebook heads of Chen et al. (CVPR 2023, ``reference/clip.py``'s), in
float32 with TF32 off, on a dict of parameters keyed by the names the
measured program uses. It imports nothing of the program and no kernel.
The text tower, the codebook pooling with the sorted sparsemax, the
InfoNCE, the learning rate, the temperature and the fp8 products are
``reference/clip.py``'s; the relative-position index and the shift mask
``reference/swin_moe.py``'s.

- :func:`param_specs` / :func:`init_params`: the parameters and their draw
  from a seed (one normal and one uniform buffer, sliced per leaf).
- :class:`SwinV2Net`: the image tower block by block under
  ``torch.utils.checkpoint`` (so 256 rows fit in float32), its final-stage
  tokens into the image query head.
- :func:`train_steps`: the recipe's update (logit-scale clamp around AdamW
  with per-leaf weight decay) under the iterated-learning schedule
  (:func:`il_phase`); each step's loss, the first step's gradient, the
  change after the last step.

Two departures from the published description, both the JAX package's,
which the program follows: the position-bias MLP reads
``sign(d) ln(1 + |d|) / ln 8`` of the raw offsets d (Microsoft first divides
them by ``ws - 1`` and multiplies by 8); and the qkv projection carries a
bias for k too (Microsoft trains ``q_bias`` and ``v_bias`` only).

``precision="fp8"`` computes every product as an fp8 training GEMM does (the
control). ``fault`` plants one fault, for the checks' readings: ``half_batch``
(the loss over half the rows), ``no_qk_norm`` (raw q k^T times the scale),
``no_scale_clamp`` (no ln 100 clamp of the attention's logit scale),
``no_logit_clamp`` (no clamp of CLIP's logit scale around the update),
``no_cpb_sigmoid`` (the bias MLP's output used as it is), ``pre_norm`` (v1's
``x + attn(LN(x))`` order) or ``v1_merge`` (the merge normalises its 4C
input before the reduction, the 2C affine after it).
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import clip as ref_clip
from reference.swin_moe import relative_index, shift_mask

STAGE0_CHANNELS = 128  # Swin V2-B's EMBED_DIM, which the model factory fixes
CPB_HIDDEN = 512
LOGIT_SCALE_INIT = math.log(10.0)  # each attention head's
LOGIT_SCALE_MAX = math.log(100.0)
FAULTS = ("half_batch", "no_qk_norm", "no_scale_clamp", "no_logit_clamp", "no_cpb_sigmoid",
          "pre_norm", "v1_merge")

exact_fp32 = ref_clip.exact_fp32


def swin_sizes(config: dict) -> dict:
    """The image tower's sizes from the configuration's ``image_encode`` block,
    Swin V2-B's published values where the block is silent."""
    img = config["model"]["kwargs"]["image_encode"]
    return {"resolution": img["input_resolution"], "patch": img.get("patch_size", 4),
            "window": img["window_size"], "depths": tuple(img.get("depths", (2, 2, 18, 2))),
            "heads": tuple(img.get("num_heads", (4, 8, 16, 32))),
            "mlp_ratio": float(img.get("mlp_ratio", 4.0)), "channels": STAGE0_CHANNELS,
            "embed_dim": img["embed_dim"]}


def stages(config: dict) -> List[dict]:
    """Per stage: resolution, channels, heads, window and the odd blocks'
    shift (none where one window covers the map)."""
    s = swin_sizes(config)
    res, dim, out = s["resolution"] // s["patch"], s["channels"], []
    for i, depth in enumerate(s["depths"]):
        ws = min(s["window"], res)
        last = i == len(s["depths"]) - 1
        if res < 1 or res % ws or (not last and res % 2):
            raise ValueError(f"stage {i}: a {res} x {res} map must split into {ws} x {ws} "
                             "windows and, before the last stage, into 2 x 2 patches")
        out.append({"res": res, "dim": dim, "heads": s["heads"][i], "window": ws,
                    "shift": s["window"] // 2 if ws < res else 0, "depth": depth})
        if not last:
            res //= 2
            dim *= 2
    return out


def clip_view(config: dict) -> dict:
    """The configuration as ``reference/clip.py`` reads it for the text tower,
    the codebook and the batch pool: its ``sizes`` also reads a ViT's image
    keys, which this view fills with the Swin tower's resolution and
    placeholders that nothing here reads."""
    view = copy.deepcopy(config)
    s = swin_sizes(config)
    view["model"]["kwargs"]["image_encode"] = {
        "input_resolution": s["resolution"], "patch_size": s["patch"], "width": 1,
        "layers": 1, "heads": 1, "embed_dim": s["embed_dim"]}
    return view


def cpb_coords(ws: int, device) -> torch.Tensor:
    """``[(2 ws - 1)^2, 2]``: each table row's offsets (dy, dx), log-spaced as
    ``sign(d) ln(1 + |d|) / ln 8``, in :func:`relative_index`'s row order."""
    d = torch.arange(-(ws - 1), ws, dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).reshape(-1, 2)
    return (torch.sign(grid) * torch.log1p(grid.abs()) / math.log(8.0)).float().to(device)


# -- parameters --------------------------------------------------------------
def _linear(name: str, n_in: int, n_out: int, bias: bool = True) -> List[tuple]:
    out = [(name + "weight", (n_out, n_in), "uniform", n_in ** -0.5)]
    if bias:
        out.append((name + "bias", (n_out,), "uniform", n_in ** -0.5))
    return out


def _norm(name: str, width: int) -> List[tuple]:
    return [(name + "weight", (width,), "one", 0), (name + "bias", (width,), "zero", 0)]


def param_specs(config: dict) -> List[tuple]:
    """``(name, shape, kind, scale)`` of every parameter, as
    ``reference/clip.py``'s ``param_specs``; kind "attn_scale" is each
    attention head's logit scale, ln 10."""
    s = swin_sizes(config)
    c0, p = s["channels"], s["patch"]
    specs = [spec for spec in ref_clip.param_specs(clip_view(config))
             if not spec[0].startswith("visual.")]
    specs += [("visual.patch_embed.proj.weight", (c0, 3, p, p), "uniform", (3 * p * p) ** -0.5),
              ("visual.patch_embed.proj.bias", (c0,), "uniform", (3 * p * p) ** -0.5)]
    specs += _norm("visual.patch_embed.norm.", c0)
    st = stages(config)
    for i, stage in enumerate(st):
        d, heads, hid = stage["dim"], stage["heads"], int(stage["dim"] * s["mlp_ratio"])
        for b in range(stage["depth"]):
            pre = f"visual.layers.{i}.blocks.{b}."
            specs += _norm(pre + "norm1.", d)
            specs += [(pre + "attn.logit_scale", (heads, 1, 1), "attn_scale", 0)]
            specs += _linear(pre + "attn.qkv.", d, 3 * d)
            specs += _linear(pre + "attn.cpb_mlp.0.", 2, CPB_HIDDEN)
            specs += _linear(pre + "attn.cpb_mlp.2.", CPB_HIDDEN, heads, bias=False)
            specs += _linear(pre + "attn.proj.", d, d)
            specs += _norm(pre + "norm2.", d)
            specs += _linear(pre + "mlp.fc1.", d, hid) + _linear(pre + "mlp.fc2.", hid, d)
        if i < len(st) - 1:
            specs += _linear(f"visual.layers.{i}.downsample.reduction.", 4 * d, 2 * d, False)
            specs += _norm(f"visual.layers.{i}.downsample.norm.", 2 * d)
    last = st[-1]["dim"]
    specs += _norm("visual.norm.", last)
    specs += [("visual.proj", (last, s["embed_dim"]), "normal", last ** -0.5)]
    return specs


@torch.no_grad()
def init_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter's initial float32 value, from ``seed`` alone: one
    normal and one uniform draw on ``device``, sliced leaf by leaf."""
    specs = param_specs(config)
    count = {k: sum(math.prod(s) for _, s, kind, _ in specs if kind == k)
             for k in ("normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pools = {"normal": torch.randn(count["normal"], generator=gen, device=device),
             "uniform": torch.rand(count["uniform"], generator=gen, device=device) * 2 - 1}
    offset = {"normal": 0, "uniform": 0}
    out = {}
    constants = {"logit_scale": ref_clip.LOGIT_SCALE_INIT, "attn_scale": LOGIT_SCALE_INIT}
    for name, shape, kind, scale in specs:
        if kind in pools:
            n = math.prod(shape)
            out[name] = pools[kind][offset[kind]:offset[kind] + n].view(shape) * scale
            offset[kind] += n
        elif kind in constants:
            out[name] = torch.full(shape, constants[kind], device=device)
        else:
            out[name] = (torch.ones if kind == "one" else torch.zeros)(shape, device=device)
    return out


def weight_decay(name: str, base: float) -> float:
    """The recipe's ``pconfig`` on these names: no decay on LayerNorm weights
    and biases (``norm*``, ``ln_*`` and the query heads' ``q_map.0`` and
    ``q_map.3``), on any leaf named ``bias`` or on a logit scale (CLIP's, the
    codebook's and each attention's); ``base`` elsewhere (the codebook and
    the position-bias MLP's weights are decayed)."""
    parts = name.split(".")
    in_norm = any(p.startswith(("ln_", "norm")) for p in parts[:-1]) or (
        "q_map" in parts and parts[parts.index("q_map") + 1] in ("0", "3"))
    if parts[-1] in ("bias", "logit_scale") or in_norm or name.startswith("logit_scale"):
        return 0.0
    return base


# -- forward -------------------------------------------------------------------
class SwinV2Net(ref_clip.Net):
    """The forward of one configuration at one operand precision, with the
    text tower and the codebook heads of ``reference/clip.py``."""

    def __init__(self, config: dict, precision: str = "fp32", fault: Optional[str] = None):
        super().__init__(clip_view(config), precision)
        if not self.fdt:
            raise ValueError("the configuration has no fdt block")
        self.sizes = swin_sizes(config)
        self.stages = stages(config)
        self.fault = fault

    def position_bias(self, P, pre, ws, heads, device):
        """``[H, N, N]``: ``16 sigmoid`` of the MLP over the table of offsets,
        gathered for every (query, key) pair."""
        h = F.relu(self.linear(cpb_coords(ws, device), P, pre + "cpb_mlp.0."))
        table = self.mm(h, P[pre + "cpb_mlp.2.weight"].t())
        if self.fault != "no_cpb_sigmoid":
            table = 16.0 * torch.sigmoid(table)
        n = ws * ws
        return table[relative_index(ws, device)].reshape(n, n, heads).permute(2, 0, 1)

    def window_attention(self, x, P, pre, stage, shift):
        b, _, c = x.shape
        res, ws, heads = stage["res"], stage["window"], stage["heads"]
        n = ws * ws
        img = x.reshape(b, res, res, c)
        if shift:
            img = torch.roll(img, (-shift, -shift), dims=(1, 2))
        wins = (img.reshape(b, res // ws, ws, res // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
                .reshape(-1, n, c))
        qkv = self.linear(wins, P, pre + "qkv.")
        q, k, v = (t.reshape(-1, n, heads, c // heads).transpose(1, 2) for t in qkv.split(c, -1))
        if self.fault != "no_qk_norm":
            q = q / (q.norm(dim=-1, keepdim=True) + 1e-12)
            k = k / (k.norm(dim=-1, keepdim=True) + 1e-12)
        logit_scale = P[pre + "logit_scale"]
        if self.fault != "no_scale_clamp":
            logit_scale = torch.clamp_max(logit_scale, LOGIT_SCALE_MAX)
        logits = self.mm(q, k.transpose(-1, -2)) * torch.exp(logit_scale)
        logits = logits + self.position_bias(P, pre, ws, heads, x.device)
        if shift:
            mask = shift_mask(res, ws, shift, x.device)
            logits = (logits.reshape(b, mask.shape[0], heads, n, n) + mask[None, :, None]
                      ).reshape(-1, heads, n, n)
        out = self.mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(-1, n, c)
        out = self.linear(out, P, pre + "proj.")
        img = (out.reshape(b, res // ws, res // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
               .reshape(b, res, res, c))
        if shift:
            img = torch.roll(img, (shift, shift), dims=(1, 2))
        return img.reshape(b, res * res, c)

    def block(self, x, P, pre, stage, shift):
        def mlp(h):
            return self.linear(F.gelu(self.linear(h, P, pre + "mlp.fc1.")), P, pre + "mlp.fc2.")

        if self.fault == "pre_norm":
            x = x + self.window_attention(self.norm(x, P, pre + "norm1."), P, pre + "attn.",
                                          stage, shift)
            return x + mlp(self.norm(x, P, pre + "norm2."))
        x = x + self.norm(self.window_attention(x, P, pre + "attn.", stage, shift), P,
                          pre + "norm1.")
        return x + self.norm(mlp(x), P, pre + "norm2.")

    def merge(self, x, P, i, stage):
        b, res, d = x.shape[0], stage["res"], stage["dim"]
        x = (x.reshape(b, res // 2, 2, res // 2, 2, d).permute(0, 1, 3, 4, 2, 5)
             .reshape(b, (res // 2) ** 2, 4 * d))
        pre = f"visual.layers.{i}.downsample."
        if self.fault == "v1_merge":
            x = F.layer_norm(x, (4 * d,), eps=1e-5)
            x = self.mm(x, P[pre + "reduction.weight"].t())
            return x * P[pre + "norm.weight"] + P[pre + "norm.bias"]
        return self.norm(self.mm(x, P[pre + "reduction.weight"].t()), P, pre + "norm.")

    def patches(self, P, images):
        """NHWC images -> the tower's final-stage tokens after its LayerNorm."""
        s = self.sizes
        b, p, c0 = images.shape[0], s["patch"], s["channels"]
        g = s["resolution"] // p
        patches = (images.permute(0, 3, 1, 2).reshape(b, 3, g, p, g, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p))
        x = (self.mm(patches, P["visual.patch_embed.proj.weight"].reshape(c0, -1).t())
             + P["visual.patch_embed.proj.bias"])
        x = self.norm(x, P, "visual.patch_embed.norm.")
        for i, stage in enumerate(self.stages):
            for blk in range(stage["depth"]):
                shift = stage["shift"] if blk % 2 == 1 else 0  # odd blocks shift
                x = checkpoint(self.block, x, P, f"visual.layers.{i}.blocks.{blk}.", stage,
                               shift, use_reentrant=False)
            if i < len(self.stages) - 1:
                x = self.merge(x, P, i, stage)
        return self.norm(x, P, "visual.norm.")

    def image_embedding(self, P, images, temperature, eps=0.0):
        emb = self.codebook(P, "img", self.patches(P, images), None, temperature)
        return emb / (emb.norm(dim=-1, keepdim=True) + 1e-10)


# -- the recipe's update ------------------------------------------------------
def il_phase(config: dict, step: int) -> str:
    """What the iterated-learning schedule does after optimizer step ``step``
    (the program's ``ILController.on_step``): "reset" (the codebook's
    snapshot is held, the text tower redrawn and the vision tower frozen),
    "release" (the smoothing ends: the codebook is let go, the vision tower
    thawed) or "" (nothing)."""
    reset = config.get("reset") or {}
    if not reset.get("enable"):
        return ""
    k, nums = reset["reset_steps"], reset["reset_nums"]
    if not k < step < k * nums:
        return "release" if step == k * nums else ""
    if step % k == 0:
        return "reset"
    return "release" if step % k == reset["smooth_steps"] else ""


def train_steps(config: dict, params0: Dict[str, torch.Tensor], batches: Sequence[dict],
                precision: str = "fp32", fault: Optional[str] = None) -> dict:
    """Train a copy of ``params0`` for ``len(batches)`` steps from step 1, as
    ``reference/clip.py``'s ``train_steps`` does. The codebook hold and the
    frozen vision tower begin at an iterated-learning reset, whose text tower
    the program redraws with its own generator, which the reference cannot
    replay: it raises there, so the steps it replays hold nothing."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    gc = config.get("grad_clip") or {}
    if gc.get("type", "none") not in ("none", "logit_scale_param_value"):
        raise NotImplementedError(f"grad_clip {gc.get('type')!r}")
    opt = config["optimizer"]["kwargs"]
    b1, b2 = opt["betas"]
    eps, base_wd = opt["eps"], opt["weight_decay"]
    net = SwinV2Net(config, precision, fault)
    P = {n: t.detach().clone().requires_grad_() for n, t in params0.items()}
    names = list(P)
    mu = {n: torch.zeros_like(P[n]) for n in names}
    nu = {n: torch.zeros_like(P[n]) for n in names}
    losses, grad = [], {}

    def clamp_scale():
        if gc.get("type") == "logit_scale_param_value" and fault != "no_logit_clamp":
            P["logit_scale"].clamp_(gc["value"], gc["max_value"])

    for step, batch in enumerate(batches, start=1):
        if il_phase(config, step) == "reset":
            raise NotImplementedError(f"step {step} is an iterated-learning reset, whose text "
                                      "tower the reference cannot redraw")
        temperature = ref_clip.fdt_temperature(config, step)
        loss = net.loss(P, batch, temperature, "half_batch" if fault == "half_batch" else None)
        grads = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
        losses.append(float(loss.detach()))
        lr = ref_clip.learning_rate(config, step)
        with torch.no_grad():
            clamp_scale()
            for n, g in zip(names, grads):
                g = torch.zeros_like(P[n]) if g is None else g
                if step == 1:
                    grad[n] = g.cpu()
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (mu[n] / (1 - b1 ** step)) / ((nu[n] / (1 - b2 ** step)).sqrt() + eps)
                P[n].sub_(lr * (update + weight_decay(n, base_wd) * P[n]))
            clamp_scale()
        del loss, grads
    return {"loss": losses, "grad": grad,
            "grad_norm": {n: float(g.norm()) for n, g in grad.items()},
            "change": {n: (P[n].detach() - params0[n]).cpu() for n in P}}
