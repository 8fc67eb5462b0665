"""Plain PyTorch reference of CLIP with the Swin-MoE-B image tower: training steps.

Written from the published description of the tower (Liu et al., "Swin
Transformer", ICCV 2021: pre-norm v1 blocks, window attention with a learned
relative-position bias, cyclic shifts masked at -100, patch merging; Hwang
et al., "Tutel", arXiv:2206.03382, and Microsoft Swin-Transformer's
``configs/swinmoe/swin_moe_base_patch4_window12_192_32expert_32gpu_22k.yaml``:
top-1 experts in the listed blocks, capacity ``ceil(1.25 T / E)`` filled in
token order, overflow dropped, the GShard load-balancing term
``E * sum(mean gate prob * share routed)`` added to the loss at 0.01), in
float32 with TF32 off, on a dict of parameters keyed by the names the
measured program uses. It imports nothing of the program and no kernel. The
text tower, the InfoNCE, the learning rate and the fp8 products are
``reference/clip.py``'s.

- :func:`param_specs` / :func:`init_params`: the parameters and their draw
  from a seed (one normal and one uniform buffer, sliced per leaf).
- :class:`SwinNet`: the image embedding, block by block under
  ``torch.utils.checkpoint`` so 256 rows fit in float32; each MoE layer
  routes all the batch's tokens at once, so drops depend on token order as
  in the program. Each expert runs on its own tokens (a plain loop).
- :func:`train_steps`: the recipe's update (logit-scale clamp around AdamW
  with per-leaf weight decay), each step's loss, the first step's gradient,
  the change after the last step, and the first step's expert of every
  token at every MoE layer (``routes``).

``precision="fp8"`` computes every product as an fp8 training GEMM does (the
control). ``fault`` plants one fault, for the checks' readings:
``half_batch`` (the loss over half the rows), ``adamw_noop`` (no parameter
moves), ``no_shift_mask``, ``no_rel_bias``, ``no_capacity`` (every token
kept) or ``no_moe_aux`` (the load-balancing term left out of the loss).

Departures from the program, each a choice of the plainer form: the
patch embed is a product over unfolded patches; the experts run one by one
on gathered rows, not as a capacity-padded batched product.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import clip as ref_clip

MOE_AUX_WEIGHT = 0.01
STAGE0_CHANNELS = 128  # Swin-B's EMBED_DIM, which the model factory fixes
FAULTS = ("half_batch", "adamw_noop", "no_shift_mask", "no_rel_bias", "no_capacity",
          "no_moe_aux")

exact_fp32 = ref_clip.exact_fp32


def swin_sizes(config: dict) -> dict:
    """The image tower's sizes from the configuration's ``image_encode`` block,
    Swin-MoE-B's published values where the block is silent."""
    img = config["model"]["kwargs"]["image_encode"]
    depths = tuple(img.get("depths", (2, 2, 18, 2)))
    blocks = img.get("moe_blocks")
    if blocks is None:
        blocks = [[], [], list(range(1, depths[2], 2)), list(range(1, depths[3], 2))]
    return {"resolution": img["input_resolution"], "patch": img.get("patch_size", 4),
            "window": img["window_size"], "depths": depths,
            "heads": tuple(img.get("num_heads", (4, 8, 16, 32))),
            "mlp_ratio": float(img.get("mlp_ratio", 4.0)), "experts": img["num_experts"],
            "capacity_factor": float(img.get("capacity_factor", 1.25)),
            "moe_blocks": [[b for b in stage if b >= 0] for stage in blocks],
            "channels": STAGE0_CHANNELS, "embed_dim": img["embed_dim"]}


def stages(config: dict) -> List[dict]:
    """Per stage: resolution, channels, heads, window, the odd blocks' shift
    (none where one window covers the map), its MoE blocks."""
    s = swin_sizes(config)
    res, dim, out = s["resolution"] // s["patch"], s["channels"], []
    for i, depth in enumerate(s["depths"]):
        ws = min(s["window"], res)
        last = i == len(s["depths"]) - 1
        if res < 1 or res % ws or (not last and res % 2):
            raise ValueError(f"stage {i}: a {res} x {res} map must split into {ws} x {ws} "
                             "windows and, before the last stage, into 2 x 2 patches")
        out.append({"res": res, "dim": dim, "heads": s["heads"][i], "window": ws,
                    "shift": s["window"] // 2 if ws < res else 0, "depth": depth,
                    "moe": set(s["moe_blocks"][i])})
        if not last:
            res //= 2
            dim *= 2
    return out


def clip_view(config: dict) -> dict:
    """The configuration as ``reference/clip.py`` reads it for the text tower
    and the batch pool: its ``sizes`` also reads a ViT's image keys, which
    this view fills with the Swin tower's resolution and placeholders that
    nothing here reads."""
    view = copy.deepcopy(config)
    s = swin_sizes(config)
    view["model"]["kwargs"]["image_encode"] = {
        "input_resolution": s["resolution"], "patch_size": s["patch"], "width": 1,
        "layers": 1, "heads": 1, "embed_dim": s["embed_dim"]}
    return view


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
    ``reference/clip.py``'s ``param_specs``."""
    s = swin_sizes(config)
    c0, p, e = s["channels"], s["patch"], s["experts"]
    specs = [("logit_scale", (1,), "logit_scale", 0),
             ("visual.patch_embed.proj.weight", (c0, 3, p, p), "uniform", (3 * p * p) ** -0.5),
             ("visual.patch_embed.proj.bias", (c0,), "uniform", (3 * p * p) ** -0.5)]
    specs += _norm("visual.patch_embed.norm.", c0)
    st = stages(config)
    for i, stage in enumerate(st):
        d, ws, hid = stage["dim"], stage["window"], int(stage["dim"] * s["mlp_ratio"])
        for b in range(stage["depth"]):
            pre = f"visual.layers.{i}.blocks.{b}."
            specs += _norm(pre + "norm1.", d)
            specs += _linear(pre + "attn.qkv.", d, 3 * d)
            specs += [(pre + "attn.relative_position_bias_table",
                       ((2 * ws - 1) ** 2, stage["heads"]), "normal", 0.02)]
            specs += _linear(pre + "attn.proj.", d, d)
            specs += _norm(pre + "norm2.", d)
            if b in stage["moe"]:
                specs += [(pre + "mlp.gate.weight", (e, d), "normal", 0.02),
                          (pre + "mlp.w1", (e, d, hid), "uniform", d ** -0.5),
                          (pre + "mlp.b1", (e, 1, hid), "uniform", d ** -0.5),
                          (pre + "mlp.w2", (e, hid, d), "uniform", hid ** -0.5),
                          (pre + "mlp.b2", (e, 1, d), "uniform", hid ** -0.5)]
            else:
                specs += _linear(pre + "mlp.fc1.", d, hid) + _linear(pre + "mlp.fc2.", hid, d)
        if i < len(st) - 1:
            specs += _norm(f"visual.layers.{i}.downsample.norm.", 4 * d)
            specs += _linear(f"visual.layers.{i}.downsample.reduction.", 4 * d, 2 * d, False)
    last = st[-1]["dim"]
    specs += _norm("visual.norm.", last)
    specs += [("visual.proj", (last, s["embed_dim"]), "normal", last ** -0.5)]
    specs += [spec for spec in ref_clip.param_specs(clip_view(config))
              if spec[0].startswith("encode_text.")]
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
    for name, shape, kind, scale in specs:
        if kind in pools:
            n = math.prod(shape)
            out[name] = pools[kind][offset[kind]:offset[kind] + n].view(shape) * scale
            offset[kind] += n
        elif kind == "logit_scale":
            out[name] = torch.full(shape, ref_clip.LOGIT_SCALE_INIT, device=device)
        else:
            out[name] = (torch.ones if kind == "one" else torch.zeros)(shape, device=device)
    return out


def weight_decay(name: str, base: float) -> float:
    """The recipe's ``pconfig`` on these names: no decay on LayerNorm weights
    and biases (``norm*``, ``ln_*``), on any leaf named ``bias``, or on the
    logit scale; ``base`` elsewhere (the bias table, the gate and every expert
    tensor, ``b1`` and ``b2`` included, are decayed)."""
    parts = name.split(".")
    in_norm = any(p.startswith(("ln_", "norm")) for p in parts[:-1])
    if parts[-1] == "bias" or in_norm or name.startswith("logit_scale"):
        return 0.0
    return base


# -- the tower's constants ----------------------------------------------------
def relative_index(ws: int, device) -> torch.Tensor:
    """``[ws^2 * ws^2]``: the table row of each (query, key) pair of a window,
    ``(dy + ws - 1) (2 ws - 1) + (dx + ws - 1)``."""
    y, x = np.divmod(np.arange(ws * ws), ws)
    dy = y[:, None] - y[None, :] + ws - 1
    dx = x[:, None] - x[None, :] + ws - 1
    return torch.from_numpy((dy * (2 * ws - 1) + dx).reshape(-1)).to(device)


def shift_mask(res: int, ws: int, shift: int, device) -> torch.Tensor:
    """``[nW, N, N]``: -100 between tokens of a shifted window that come from
    different regions of the rolled map (three bands a side), else 0."""
    band = np.zeros(res, np.int64)
    band[res - ws:res - shift] = 1
    band[res - shift:] = 2
    region = band[:, None] * 3 + band[None, :]
    wins = region.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = np.where(wins[:, :, None] != wins[:, None, :], -100.0, 0.0)
    return torch.from_numpy(mask.astype(np.float32)).to(device)


# -- forward -------------------------------------------------------------------
class SwinNet(ref_clip.Net):
    """The forward of one configuration at one operand precision, with the
    text tower of ``reference/clip.py``."""

    def __init__(self, config: dict, precision: str = "fp32", fault: Optional[str] = None):
        super().__init__(clip_view(config), precision)
        self.swin = config
        self.sizes = swin_sizes(config)
        self.stages = stages(config)
        self.fault = fault

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
        logits = self.mm(q, k.transpose(-1, -2)) * (c // heads) ** -0.5
        if self.fault != "no_rel_bias":
            table = P[pre + "relative_position_bias_table"]
            logits = logits + table[relative_index(ws, x.device)].reshape(n, n, heads).permute(2, 0, 1)
        if shift and self.fault != "no_shift_mask":
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

    def experts(self, x, P, pre):
        """Top-1 routing over every token of the batch, in token order; returns
        the output, the load-balancing term and each token's expert."""
        b, l, d = x.shape
        tokens = x.reshape(b * l, d)
        t, e = tokens.shape[0], self.sizes["experts"]
        capacity = max(1, math.ceil(self.sizes["capacity_factor"] * t / e))
        probs = torch.softmax(self.mm(tokens, P[pre + "gate.weight"].t()), dim=-1)
        gate, expert = probs.max(dim=-1)
        routed = F.one_hot(expert, e)
        aux = e * torch.sum(probs.mean(dim=0) * routed.float().mean(dim=0))
        place = (routed.cumsum(dim=0) * routed).sum(dim=-1) - 1
        keep = torch.ones_like(place, dtype=torch.bool) if self.fault == "no_capacity" else (
            place < capacity)
        y = torch.zeros_like(tokens)
        for i in range(e):
            rows = ((expert == i) & keep).nonzero().squeeze(1)
            if rows.numel() == 0:
                continue
            h = F.gelu(self.mm(tokens[rows], P[pre + "w1"][i]) + P[pre + "b1"][i])
            out = self.mm(h, P[pre + "w2"][i]) + P[pre + "b2"][i]
            y = y.index_put((rows,), out * gate[rows, None])
        return y.reshape(b, l, d), aux, expert

    def block(self, x, P, pre, stage, shift, moe):
        x = x + self.window_attention(self.norm(x, P, pre + "norm1."), P, pre + "attn.", stage,
                                      shift)
        h = self.norm(x, P, pre + "norm2.")
        if moe:
            y, aux, expert = self.experts(h, P, pre + "mlp.")
            return x + y, aux, expert
        h = F.gelu(self.linear(h, P, pre + "mlp.fc1."))
        return x + self.linear(h, P, pre + "mlp.fc2."), None, None

    def swin_embedding(self, P, images, routes: Optional[list] = None):
        """L2-normalised image embeddings and the summed load-balancing term;
        ``routes`` gets each MoE layer's expert per token."""
        s = self.sizes
        b, p, c0 = images.shape[0], s["patch"], s["channels"]
        g = s["resolution"] // p
        patches = (images.permute(0, 3, 1, 2).reshape(b, 3, g, p, g, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p))
        x = (self.mm(patches, P["visual.patch_embed.proj.weight"].reshape(c0, -1).t())
             + P["visual.patch_embed.proj.bias"])
        x = self.norm(x, P, "visual.patch_embed.norm.")
        aux_total = torch.zeros((), device=images.device)
        for i, stage in enumerate(self.stages):
            for blk in range(stage["depth"]):
                pre = f"visual.layers.{i}.blocks.{blk}."
                moe = blk in stage["moe"]
                shift = stage["shift"] if blk % 2 == 1 else 0  # odd blocks shift
                x, aux, expert = checkpoint(self.block, x, P, pre, stage, shift, moe,
                                            use_reentrant=False)
                if moe:
                    aux_total = aux_total + aux
                    if routes is not None:
                        routes.append(expert.detach())
            if i < len(self.stages) - 1:
                res, d = stage["res"], stage["dim"]
                x = (x.reshape(b, res // 2, 2, res // 2, 2, d).permute(0, 1, 3, 4, 2, 5)
                     .reshape(b, (res // 2) ** 2, 4 * d))
                x = self.norm(x, P, f"visual.layers.{i}.downsample.norm.")
                x = self.mm(x, P[f"visual.layers.{i}.downsample.reduction.weight"].t())
        x = self.norm(x, P, "visual.norm.")
        emb = self.mm(x.mean(dim=1), P["visual.proj"])
        return emb / emb.norm(dim=-1, keepdim=True), aux_total

    def swin_loss(self, P, batch, routes: Optional[list] = None):
        img, aux = self.swin_embedding(P, batch["image"], routes)
        txt = self.text_embedding(P, batch["tokens"], batch["pad_mask"], 1.0)
        scale = torch.clamp_max(P["logit_scale"][0].exp(), ref_clip.LOGIT_SCALE_MAX)
        if self.fault == "half_batch":
            half = img.shape[0] // 2
            img, txt = img[:half], txt[:half]
        loss = ref_clip.info_nce(img, txt, scale, self.mm)
        if self.fault != "no_moe_aux":
            loss = loss + MOE_AUX_WEIGHT * aux
        return loss


# -- the recipe's update ------------------------------------------------------
def train_steps(config: dict, params0: Dict[str, torch.Tensor], batches: Sequence[dict],
                precision: str = "fp32", fault: Optional[str] = None) -> dict:
    """Train a copy of ``params0`` for ``len(batches)`` steps from step 1, as
    ``reference/clip.py``'s ``train_steps`` does. Adds ``routes``: the first
    step's expert per token at each MoE layer."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    gc = config.get("grad_clip") or {}
    if gc.get("type", "none") not in ("none", "logit_scale_param_value"):
        raise NotImplementedError(f"grad_clip {gc.get('type')!r}")
    opt = config["optimizer"]["kwargs"]
    b1, b2 = opt["betas"]
    eps, base_wd = opt["eps"], opt["weight_decay"]
    net = SwinNet(config, precision, fault)
    P = {n: t.detach().clone().requires_grad_() for n, t in params0.items()}
    names = list(P)
    mu = {n: torch.zeros_like(P[n]) for n in names}
    nu = {n: torch.zeros_like(P[n]) for n in names}
    losses, grad, routes = [], {}, []

    def clamp_scale():
        if gc.get("type") == "logit_scale_param_value":
            P["logit_scale"].clamp_(gc["value"], gc["max_value"])

    for step, batch in enumerate(batches, start=1):
        loss = net.swin_loss(P, batch, routes if step == 1 else None)
        grads = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
        losses.append(float(loss.detach()))
        lr = ref_clip.learning_rate(config, step)
        with torch.no_grad():
            clamp_scale()
            for n, g in zip(names, grads):
                g = torch.zeros_like(P[n]) if g is None else g
                if step == 1:
                    grad[n] = g.cpu()
                if fault == "adamw_noop":
                    continue
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (mu[n] / (1 - b1 ** step)) / ((nu[n] / (1 - b2 ** step)).sqrt() + eps)
                P[n].sub_(lr * (update + weight_decay(n, base_wd) * P[n]))
            clamp_scale()
        del loss, grads
    return {"loss": losses, "grad": grad,
            "grad_norm": {n: float(g.norm()) for n, g in grad.items()},
            "change": {n: (P[n].detach() - params0[n]).cpu() for n in P},
            "routes": routes}
