"""Plain PyTorch reference of the benchmark's models: CLIP and CLIP-FDT training steps.

Written from the published description of the models and the recipe
(CLIP ViT-B/32 towers; the FDT codebook of Chen et al., CVPR 2023; the
reference repository's ``config_cc3m.yaml`` blocks), in float32 with TF32
off, on a dict of parameters keyed by the names the measured program uses.
It imports nothing of the program and no kernel: every product is a plain
``torch.matmul``.

- :func:`param_specs` / :func:`init_params`: the parameters of a
  configuration and their initial values, drawn on the device from a seed in
  two large calls (one normal, one uniform buffer, sliced per leaf).
- :class:`Net` / :func:`info_nce`: the towers, the codebook pooling with
  the exact (sorted) sparsemax, the embeddings, the symmetric InfoNCE.
- :func:`train_steps`: the recipe's update (logit-scale clamp around a
  masked AdamW with per-leaf weight decay, the warmup/cosine learning rate),
  returning each step's loss, the first step's gradient and the change of
  every leaf after the last step.

``precision="fp8"`` computes every product as an fp8 training GEMM does
(:func:`product`): the control, one precision below the configuration's
bfloat16. ``fault="half_batch"`` plants a fault in the step, for the
checks' readings: the loss over the first half of the rows only.

Departures from the program, each a choice of the plainer form: sparsemax
is the sorted projection (the program bisects 40 times, to within 2^-40);
the patch embed is the equivalent product over unfolded patches.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)
LOGIT_SCALE_MAX = 100.0
FP8_MAX = 448.0  # float8 e4m3's largest finite value
FP8_E5M2_MAX = 57344.0  # float8 e5m2's


def exact_fp32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` with one scale for the tensor (amax / top)."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 (per tensor)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


def product(precision: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``a @ b`` at ``precision``: float32, or "fp8" as an fp8 training GEMM
    computes it: both operands rounded to float8 e4m3 in the forward, the
    output's gradient rounded to float8 e5m2 before the backward's two
    products, each with one scale per tensor and float32 sums."""
    if precision == "fp32":
        return torch.matmul
    if precision != "fp8":
        raise ValueError(f"precision {precision!r}: fp32 or fp8")

    def e4m3(x):
        return x + (_fp8(x.detach(), torch.float8_e4m3fn, FP8_MAX) - x).detach()

    return lambda a, b: _Fp8Grad.apply(torch.matmul(e4m3(a), e4m3(b)))


# -- parameters --------------------------------------------------------------
def sizes(config: dict) -> dict:
    """The towers' sizes, as the configuration's model block states them."""
    kw = config["model"]["kwargs"]
    img, txt = kw["image_encode"], kw["text_encode"]
    return {"image": {"resolution": img["input_resolution"], "patch": img["patch_size"],
                      "width": img["width"], "layers": img["layers"], "heads": img["heads"],
                      "embed_dim": img["embed_dim"]},
            "text": {"context_length": txt["context_length"], "vocab_size": txt["vocab_size"],
                     "width": txt["width"], "layers": txt["layers"], "heads": txt["heads"],
                     "embed_dim": txt["embed_dim"]}}


def _block_specs(prefix: str, width: int, layers: int) -> List[tuple]:
    attn_std = width ** -0.5
    proj_std = width ** -0.5 * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    out = []
    for i in range(layers):
        p = f"{prefix}transformer.resblocks.{i}."
        out += [(p + "ln_1.weight", (width,), "one", 0), (p + "ln_1.bias", (width,), "zero", 0),
                (p + "attn.in_proj_weight", (3 * width, width), "normal", attn_std),
                (p + "attn.in_proj_bias", (3 * width,), "zero", 0),
                (p + "attn.out_proj.weight", (width, width), "normal", proj_std),
                (p + "attn.out_proj.bias", (width,), "zero", 0),
                (p + "ln_2.weight", (width,), "one", 0), (p + "ln_2.bias", (width,), "zero", 0),
                (p + "mlp.c_fc.weight", (4 * width, width), "normal", fc_std),
                (p + "mlp.c_fc.bias", (4 * width,), "uniform", width ** -0.5),
                (p + "mlp.c_proj.weight", (width, 4 * width), "normal", proj_std),
                (p + "mlp.c_proj.bias", (width,), "uniform", (4 * width) ** -0.5)]
    return out


def param_specs(config: dict) -> List[tuple]:
    """``(name, shape, kind, scale)`` of every parameter: kind "normal" (std
    ``scale``), "uniform" (U(+-scale)), "one", "zero" or "logit_scale"."""
    img, txt = sizes(config)["image"], sizes(config)["text"]
    w, tw = img["width"], txt["width"]
    grid = img["resolution"] // img["patch"]
    fdt = config["model"]["kwargs"].get("fdt")
    specs = [("logit_scale", (1,), "logit_scale", 0)]
    if fdt:
        specs += [("space_dict", (fdt["sd_num"], fdt["sd_dim"]), "normal", 1.0),
                  ("logit_scale_sd", (1,), "logit_scale", 0)]
    specs += [("visual.class_embedding", (w,), "normal", w ** -0.5),
              ("visual.positional_embedding", (grid * grid + 1, w), "normal", 0.01),
              ("visual.proj", (w, img["embed_dim"]), "normal", w ** -0.5),
              ("visual.conv1.weight", (w, 3, img["patch"], img["patch"]), "uniform",
               (3 * img["patch"] ** 2) ** -0.5),
              ("visual.ln_pre.weight", (w,), "one", 0), ("visual.ln_pre.bias", (w,), "zero", 0)]
    specs += _block_specs("visual.", w, img["layers"])
    specs += [("visual.ln_post.weight", (w,), "one", 0), ("visual.ln_post.bias", (w,), "zero", 0),
              ("encode_text.positional_embedding", (txt["context_length"], tw), "normal", 0.01),
              ("encode_text.token_embedding.weight", (txt["vocab_size"], tw), "normal", 0.02)]
    specs += _block_specs("encode_text.", tw, txt["layers"])
    specs += [("encode_text.ln_final.weight", (tw,), "one", 0),
              ("encode_text.ln_final.bias", (tw,), "zero", 0),
              ("encode_text.text_projection.weight", (txt["embed_dim"], tw), "normal", tw ** -0.5),
              ("encode_text.text_projection.bias", (txt["embed_dim"],), "uniform", tw ** -0.5)]
    if fdt:
        d = fdt["sd_dim"]
        for tower, ft in (("img", fdt["raw_img_ft_dim"]), ("txt", fdt["raw_txt_ft_dim"])):
            p = f"{tower}_query_model.q_map."
            specs += [(p + "0.weight", (ft,), "one", 0), (p + "0.bias", (ft,), "zero", 0),
                      (p + "1.weight", (d, ft), "uniform", ft ** -0.5),
                      (p + "1.bias", (d,), "uniform", ft ** -0.5),
                      (p + "3.weight", (d,), "one", 0), (p + "3.bias", (d,), "zero", 0),
                      (p + "4.weight", (d, d), "uniform", d ** -0.5),
                      (p + "4.bias", (d,), "uniform", d ** -0.5)]
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
            out[name] = torch.full(shape, LOGIT_SCALE_INIT, device=device)
        else:
            out[name] = (torch.ones if kind == "one" else torch.zeros)(shape, device=device)
    return out


def frozen(name: str) -> bool:
    """The patch embed is never trained (the reference's ``freeze_conv1``)."""
    return name == "visual.conv1.weight"


def weight_decay(name: str, base: float) -> float:
    """The recipe's ``pconfig``: no decay on LayerNorm weights and biases
    (the query heads' ``q_map.0`` and ``q_map.3`` are LayerNorms), on any
    bias, or on the logit scales; ``base`` elsewhere."""
    leaf = name.rsplit(".", 1)[-1]
    parts = name.split(".")
    in_norm = any(p.startswith("ln_") for p in parts) or (
        "q_map" in parts and parts[parts.index("q_map") + 1] in ("0", "3"))
    if leaf == "bias" or in_norm or name.startswith("logit_scale"):
        return 0.0
    return base


# -- forward ----------------------------------------------------------------
class Net:
    """The forward of one configuration at one operand precision."""

    def __init__(self, config: dict, precision: str = "fp32"):
        self.config = config
        self.mm = product(precision)
        self.fdt = config["model"]["kwargs"].get("fdt")

    def linear(self, x, P, prefix):
        return self.mm(x, P[prefix + "weight"].t()) + P[prefix + "bias"]

    @staticmethod
    def norm(x, P, prefix):
        return F.layer_norm(x, (x.shape[-1],), P[prefix + "weight"], P[prefix + "bias"], 1e-5)

    def attention(self, x, P, prefix, heads, causal):
        b, s, d = x.shape
        qkv = self.linear(x, P, prefix + "in_proj_")
        q, k, v = (t.reshape(b, s, heads, d // heads).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        logits = self.mm(q, k.transpose(-1, -2)) * (d // heads) ** -0.5
        if causal:
            logits = logits.masked_fill(
                torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
        out = self.mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, s, d)
        return self.linear(out, P, prefix + "out_proj.")

    def blocks(self, x, P, prefix, layers, heads, causal):
        for i in range(layers):
            p = f"{prefix}transformer.resblocks.{i}."
            x = x + self.attention(self.norm(x, P, p + "ln_1."), P, p + "attn.", heads, causal)
            h = self.linear(self.norm(x, P, p + "ln_2."), P, p + "mlp.c_fc.")
            x = x + self.linear(h * torch.sigmoid(1.702 * h), P, p + "mlp.c_proj.")
        return x

    def image_tokens(self, P, images):
        """NHWC images -> the vision transformer's output [B, grid^2 + 1, W]."""
        img = sizes(self.config)["image"]
        b, p, w = images.shape[0], img["patch"], img["width"]
        g = img["resolution"] // p
        patches = (images.permute(0, 3, 1, 2).reshape(b, 3, g, p, g, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p))
        x = self.mm(patches, P["visual.conv1.weight"].reshape(w, -1).t())
        x = torch.cat([P["visual.class_embedding"].expand(b, 1, w), x], dim=1)
        x = self.norm(x + P["visual.positional_embedding"], P, "visual.ln_pre.")
        return self.blocks(x, P, "visual.", img["layers"], img["heads"], False)

    def text_tokens(self, P, tokens):
        """Token ids -> ln_final over every position [B, ctx, W]."""
        txt = sizes(self.config)["text"]
        x = P["encode_text.token_embedding.weight"][tokens.long()]
        x = x + P["encode_text.positional_embedding"][: tokens.shape[1]]
        x = self.blocks(x, P, "encode_text.", txt["layers"], txt["heads"], True)
        return self.norm(x, P, "encode_text.ln_final.")

    def codebook(self, P, tower, feats, keep, temperature):
        """FDT: query head, token x codebook logits (pads zeroed), max over
        tokens, sparsemax, the weighted codebook."""
        p = f"{tower}_query_model.q_map."
        h = self.linear(self.norm(feats, P, p + "0."), P, p + "1.")
        q = self.linear(self.norm(F.gelu(h), P, p + "3."), P, p + "4.")
        sd = P["space_dict"]
        inner = self.mm(q, sd.t()) / math.sqrt(self.fdt["sd_dim"])
        if keep is not None:
            inner = inner * keep[..., None]
        att = sparsemax(inner.amax(dim=1) / temperature)
        return self.mm(att, sd)

    def image_embedding(self, P, images, temperature, eps=0.0):
        """L2-normalised image embeddings: the codebook feature (FDT) or the
        projected class token (CLIP)."""
        x = self.image_tokens(P, images)
        if self.fdt:
            emb, eps = self.codebook(P, "img", x[:, 1:], None, temperature), 1e-10
        else:
            emb = self.mm(self.norm(x[:, 0], P, "visual.ln_post."), P["visual.proj"])
        return emb / (emb.norm(dim=-1, keepdim=True) + eps)

    def text_embedding(self, P, tokens, pad_mask, temperature):
        """L2-normalised text embeddings: the codebook feature over the real
        tokens (FDT) or the projected EOT token (CLIP)."""
        words = self.text_tokens(P, tokens)
        if self.fdt:
            emb = self.codebook(P, "txt", words, (pad_mask == 0).float(), temperature)
        else:
            eot = words[torch.arange(words.shape[0], device=words.device),
                        tokens.long().argmax(dim=-1)]
            emb = self.linear(eot, P, "encode_text.text_projection.")
        return emb / (emb.norm(dim=-1, keepdim=True) + 1e-10)

    def embeddings(self, P, batch, temperature):
        """Both embeddings of a batch and the clamped logit scale."""
        img = self.image_embedding(P, batch["image"], temperature)
        txt = self.text_embedding(P, batch["tokens"], batch["pad_mask"], temperature)
        scale = torch.clamp_max(P["logit_scale"][0].exp(), LOGIT_SCALE_MAX)
        return img, txt, scale

    def loss(self, P, batch, temperature, fault: Optional[str] = None):
        img, txt, scale = self.embeddings(P, batch, temperature)
        if fault == "half_batch":
            half = img.shape[0] // 2
            img, txt = img[:half], txt[:half]
        return info_nce(img, txt, scale, self.mm)


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto the simplex over the last axis (Martins and
    Astudillo 2016), by sorting; autograd through it is the exact sparsemax
    Jacobian, since the support and its size are piecewise constant."""
    z = z - z.amax(dim=-1, keepdim=True).detach()
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k = torch.arange(1, z.shape[-1] + 1, dtype=z.dtype, device=z.device)
    cumsum = torch.cumsum(z_sorted, dim=-1)
    support = (1 + k * z_sorted > cumsum).detach()
    size = torch.where(support, k, 0).amax(dim=-1, keepdim=True)
    tau = (torch.where(support, z_sorted, 0).sum(dim=-1, keepdim=True) - 1) / size
    return torch.clamp_min(z - tau, 0)


def info_nce(img, txt, scale, mm=torch.matmul):
    """Symmetric cross entropy of ``scale * img @ txt^T`` against the diagonal."""
    logits = mm(img, txt.t()) * scale
    labels = torch.arange(img.shape[0], device=img.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))


# -- the recipe's update ------------------------------------------------------
def learning_rate(config: dict, step: int) -> float:
    """The recipe's ``Cosine`` schedule at the 1-based ``step``: the line from
    ``base_lr`` (step 1) to ``warmup_lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr`` at ``max_iter``; with iterated-learning resets, the
    line again after each reset boundary, scaled by the cosine value."""
    sched = config["lr_scheduler"]
    if sched["type"] != "Cosine":
        raise NotImplementedError(f"lr_scheduler {sched['type']!r}")
    kw = sched["kwargs"]
    base, warm, low = kw["base_lr"], kw["warmup_lr"], kw["min_lr"]
    warmup, max_iter = kw["warmup_steps"], kw["max_iter"]
    reset = config.get("reset") or {}
    reset_steps = reset.get("reset_steps", 0) if reset.get("enable") else 0

    def line(s):
        return (warm - base) / (warmup - 1) * (s - 1.0) + base

    cos = low + (warm - low) * (1 + math.cos(math.pi * (step - warmup)
                                             / max(max_iter - warmup, 1))) / 2
    lr = cos
    if warmup >= 2:
        if step < warmup:
            lr = line(step)
        elif reset_steps > 0 and step % reset_steps < warmup:
            lr = cos * line(step % reset_steps) / warm
    return max(lr, 0.0)


def fdt_temperature(config: dict, step: int) -> float:
    """The recipe's codebook temperature at the 1-based ``step`` (``t_decay``)."""
    td = config.get("t_decay")
    if not td:
        return float(config["model"]["kwargs"]["fdt"]["sd_temperature"])
    m = step // td["sd_T_decay_iter"]
    if m <= 0:
        return float(td["org_t"])
    return max(td["org_t"] * td["sd_T_decay_w"] ** m, td["sd_T_min"])


def train_steps(config: dict, params0: Dict[str, torch.Tensor], batches: Sequence[dict],
                precision: str = "fp32", fault: Optional[str] = None) -> dict:
    """Train a copy of ``params0`` for ``len(batches)`` steps from step 1.

    Returns ``loss`` (each step's), ``grad`` and ``grad_norm`` (the first
    step's gradient per leaf and its norm, zeros for a leaf the loss does not
    read) and ``change`` (each leaf's change after the last step), keyed by
    name, the tensors on the host."""
    gc = config.get("grad_clip") or {}
    if gc.get("type", "none") not in ("none", "logit_scale_param_value"):
        raise NotImplementedError(f"grad_clip {gc.get('type')!r}")
    opt = config["optimizer"]["kwargs"]
    b1, b2 = opt["betas"]
    eps, base_wd = opt["eps"], opt["weight_decay"]
    net = Net(config, precision)
    P = {n: t.detach().clone().requires_grad_(not frozen(n)) for n, t in params0.items()}
    train = [n for n in P if not frozen(n)]
    mu = {n: torch.zeros_like(P[n]) for n in train}
    nu = {n: torch.zeros_like(P[n]) for n in train}
    losses, grad = [], {}

    def clamp_scale():
        if gc.get("type") == "logit_scale_param_value":
            P["logit_scale"].clamp_(gc["value"], gc["max_value"])

    for step, batch in enumerate(batches, start=1):
        temperature = fdt_temperature(config, step) if net.fdt else 1.0
        loss = net.loss(P, batch, temperature, fault)
        grads = torch.autograd.grad(loss, [P[n] for n in train], allow_unused=True)
        losses.append(float(loss.detach()))
        lr = learning_rate(config, step)
        with torch.no_grad():
            clamp_scale()
            for n, g in zip(train, grads):
                g = torch.zeros_like(P[n]) if g is None else g
                if step == 1:
                    grad[n] = g.cpu()
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (mu[n] / (1 - b1 ** step)) / ((nu[n] / (1 - b2 ** step)).sqrt() + eps)
                P[n].sub_(lr * (update + weight_decay(n, base_wd) * P[n]))
            clamp_scale()
        del loss, grads
    for n in P:
        grad.setdefault(n, torch.zeros_like(P[n], device="cpu"))
    return {"loss": losses, "grad": grad,
            "grad_norm": {n: float(g.norm()) for n, g in grad.items()},
            "change": {n: (P[n].detach() - params0[n]).cpu() for n in P}}
