"""CLIP-FDT: factorized-discrete-token codebook model.

Counterpart of ``iterated_learning_for_vlm_tpu/models/fdt.py``: a learnable
codebook ``space_dict [sd_num, sd_dim]`` drawn from N(0, 1), one
:class:`QueryModel` head per tower mapping patch/word tokens into codebook
space, pooled codebook attention normalised by sparsemax (or softmax /
sigmoid), and dual logit scales.

``QueryModel`` keeps both of the JAX branches with their own operation order:
the fused branch (``use_fused_kernel`` with sparsemax, kernels K1-fwd and
K1-bwd) and the plain branch; both are differentiable. :func:`codebook_route`
decides from the input whether the kernels can take it (on a CUDA device:
bf16 q, ``sd_dim`` a multiple of 64 and at most 1024; any T); when the knob
asked and they cannot, the call takes the plain branch and
``codebook_route.plain_routes`` counts it. The FDT temperature is
a call argument, so a decay schedule changes it without touching the model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops import codebook_attention
from ..ops.graphs import counted
from .clip import LOGIT_SCALE_INIT, LOGIT_SCALE_MAX, build_vision_tower, l2_normalize
from .initializers import scaled_normal, torch_bias_uniform, torch_kaiming_uniform
from .layers import LayerNorm, Linear
from .sparsemax import sparsemax, sparsemax_bisect
from .swin import SwinTransformer
from .text import TextConfig, TextTransformer
from .vit import VisionConfig


@dataclass(frozen=True)
class FDTConfig:
    sd_num: int = 4096
    sd_dim: int = 512
    raw_img_ft_dim: int = 768
    raw_txt_ft_dim: int = 512
    att_func_type: str = "sparsemax"  # sparsemax | softmax | sigmoid
    pool_type: str = "max"  # max | mean | sum
    sd_temperature: float = 1000.0
    sparsemax_method: str = "sort"  # sort | bisect
    use_fused_kernel: bool = False  # fused codebook pooling kernel (K1)


@counted("plain_routes")
def codebook_route(q: torch.Tensor, sd_dim: int) -> bool:
    """Whether the fused codebook kernels (K1) take ``q [B, T, sd_dim]``: on a
    CUDA device they need bf16 and ``sd_dim`` a multiple of 64, at most
    ``MAX_DEPTH``; a CPU tensor takes their plain versions, which take
    anything. Called when the knob asks for K1; a refusal adds one to
    ``codebook_route.plain_routes``."""
    takes = q.device.type == "cpu" or (
        q.dtype == torch.bfloat16 and sd_dim % codebook_attention.DEPTH_STEP == 0
        and sd_dim <= codebook_attention.MAX_DEPTH)
    if not takes:
        codebook_route.plain_routes += 1
    return takes


class QueryModel(nn.Module):
    """Token -> codebook attention head (reference ``Query_model``);
    ``q_map`` is ``Sequential(LN, Linear, GELU, LN, Linear)`` as in the
    reference checkpoints."""

    def __init__(self, ft_dim: int, sd_dim: int, att_func_type: str = "sparsemax",
                 pool_type: str = "max", sparsemax_method: str = "sort",
                 use_fused_kernel: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.ft_dim = ft_dim
        self.sd_dim = sd_dim
        self.att_func_type = att_func_type
        self.pool_type = pool_type
        self.sparsemax_method = sparsemax_method
        self.use_fused_kernel = use_fused_kernel
        self.dtype = dtype
        self.q_map = nn.Sequential(
            LayerNorm(ft_dim, dtype=dtype, device=device),
            Linear(ft_dim, sd_dim, dtype=dtype, device=device),
            nn.GELU(),  # exact erf form, as in the reference
            LayerNorm(sd_dim, dtype=dtype, device=device),
            Linear(sd_dim, sd_dim, dtype=dtype, device=device),
        )

    def init_weights(self, generator=None):
        fc_1, fc_2 = self.q_map[1], self.q_map[4]
        torch_kaiming_uniform(fc_1.weight, generator)
        torch_bias_uniform(fc_1.bias, self.ft_dim, generator)
        torch_kaiming_uniform(fc_2.weight, generator)
        torch_bias_uniform(fc_2.bias, self.sd_dim, generator)

    def forward(self, ft, sd, mask=None, temperature=1.0, return_token_att=False):
        """ft: [B, T, ft_dim]; sd: [sd_num, sd_dim]; mask: [B, T] additive pad
        mask (0 real / -inf pad) or None. Returns ``(att_weight, att_ft)``;
        with ``return_token_att`` the first element is the token attention."""
        q = self.q_map(ft.to(self.dtype))

        if (self.use_fused_kernel and not return_token_att
                and self.att_func_type == "sparsemax" and codebook_route(q, self.sd_dim)):
            keep = None if mask is None else (mask == 0)
            return codebook_attention.fused_codebook_attention(
                q, sd, keep_mask=keep, temperature=temperature, pool_type=self.pool_type)

        # [B, T, sd_num] inner products, fp32 accumulation of dtype operands
        sd_c = sd.to(self.dtype).float()
        inner = torch.einsum("btd,nd->btn", q.float(), sd_c)
        token_att = inner
        inner = inner / math.sqrt(self.sd_dim)
        if mask is not None:
            inner = inner * (mask == 0).to(inner.dtype)[..., None]  # pads become 0
            token_att = inner
        inner = inner / temperature

        if self.pool_type == "sum":
            pooled = inner.sum(dim=1)
        elif self.pool_type == "mean":
            pooled = inner.mean(dim=1)
        else:
            pooled = inner.amax(dim=1)

        if self.att_func_type == "softmax":
            att_weight = torch.softmax(pooled, dim=-1)
        elif self.att_func_type == "sparsemax":
            att_weight = (sparsemax_bisect(pooled) if self.sparsemax_method == "bisect"
                          else sparsemax(pooled))
        else:
            att_weight = torch.sigmoid(pooled)

        att_ft = torch.matmul(att_weight.to(self.dtype).float(), sd_c)
        if self.att_func_type == "sigmoid":
            att_ft = att_ft / att_weight.sum(dim=-1, keepdim=True)
        if return_token_att:
            return token_att, att_ft
        return att_weight, att_ft


class CLIPFDT(nn.Module):
    """Module names follow the reference checkpoints (``visual``,
    ``encode_text``, ``img_query_model``, ``txt_query_model``, ``space_dict``)."""

    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextConfig, fdt_cfg: FDTConfig,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg
        self.fdt_cfg = fdt_cfg
        self.dtype = dtype
        cfg = fdt_cfg
        self.visual = build_vision_tower(vision_cfg, dtype, device)
        self.encode_text = TextTransformer(text_cfg, dtype=dtype, device=device)
        self.space_dict = nn.Parameter(torch.empty(cfg.sd_num, cfg.sd_dim, device=device))
        qm_kw = dict(sd_dim=cfg.sd_dim, att_func_type=cfg.att_func_type,
                     pool_type=cfg.pool_type, sparsemax_method=cfg.sparsemax_method,
                     use_fused_kernel=cfg.use_fused_kernel, dtype=dtype, device=device)
        self.img_query_model = QueryModel(cfg.raw_img_ft_dim, **qm_kw)
        self.txt_query_model = QueryModel(cfg.raw_txt_ft_dim, **qm_kw)
        self.logit_scale = nn.Parameter(torch.full((1,), LOGIT_SCALE_INIT, device=device))
        self.logit_scale_sd = nn.Parameter(torch.full((1,), LOGIT_SCALE_INIT, device=device))

    def init_weights(self, generator=None):
        scaled_normal(self.space_dict, 1.0, generator)
        with torch.no_grad():
            self.logit_scale.fill_(LOGIT_SCALE_INIT)
            self.logit_scale_sd.fill_(LOGIT_SCALE_INIT)

    def _temperature(self, t):
        return self.fdt_cfg.sd_temperature if t is None else t

    def _patches(self, images):
        """The image tower's tokens for the codebook: a ViT's patch tokens (its
        class token dropped), a Swin tower's final-stage ``patches`` (it has
        no class token)."""
        if isinstance(self.visual, SwinTransformer):
            return self.visual(images)["patches"]
        return self.visual.tokens(images)[:, 1:, :]

    # -- feature extraction (reference ``extract_*`` API) -------------------
    def extract_img_sd_ft(self, images, temperature=None, return_token_att=False):
        return self.img_query_model(self._patches(images), self.space_dict,
                                    temperature=self._temperature(temperature),
                                    return_token_att=return_token_att)

    def extract_txt_sd_ft(self, tokens, pad_mask, temperature=None, return_token_att=False):
        return self.txt_query_model(self.encode_text.words(tokens), self.space_dict,
                                    mask=pad_mask, temperature=self._temperature(temperature),
                                    return_token_att=return_token_att)

    def extract_patch_ft(self, images):
        """Query-projected patch tokens [B, T, sd_dim] (reference
        ``clip_fdt.py:341-354``)."""
        return self.img_query_model.q_map(self._patches(images).to(self.dtype))

    def extract_word_ft(self, tokens, pad_mask):
        """Query-projected word tokens [B, ctx, sd_dim] and the pad mask
        (reference ``clip_fdt.py:357-365``)."""
        return self.txt_query_model.q_map(self.encode_text.words(tokens).to(self.dtype)), pad_mask

    def forward(self, images, tokens, pad_mask=None, sd_temperature=None):
        t = self._temperature(sd_temperature)
        img_att, sd_img_ft = self.img_query_model(self._patches(images), self.space_dict,
                                                  temperature=t)
        txt_att, sd_txt_ft = self.txt_query_model(self.encode_text.words(tokens),
                                                  self.space_dict, mask=pad_mask,
                                                  temperature=t)
        return {
            "image_embed": l2_normalize(sd_img_ft.float(), eps=1e-10),
            "text_embed": l2_normalize(sd_txt_ft.float(), eps=1e-10),
            "logit_scale": torch.clamp_max(self.logit_scale[0].exp(), LOGIT_SCALE_MAX),
            "img_att": img_att,
            "txt_att": txt_att,
        }
