"""Text transformer tower (CLIP-style).

Counterpart of ``iterated_learning_for_vlm_tpu/models/text.py``: causal
transformer over token ids, fp32 token embedding (cast after the gather),
positional embedding sliced to the context actually given (context buckets),
EOT pooling at the highest token id, ``text_projection`` as a Linear with a
bias. The pad mask does not enter attention: causal masking already keeps
every real token's features independent of the pads after it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .initializers import scaled_normal, torch_bias_uniform
from .layers import LayerNorm, Linear, Transformer


@dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49409
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512
    positional_embedding: bool = True
    remat: bool = False
    use_flash: bool = False
    fused_attn: bool = False
    fused_attn_group: int = 2
    fused_attn_sample_group: int = 2
    fused_attn_bwd_fuse3: bool = False
    fused_attn_group_bwd: int | None = None
    fused_attn_sample_group_bwd: int | None = None
    attn_layout: str = "bhqk"
    unroll: bool = False


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width, device=device)
        if cfg.positional_embedding:
            self.positional_embedding = nn.Parameter(
                torch.empty(cfg.context_length, cfg.width, device=device))
        else:
            self.positional_embedding = None
        self.transformer = Transformer(
            width=cfg.width, layers=cfg.layers, heads=cfg.heads, causal=True,
            remat=cfg.remat, dtype=dtype, use_flash=cfg.use_flash,
            fused_attn=cfg.fused_attn, fused_attn_group=cfg.fused_attn_group,
            fused_attn_sample_group=cfg.fused_attn_sample_group,
            fused_attn_bwd_fuse3=cfg.fused_attn_bwd_fuse3,
            fused_attn_group_bwd=cfg.fused_attn_group_bwd,
            fused_attn_sample_group_bwd=cfg.fused_attn_sample_group_bwd,
            attn_layout=cfg.attn_layout, unroll=cfg.unroll, device=device)
        self.ln_final = LayerNorm(cfg.width, dtype=dtype, device=device)
        self.text_projection = Linear(cfg.width, cfg.embed_dim, dtype=dtype, device=device)

    def init_weights(self, generator=None):
        scaled_normal(self.token_embedding.weight, 0.02, generator)
        if self.positional_embedding is not None:
            scaled_normal(self.positional_embedding, 0.01, generator)
        scaled_normal(self.text_projection.weight, self.cfg.width ** -0.5, generator)
        torch_bias_uniform(self.text_projection.bias, self.cfg.width, generator)

    def words(self, tokens: torch.Tensor, return_attn: bool = False):
        """``words`` [B, ctx, W]: ln_final over all tokens, the FDT input (and,
        with ``return_attn``, the per-layer attention probabilities
        [L, B, ctx, ctx]). Eager PyTorch runs every output it is asked for,
        so the codebook path calls this and skips the projections
        ``forward`` adds."""
        x = self.token_embedding(tokens).to(self.dtype)
        if self.positional_embedding is not None:
            x = x + self.positional_embedding[: x.shape[1]].to(self.dtype)
        if return_attn:
            x, _, attn = self.transformer(x, return_attn_weights=True)
            return self.ln_final(x), attn
        return self.ln_final(self.transformer(x))

    def forward(self, tokens: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                return_attn: bool = False) -> dict:
        """tokens: int [B, ctx]; pad_mask: float [B, ctx] (0 real / -inf pad),
        passed through. Returns ``embed`` [B, E], ``words`` [B, ctx, W],
        ``words_proj``, ``pooled_raw`` [B, W] (EOT feature); ``return_attn``
        adds ``attn_weights`` [L, B, ctx, ctx] (each layer's head-averaged
        attention probabilities, fp32, from the plain path)."""
        words = self.words(tokens, return_attn)
        if return_attn:
            words, attn = words
        eot = tokens.argmax(dim=-1)
        pooled_raw = words[torch.arange(words.shape[0], device=words.device), eot]
        out = {"embed": self.text_projection(pooled_raw), "words": words,
               "words_proj": self.text_projection(words), "pooled_raw": pooled_raw,
               "pad_mask": pad_mask}
        if return_attn:
            out["attn_weights"] = attn
        return out


def text_base(embed_dim=512, **kw) -> TextConfig:
    return TextConfig(**{**dict(width=512, heads=8, layers=12, embed_dim=embed_dim), **kw})
