"""Model registry of the PyTorch port.

Counterpart of ``iterated_learning_for_vlm_tpu/models/__init__.py``:
``model_entry(config)`` takes the same nested config mapping (``type`` and
``kwargs`` with ``image_encode`` / ``text_encode`` / ``fdt`` blocks and the
tower-wide knobs) and returns an ``nn.Module`` whose parameters live on
``device`` and are drawn from ``generator``. With no ``device`` the model is
built on the CUDA card, and building raises where there is none: the CPU
takes it only when asked (``device="cpu"``). Ported so far: the baseline
``clip_vitb32`` and ``clip_vitb16``, ``clip_vitb32_auxilary`` (the same
model: the towers give attention maps on request, ``return_attn``) and
``clip_fdt_vitb32`` / ``clip_fdt_vitb16``; the other JAX model types raise a
``KeyError`` that says so.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from .clip import CLIP
from .fdt import CLIPFDT, FDTConfig, QueryModel
from .layers import init_module_tree
from .sparsemax import sparsemax, sparsemax_bisect
from .text import TextConfig, TextTransformer, text_base
from .vit import VisionConfig, VisionTransformer, vit_b16, vit_b32

__all__ = [
    "CLIP", "CLIPFDT", "FDTConfig", "QueryModel", "TextConfig", "TextTransformer",
    "VisionConfig", "VisionTransformer", "model_entry", "resolve_device", "sparsemax",
    "sparsemax_bisect",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "fp32": torch.float32}

# model types of the JAX package that the port does not build yet
UNPORTED = (
    "clip_vitL14", "clip_vitL16", "clip_res50", "clip_res101",
    "clip_swinB_v2", "clip_swinL", "clip_swinL_v2", "clip_swinMoE_B", "clip_swinMLP_B",
    "clip_swin_yaml", "clip_fdt_swinB_v2", "clip_vitb32_sp", "clip_fdt_sp_vitb32",
    "declip_fdt_vitb32", "defilip_fdt_vitb32",
)


def _common(kwargs: Mapping[str, Any]):
    """The JAX ``_common`` knob parsing: tower-wide knobs become per-tower
    defaults, so an ``image_encode`` / ``text_encode`` key overrides its
    tower-wide value (``image_encode: {use_flash: true}`` puts one tower on
    flash attention). The TPU-only knobs still parse; the towers ignore them."""
    img_kw = dict(kwargs.get("image_encode", {}))
    txt_kw = dict(kwargs.get("text_encode", {}))
    for dead in ("bpe_path", "text_encode_type", "text_model_utils"):
        txt_kw.pop(dead, None)
    dtype = _DTYPES[str(kwargs.get("dtype", "float32"))]
    shared = {
        "remat": bool(kwargs.get("remat", False)),
        "use_flash": bool(kwargs.get("use_flash", False)),
        "fused_attn": bool(kwargs.get("fused_attn", False)),
        "fused_attn_group": int(kwargs.get("fused_attn_group", 2)),
        "fused_attn_sample_group": int(kwargs.get("fused_attn_sample_group", 2)),
        "fused_attn_bwd_fuse3": bool(kwargs.get("fused_attn_bwd_fuse3", False)),
        "fused_attn_group_bwd": kwargs.get("fused_attn_group_bwd"),
        "fused_attn_sample_group_bwd": kwargs.get("fused_attn_sample_group_bwd"),
        "unroll": bool(kwargs.get("unroll", False)),
        "attn_layout": str(kwargs.get("attn_layout", "bhqk")),
    }
    for kw in (img_kw, txt_kw):
        for key, value in shared.items():
            kw.setdefault(key, value)
    return img_kw, txt_kw, dtype


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None; raises where CUDA is
    absent and no device was named, so nothing lands on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds its models on the GPU; "
                           "pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def _clip(vision_factory, kw, device) -> CLIP:
    """The ``clip`` block (``use_allgather``) is read by nothing: the loss
    gathers the global batch."""
    img_kw, txt_kw, dtype = _common(kw)
    return CLIP(vision_cfg=vision_factory(**img_kw), text_cfg=text_base(**txt_kw),
                dtype=dtype, device=resolve_device(device))


def clip_vitb32(device=None, **kw) -> CLIP:
    return _clip(vit_b32, kw, device)


def clip_vitb16(device=None, **kw) -> CLIP:
    return _clip(vit_b16, kw, device)


def clip_vitb32_auxilary(device=None, **kw) -> CLIP:
    """Reference ``clip_vitb32_auxilary`` (the towers with attention-probs
    hooks): here ``clip_vitb32`` itself, whose towers return the maps on
    request (``return_attn=True``); checkpoints are interchangeable."""
    return _clip(vit_b32, kw, device)


def _clip_fdt(vision_factory, kw, device) -> CLIPFDT:
    img_kw, txt_kw, dtype = _common(kw)
    fdt_kw = dict(kw.get("fdt", {}))
    fdt_kw.pop("use_allgather", None)
    return CLIPFDT(vision_cfg=vision_factory(**img_kw), text_cfg=text_base(**txt_kw),
                   fdt_cfg=FDTConfig(**fdt_kw), dtype=dtype, device=resolve_device(device))


def clip_fdt_vitb32(device=None, **kw) -> CLIPFDT:
    return _clip_fdt(vit_b32, kw, device)


def clip_fdt_vitb16(device=None, **kw) -> CLIPFDT:
    """ViT-B/16 image tower: T=196 codebook tokens (K1 takes any T) and S=197,
    past K2's 128, so on the card its attention runs on K3 only with
    ``image_encode: {use_flash: true}``."""
    return _clip_fdt(vit_b16, kw, device)


_REGISTRY = {"clip_vitb32": clip_vitb32, "clip_vitb16": clip_vitb16,
             "clip_vitb32_auxilary": clip_vitb32_auxilary,
             "clip_fdt_vitb32": clip_fdt_vitb32, "clip_fdt_vitb16": clip_fdt_vitb16}


def model_entry(config, device=None, generator: Optional[torch.Generator] = None):
    """``config``: a mapping with ``type`` and ``kwargs`` (reference schema).
    Parameters are created on ``device`` (default: the CUDA card, see
    :func:`resolve_device`) and drawn from ``generator`` (a generator on that
    device; default: seeded with 0)."""
    mtype = config["type"] if isinstance(config, Mapping) else config.type
    kwargs = dict(config.get("kwargs", {}))
    if mtype not in _REGISTRY:
        if mtype in UNPORTED:
            raise KeyError(f"model type {mtype!r} is not ported to the PyTorch package "
                           f"yet; ported: {sorted(_REGISTRY)}")
        raise KeyError(f"unknown model type {mtype!r}; ported: {sorted(_REGISTRY)}")
    device = resolve_device(device)
    model = _REGISTRY[mtype](device=device, **kwargs)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return init_module_tree(model, generator)
