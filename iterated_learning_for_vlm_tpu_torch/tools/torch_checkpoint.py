"""Weight bridge: JAX param tree -> the port's ``state_dict``.

The reverse of ``iterated_learning_for_vlm_tpu/tools/torch_checkpoint.py``'s
``convert_reference_state_dict``. The port's module names are the reference
PyTorch layout that converter reads, so a port ``state_dict`` goes to JAX
params through it unchanged, and this module goes the other way:

- scan-stacked ``[L, ...]`` leaves -> ``resblocks.{i}.*``;
- Dense ``kernel [in, out]`` -> ``weight [out, in]`` (also the packed
  ``in_proj/kernel [D, 3D]`` -> ``in_proj_weight [3D, D]``);
- conv ``kernel`` HWIO -> OIHW;
- LayerNorm ``norm/{scale,bias}`` -> ``weight``/``bias``; bare params as they are.

The table covers the CLIP tree (``visual``, ``text``, ``logit_scale``) and
the CLIP-FDT tree (the same, plus ``space_dict``, the query heads and
``logit_scale_sd``), and a Swin v1 / Swin-MoE / Swin v2 ``visual`` tree (flax
``stage{s}_block{b}`` / ``merge{s}`` modules -> the port's Microsoft-Swin names
``layers.{s}.blocks.{b}`` / ``layers.{s}.downsample``; the experts' stacked
``w1 [E, d, h]``, ``b1``, ``w2``, ``b2`` as they are; v2's per-head
``attn/logit_scale [H, 1, 1]`` as it is, its ``attn/cpb_fc{1,2}`` Dense
layers -> ``attn.cpb_mlp.{0,2}``).

Any tree with the params' structure crosses the same way: gradients, and the
AdamW ``mu`` / ``nu`` moments. The per-leaf AdamW ``count`` is a scalar per
leaf, also for a layer-stacked one; ``layers`` gives each tower's depth so
that scalar goes to every layer.

:func:`jax_path` goes back from a port name to its JAX path, so decisions the
JAX package takes on flax names (weight-decay categories, freezing, the IL
reset rules) are taken the same way for the port's parameters.

Pure numpy: the params arrive as nested dicts of arrays (``np.asarray`` of
each JAX leaf), so this needs neither jax nor flax.

:func:`_openai_to_reference_keys` and :func:`_looks_like_openai_layout` are
copies of the JAX module's: the OpenAI/open_clip state-dict layout renamed to
the reference one, which ``eval/model_loader.py`` loads.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

# flax path below .../transformer/resblocks/ -> torch suffix within a block
_BLOCK_MAP = {
    ("attn", "in_proj", "kernel"): "attn.in_proj_weight",
    ("attn", "in_proj", "bias"): "attn.in_proj_bias",
    ("attn", "out_proj", "kernel"): "attn.out_proj.weight",
    ("attn", "out_proj", "bias"): "attn.out_proj.bias",
    ("ln_1", "norm", "scale"): "ln_1.weight",
    ("ln_1", "norm", "bias"): "ln_1.bias",
    ("ln_2", "norm", "scale"): "ln_2.weight",
    ("ln_2", "norm", "bias"): "ln_2.bias",
    ("mlp", "c_fc", "kernel"): "mlp.c_fc.weight",
    ("mlp", "c_fc", "bias"): "mlp.c_fc.bias",
    ("mlp", "c_proj", "kernel"): "mlp.c_proj.weight",
    ("mlp", "c_proj", "bias"): "mlp.c_proj.bias",
}

_TOWERS = {"visual": "visual", "text": "encode_text"}

_TOP_MAP = {
    ("visual", "conv1", "kernel"): "visual.conv1.weight",
    ("visual", "class_embedding"): "visual.class_embedding",
    ("visual", "positional_embedding"): "visual.positional_embedding",
    ("visual", "ln_pre", "norm", "scale"): "visual.ln_pre.weight",
    ("visual", "ln_pre", "norm", "bias"): "visual.ln_pre.bias",
    ("visual", "ln_post", "norm", "scale"): "visual.ln_post.weight",
    ("visual", "ln_post", "norm", "bias"): "visual.ln_post.bias",
    ("visual", "proj"): "visual.proj",
    ("text", "token_embedding", "embedding"): "encode_text.token_embedding.weight",
    ("text", "positional_embedding"): "encode_text.positional_embedding",
    ("text", "ln_final", "norm", "scale"): "encode_text.ln_final.weight",
    ("text", "ln_final", "norm", "bias"): "encode_text.ln_final.bias",
    ("text", "text_projection", "kernel"): "encode_text.text_projection.weight",
    ("text", "text_projection", "bias"): "encode_text.text_projection.bias",
    ("logit_scale",): "logit_scale",
    ("logit_scale_sd",): "logit_scale_sd",
    ("space_dict",): "space_dict",
}
for _root, _side in (("img_query", "img_query_model"), ("txt_query", "txt_query_model")):
    _TOP_MAP.update({
        (_root, "ln_1", "norm", "scale"): f"{_side}.q_map.0.weight",
        (_root, "ln_1", "norm", "bias"): f"{_side}.q_map.0.bias",
        (_root, "fc_1", "kernel"): f"{_side}.q_map.1.weight",
        (_root, "fc_1", "bias"): f"{_side}.q_map.1.bias",
        (_root, "ln_2", "norm", "scale"): f"{_side}.q_map.3.weight",
        (_root, "ln_2", "norm", "bias"): f"{_side}.q_map.3.bias",
        (_root, "fc_2", "kernel"): f"{_side}.q_map.4.weight",
        (_root, "fc_2", "bias"): f"{_side}.q_map.4.bias",
    })


# Swin: flax path below visual/stage{s}_block{b}/ -> torch suffix within a block
_SWIN_BLOCK_MAP = {
    ("attn", "qkv", "kernel"): "attn.qkv.weight",
    ("attn", "qkv", "bias"): "attn.qkv.bias",
    ("attn", "proj", "kernel"): "attn.proj.weight",
    ("attn", "proj", "bias"): "attn.proj.bias",
    ("attn", "relative_position_bias_table"): "attn.relative_position_bias_table",
    ("mlp_fc1", "kernel"): "mlp.fc1.weight",
    ("mlp_fc1", "bias"): "mlp.fc1.bias",
    ("mlp_fc2", "kernel"): "mlp.fc2.weight",
    ("mlp_fc2", "bias"): "mlp.fc2.bias",
    ("moe_mlp", "gate", "kernel"): "mlp.gate.weight",
    ("moe_mlp", "w1"): "mlp.w1",
    ("moe_mlp", "b1"): "mlp.b1",
    ("moe_mlp", "w2"): "mlp.w2",
    ("moe_mlp", "b2"): "mlp.b2",
    ("attn", "logit_scale"): "attn.logit_scale",
    ("attn", "cpb_fc1", "kernel"): "attn.cpb_mlp.0.weight",
    ("attn", "cpb_fc1", "bias"): "attn.cpb_mlp.0.bias",
    ("attn", "cpb_fc2", "kernel"): "attn.cpb_mlp.2.weight",
}
for _ln in ("norm1", "norm2"):
    _SWIN_BLOCK_MAP[(_ln, "norm", "scale")] = f"{_ln}.weight"
    _SWIN_BLOCK_MAP[(_ln, "norm", "bias")] = f"{_ln}.bias"
_SWIN_MERGE_MAP = {("norm", "norm", "scale"): "downsample.norm.weight",
                   ("norm", "norm", "bias"): "downsample.norm.bias",
                   ("reduction", "kernel"): "downsample.reduction.weight"}
_TOP_MAP.update({
    ("visual", "patch_embed", "kernel"): "visual.patch_embed.proj.weight",
    ("visual", "patch_embed", "bias"): "visual.patch_embed.proj.bias",
    ("visual", "patch_norm", "norm", "scale"): "visual.patch_embed.norm.weight",
    ("visual", "patch_norm", "norm", "bias"): "visual.patch_embed.norm.bias",
    ("visual", "norm", "norm", "scale"): "visual.norm.weight",
    ("visual", "norm", "norm", "bias"): "visual.norm.bias",
})
_SWIN_MODULE = re.compile(r"^(?:stage(\d+)_block(\d+)|merge(\d+))$")
_SWIN_NAME = re.compile(r"^visual\.layers\.(\d+)\.(?:blocks\.(\d+)\.(.+)|(downsample\..+))$")


def _swin_torch_name(path: tuple) -> Optional[str]:
    """The port name of a flax Swin block or merge leaf, else None."""
    if len(path) < 3 or path[0] != "visual":
        return None
    m = _SWIN_MODULE.match(path[1])
    if m is None:
        return None
    if m.group(1) is not None:
        suffix = _SWIN_BLOCK_MAP.get(path[2:])
        return None if suffix is None else f"visual.layers.{m.group(1)}.blocks.{m.group(2)}.{suffix}"
    suffix = _SWIN_MERGE_MAP.get(path[2:])
    return None if suffix is None else f"visual.layers.{m.group(3)}.{suffix}"


_SWIN_BLOCK_INV = {name: path for path, name in _SWIN_BLOCK_MAP.items()}
_SWIN_MERGE_INV = {name: path for path, name in _SWIN_MERGE_MAP.items()}


def _swin_jax_path(name: str) -> Optional[Tuple[str, ...]]:
    m = _SWIN_NAME.match(name)
    if m is None:
        return None
    if m.group(2) is not None:
        suffix = _SWIN_BLOCK_INV.get(m.group(3))
        return None if suffix is None else ("visual", f"stage{m.group(1)}_block{m.group(2)}") + suffix
    suffix = _SWIN_MERGE_INV.get(m.group(4))
    return None if suffix is None else ("visual", f"merge{m.group(1)}") + suffix


_TOP_INV = {name: path for path, name in _TOP_MAP.items()}
_BLOCK_INV = {name: path for path, name in _BLOCK_MAP.items()}
_TOWERS_INV = {name: root for root, name in _TOWERS.items()}


def jax_path(name: str) -> Tuple[str, ...]:
    """The JAX param path of a port parameter (CLIP or CLIP-FDT); for a
    transformer block's parameter, the path of the layer-stacked leaf (no
    layer index)."""
    if name in _TOP_INV:
        return _TOP_INV[name]
    parts = name.split(".")
    if len(parts) > 4 and parts[0] in _TOWERS_INV and parts[1:3] == ["transformer", "resblocks"]:
        suffix = _BLOCK_INV.get(".".join(parts[4:]))
        if suffix is not None:
            return (_TOWERS_INV[parts[0]], "transformer", "resblocks") + suffix
    swin = _swin_jax_path(name)
    if swin is not None:
        return swin
    raise KeyError(f"no JAX path for port parameter {name}")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[tuple, np.ndarray]:
    out: Dict[tuple, np.ndarray] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _to_torch_layout(path: tuple, value: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if path[-1] == "kernel" and value.ndim == 2:
        return value.T  # [in, out] -> [out, in]
    return value


def state_dict_from_jax_params(params: Mapping[str, Any],
                               layers: Optional[Mapping[str, int]] = None
                               ) -> Dict[str, np.ndarray]:
    """CLIP or CLIP-FDT JAX params (ViT towers), or a tree of the same
    structure (nested dicts of arrays), -> port ``state_dict`` arrays
    (float32, C-ordered copies). A CLIP tree has ``visual``, ``text`` and
    ``logit_scale``; CLIP-FDT adds the codebook, the query heads and
    ``logit_scale_sd``.
    ``layers`` (JAX tower root -> depth, e.g. ``{"visual": 12, "text": 12}``)
    is needed only for a tree of per-leaf scalars such as the AdamW count.
    Raises on a leaf it cannot place, so a param-tree change cannot be
    dropped silently."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params).items():
        if len(path) > 3 and path[1:3] == ("transformer", "resblocks") and path[0] in _TOWERS:
            suffix = _BLOCK_MAP.get(path[3:])
            if suffix is None:
                raise KeyError(f"no torch name for JAX param {'/'.join(path)}")
            if value.ndim == 0:  # one scalar for the whole stack
                if layers is None or path[0] not in layers:
                    raise KeyError(f"a scalar for the stacked leaf {'/'.join(path)} "
                                   f"needs layers[{path[0]!r}]")
                value = np.broadcast_to(value, (layers[path[0]],))
            for i, layer in enumerate(value):
                out[f"{_TOWERS[path[0]]}.transformer.resblocks.{i}.{suffix}"] = (
                    _to_torch_layout(path, layer))
        elif path in _TOP_MAP:
            out[_TOP_MAP[path]] = _to_torch_layout(path, value)
        elif _swin_torch_name(path) is not None:
            out[_swin_torch_name(path)] = _to_torch_layout(path, value)
        else:
            raise KeyError(f"no torch name for JAX param {'/'.join(path)}")
    return {k: np.array(v, dtype=np.float32, order="C") for k, v in out.items()}


def load_jax_params(model, params: Mapping[str, Any]):
    """Load JAX params into a port model (``CLIP`` or ``CLIPFDT``) in place,
    on whatever device it lives (strict: every key must match)."""
    import torch

    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def _openai_to_reference_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Rename an OpenAI/open_clip CLIP state dict to the reference layout
    (a copy of JAX ``tools/torch_checkpoint.py:_openai_to_reference_keys``,
    on torch tensors).

    Official CLIP (and open_clip "quickgelu" models) keep the text tower's
    keys unprefixed (``transformer.resblocks...``, ``token_embedding.weight``,
    ``ln_final.*``) and ``text_projection`` is a bare ``[width, embed]``
    parameter (``x @ text_projection``, no bias), where the reference has the
    ``encode_text.`` prefix and a Linear text projection.
    """
    import torch

    out: Dict[str, Any] = {}
    for key, value in sd.items():
        if key.startswith(("visual.", "encode_text.")) or key in (
                "logit_scale", "logit_scale_sd", "space_dict"):
            out[key] = value
        elif key == "text_projection":
            # bare [width, embed]: its transpose is the Linear weight [out, in];
            # the bias is zero
            out["encode_text.text_projection.weight"] = value.T.contiguous()
            out["encode_text.text_projection.bias"] = torch.zeros(value.shape[1],
                                                                  dtype=value.dtype)
        elif key.startswith(("transformer.", "token_embedding.",
                             "ln_final.")) or key == "positional_embedding":
            out["encode_text." + key] = value
        else:  # BN buffers, attn_mask buffers, etc.: the loader drops them
            out[key] = value
    return out


def _looks_like_openai_layout(sd: Mapping[str, Any]) -> bool:
    return ("token_embedding.weight" in sd
            and not any(k.startswith("encode_text.") for k in sd))
