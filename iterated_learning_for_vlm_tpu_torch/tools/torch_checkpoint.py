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
``logit_scale_sd``).

Any tree with the params' structure crosses the same way: gradients, and the
AdamW ``mu`` / ``nu`` moments. The per-leaf AdamW ``count`` is a scalar per
leaf, also for a layer-stacked one; ``layers`` gives each tower's depth so
that scalar goes to every layer.

:func:`jax_path` goes back from a port name to its JAX path, so decisions the
JAX package takes on flax names (weight-decay categories, freezing, the IL
reset rules) are taken the same way for the port's parameters.

Pure numpy: the params arrive as nested dicts of arrays (``np.asarray`` of
each JAX leaf), so this needs neither jax nor flax.
"""
from __future__ import annotations

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
