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

Pure numpy: the params arrive as nested dicts of arrays (``np.asarray`` of
each JAX leaf), so this needs neither jax nor flax.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """CLIP-FDT JAX params (nested dicts of arrays) -> port ``state_dict``
    arrays (float32, C-ordered copies). Raises on a leaf it cannot place, so a
    param-tree change cannot be dropped silently."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params).items():
        if len(path) > 3 and path[1:3] == ("transformer", "resblocks") and path[0] in _TOWERS:
            suffix = _BLOCK_MAP.get(path[3:])
            if suffix is None:
                raise KeyError(f"no torch name for JAX param {'/'.join(path)}")
            for i, layer in enumerate(value):
                out[f"{_TOWERS[path[0]]}.transformer.resblocks.{i}.{suffix}"] = (
                    _to_torch_layout(path, layer))
        elif path in _TOP_MAP:
            out[_TOP_MAP[path]] = _to_torch_layout(path, value)
        else:
            raise KeyError(f"no torch name for JAX param {'/'.join(path)}")
    return {k: np.array(v, dtype=np.float32, order="C") for k, v in out.items()}


def load_jax_params(model, params: Mapping[str, Any]):
    """Load JAX params into a port model in place, on whatever device it
    lives (strict: every key must match)."""
    import torch

    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_jax_params(params).items()}
    model.load_state_dict(sd, strict=True)
    return model
