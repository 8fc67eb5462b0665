"""Eval-side model loading (training checkpoints -> ``TorchEncoder``).

Counterpart of ``iterated_learning_for_vlm_tpu/eval/model_loader.py``
(reference ``CLIP_benchmark/clip_benchmark/models/fdt.py``, ``load_fdt`` /
``MyModelZoo``): build the training-side model from its YAML config, load a
checkpoint (or a list of checkpoints averaged into a weight soup, fdt.py:28-40)
and expose ``encode_images`` / ``encode_texts``.

The port reads torch-format checkpoints only: its own ``ckpt_N.pth.tar``
(``train/checkpoint.py``) and reference or OpenAI/open_clip ``.pth`` /
``.pth.tar`` / ``.pt`` state dicts. A JAX (Orbax) checkpoint directory is
refused. The model is built on ``device``, the CUDA card by default
(``models.resolve_device``). ``ja_clip`` / ``nllb_clip`` load a local HF
``save_pretrained`` directory through ``eval/hf_adapter.py`` instead.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Sequence, Union

import torch

from ..models import model_entry
from ..tools.torch_checkpoint import _looks_like_openai_layout, _openai_to_reference_keys
from ..train.checkpoint import load_checkpoint, restore_params_soup
from ..utils.config import Config, load_config
from .encode import TorchEncoder

_TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt")


def is_spectral_norm_type(model_type: str) -> bool:
    """JAX ``models/__init__.py:is_spectral_norm_type``."""
    return "_sp" in model_type or model_type.startswith("sp_")


def read_state_dict(path: str, layout: str = "auto") -> Dict[str, torch.Tensor]:
    """The model weights of a torch checkpoint file on the host, renamed from
    the OpenAI/open_clip layout when ``layout`` is ``"openai"``, or ``"auto"``
    and the keys look like it (JAX ``load_reference_checkpoint``'s rule)."""
    path = str(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (a JAX Orbax checkpoint?): the PyTorch port "
                         f"reads torch-format checkpoints only ({', '.join(_TORCH_SUFFIXES)})")
    sd = load_checkpoint(path)["model"]
    if layout == "openai" or (layout == "auto" and _looks_like_openai_layout(sd)):
        sd = _openai_to_reference_keys(sd)
    return sd


def load_eval_encoder(
    config: Union[str, Config],
    checkpoint: Optional[Union[str, Sequence[str]]] = None,
    batch_size: int = 64,
    transform: str = "ONECROP",
    sd_temperature: Optional[float] = None,
    model_type: str = "cust_clip",
    amp: bool = True,
    normalize: bool = True,
    num_workers: int = 4,
    data_parallel: bool = False,
    language: str = "en",
    encoder: Optional[TorchEncoder] = None,
    device=None,
) -> TorchEncoder:
    """``checkpoint``: a torch checkpoint file, a list of them (their mean, a
    weight soup), or None (random init from a generator seeded 0).

    ``sd_temperature`` overrides the config's FDT codebook temperature, so a
    checkpoint trained with T decay is scored at its final T. ``amp=False``
    forces fp32 towers (reference ``--no_amp``); the kernel knobs then take
    the plain path. ``model_type="open_clip"`` forces the OpenAI/open_clip key
    rename; ``cust_clip`` detects that layout. ``encoder``: a
    ``TorchEncoder`` from an earlier call (same config) whose model takes the
    new weights in place. ``ja_clip`` / ``nllb_clip``: ``checkpoint`` is one
    local HF ``save_pretrained`` directory, ``config`` is unused and
    ``language`` sets the NLLB tokenizer's source language. ``data_parallel``:
    in a process group, every rank encodes its slice of each batch
    (``TorchEncoder``); the HF types run whole batches on every rank."""
    if model_type in ("ja_clip", "nllb_clip"):
        from .hf_adapter import HFClipEncoder

        if not checkpoint or isinstance(checkpoint, (list, tuple)):
            raise ValueError(f"--model_type {model_type} needs --pretrained pointing at ONE "
                             "local HF save_pretrained directory")
        return HFClipEncoder(str(checkpoint), model_type=model_type, batch_size=batch_size,
                             normalize=normalize, language=language, device=device)
    if encoder is not None:
        model = encoder.model
    else:
        # deep-copy a Config: the overrides below must not reach the caller's
        cfg = load_config(config) if isinstance(config, str) else copy.deepcopy(config)
        if is_spectral_norm_type(str(cfg.model.type)):
            raise NotImplementedError(f"model type {cfg.model.type!r}: spectral norm is not "
                                      "ported (ROADMAP.md Queue 1 item 6)")
        if not amp:
            cfg.model["kwargs"] = {**cfg.model.get("kwargs", {}), "dtype": "float32"}
        if sd_temperature is not None:
            kwargs = cfg.model.get("kwargs", {})
            if "fdt" in kwargs:
                kwargs["fdt"]["sd_temperature"] = float(sd_temperature)
        model = model_entry(cfg.model, device=device)
    layout = "openai" if model_type == "open_clip" else "auto"

    if checkpoint is not None:
        paths = list(checkpoint) if isinstance(checkpoint, (list, tuple)) else [checkpoint]
        if len(paths) > 1:
            sd = restore_params_soup(paths, load=lambda p: read_state_dict(p, layout))
        else:
            sd = read_state_dict(paths[0], layout)
        # keys outside the model (BN or attn-mask buffers of a foreign layout)
        # are dropped, as JAX's converter skips them; a missing key raises
        names = set(model.state_dict())
        with torch.no_grad():
            model.load_state_dict({k: v for k, v in sd.items() if k in names}, strict=True)

    if encoder is not None:
        if sd_temperature is not None and encoder.is_fdt:
            encoder.sd_temperature = float(sd_temperature)
        return encoder
    return TorchEncoder(model, batch_size=batch_size, transform=transform, normalize=normalize,
                        num_workers=num_workers, sd_temperature=sd_temperature,
                        data_parallel=data_parallel)
