"""Config system: YAML -> attribute-accessible nested dicts.

A copy of ``iterated_learning_for_vlm_tpu/utils/config.py`` (reference
``prototype/utils/misc.py:64-69`` ``parse_config`` and the nested schema of
``example/clip_fdt/config_cc3m.yaml``). ``yaml`` is imported by
:func:`load_config` only, so a config built from a dict needs no PyYAML.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Mapping


class Config(dict):
    """A dict whose items are also attributes, recursively."""

    def __init__(self, d: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = _wrap(v)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def _wrap(v):
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def load_config(path: str) -> Config:
    """Load a YAML config file into a :class:`Config`."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return Config(raw or {})


# Alias matching the reference's name (`parse_config`).
parse_config = load_config


def merge_overrides(cfg: Config, overrides: Mapping[str, Any]) -> Config:
    """Apply dotted-key overrides (e.g. ``{"data.train.batch_size": 64}``)."""
    for dotted, value in overrides.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            if p not in node:
                node[p] = Config()
            node = node[p]
        node[leaf] = value
    return cfg
