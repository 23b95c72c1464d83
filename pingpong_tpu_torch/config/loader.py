"""YAML config loading with dotted-path CLI overrides.

The reference's interface is editing YAML / in-file dicts by hand
(``config.yaml``, ``config_rnn.yaml``, plus Python-dict
configs in its eval tools). Here a single typed tree
(:class:`~pingpong_tpu_torch.config.schema.ExperimentConfig`) is loaded from YAML
and can be overridden from the command line as ``key.path=value`` pairs,
e.g. ``dqn.num_envs=8192 env.max_score=5``.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Optional, Union

import yaml

from pingpong_tpu_torch.config.schema import ExperimentConfig, experiment_from_dict


def load_config(path: Optional[Union[str, Path]] = None) -> ExperimentConfig:
    """Load an :class:`ExperimentConfig` from a YAML file (or defaults)."""
    if path is None:
        return ExperimentConfig()
    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    return experiment_from_dict(data)


def _parse_value(text: str):
    # YAML-style booleans first: ast.literal_eval only accepts Python's
    # True/False, so "dqn.use_pallas_update=false" used to fall through
    # to the TRUTHY STRING "false" and silently leave the flag on
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # bare string


def apply_overrides(cfg: ExperimentConfig, overrides: Iterable[str]) -> ExperimentConfig:
    """Apply ``a.b.c=value`` overrides, returning a new config."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must look like key.path=value, got {item!r}")
        path, _, raw = item.partition("=")
        keys = path.strip().split(".")
        value = _parse_value(raw.strip())
        cfg = _replace_path(cfg, keys, value)
    return cfg


def _replace_path(node, keys, value):
    if len(keys) == 1:
        if not any(f.name == keys[0] for f in dataclasses.fields(node)):
            raise KeyError(f"unknown config field {keys[0]!r} on {type(node).__name__}")
        old = getattr(node, keys[0])
        if isinstance(old, bool) and not isinstance(value, bool):
            raise ValueError(
                f"config field {keys[0]!r} is boolean; got {value!r} "
                "(use true/false)"
            )
        return dataclasses.replace(node, **{keys[0]: value})
    child = getattr(node, keys[0])
    return dataclasses.replace(node, **{keys[0]: _replace_path(child, keys[1:], value)})


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
