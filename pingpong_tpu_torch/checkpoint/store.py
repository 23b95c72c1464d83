"""Checkpoint store: versioned, crash-safe training-state persistence.

Plays the role of the reference's ``torch.save``/``torch.load`` checkpoint
machinery (QNet format ``{modelB, optimizer, epsilon, episode, modelA}``,
``scripts/train_iterative.py:272-295``; RNN formats incl.
``latest_rnn_training_state.pth`` full-state autosave and ``.error_backup``
fallback, ``train_rnn_iterative.py:630-667``), redesigned:

* a checkpoint is a directory ``<name>/`` holding ``arrays.npz`` (every
  array leaf, keys are tree paths) + ``meta.json`` (scalars, schema
  version, generation metadata) — dependency-free, inspectable, and
  byte-stable;
* writes are atomic: written to ``<name>.tmp-<pid>`` then ``os.replace``d,
  the crash-safety upgrade over the reference's ``.error_backup`` retry;
* this is a copy of the JAX package's store: the npz + ``meta.json``
  schema is the interchange format, so a checkpoint written by either
  package loads in the other.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict

import numpy as np

SCHEMA_VERSION = 1


def _flatten(prefix: str, node, out: Dict[str, np.ndarray], meta: Dict[str, Any]):
    if isinstance(node, dict):
        meta_node: Dict[str, Any] = {"__type__": "dict", "keys": list(node.keys())}
        meta[prefix] = meta_node
        for k, v in node.items():
            _flatten(f"{prefix}.{k}" if prefix else k, v, out, meta)
    elif isinstance(node, (list, tuple)):
        meta[prefix] = {"__type__": "list", "len": len(node)}
        for i, v in enumerate(node):
            _flatten(f"{prefix}[{i}]", v, out, meta)
    elif node is None:
        meta[prefix] = {"__type__": "none"}
    elif isinstance(node, (int, float, str, bool)):
        meta[prefix] = {"__type__": "scalar", "value": node}
    else:
        arr = np.asarray(node)
        out[prefix] = arr
        meta[prefix] = {"__type__": "array"}


def _unflatten(prefix: str, meta: Dict[str, Any], arrays) -> Any:
    info = meta[prefix]
    t = info["__type__"]
    if t == "dict":
        return {
            k: _unflatten(f"{prefix}.{k}" if prefix else k, meta, arrays)
            for k in info["keys"]
        }
    if t == "list":
        return [_unflatten(f"{prefix}[{i}]", meta, arrays) for i in range(info["len"])]
    if t == "none":
        return None
    if t == "scalar":
        return info["value"]
    if t == "array":
        return arrays[prefix]
    raise ValueError(f"bad node type {t}")


def save_checkpoint(path: os.PathLike, payload: Dict[str, Any]) -> Path:
    """Atomically write ``payload`` (nested dict of arrays/scalars)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    _flatten("", payload, arrays, meta)
    np.savez(tmp / "arrays.npz", **arrays)
    with open(tmp / "meta.json", "w") as f:
        json.dump({"schema_version": SCHEMA_VERSION, "tree": meta}, f)
    # Keep one valid checkpoint on disk at all times: move the old one
    # aside atomically, swap the new one in, then drop the old copy. A
    # crash between the two replaces leaves either <name> or <name>.old
    # intact (load falls back via the caller's restore tiers).
    old = path.with_name(path.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    if path.exists():
        os.replace(path, old)
    os.replace(tmp, path)
    if old.exists():
        shutil.rmtree(old)
    return path


def load_checkpoint(path: os.PathLike) -> Dict[str, Any]:
    path = Path(path)
    with open(path / "meta.json") as f:
        header = json.load(f)
    if header.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint {path} has schema {header.get('schema_version')}, "
            f"expected {SCHEMA_VERSION}"
        )
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return _unflatten("", header["tree"], arrays)


def is_checkpoint(path: os.PathLike) -> bool:
    p = Path(path)
    return (p / "meta.json").is_file() and (p / "arrays.npz").is_file()


def list_checkpoints(ckpt_dir: os.PathLike) -> list:
    """All checkpoint directories under ``ckpt_dir``, sorted by name."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(p for p in d.iterdir() if p.is_dir() and is_checkpoint(p))
