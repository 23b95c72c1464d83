"""Opponent-pool loading (port of ``pingpong_tpu/selfplay/pool.py``).

As in the reference trainers, the QNet trainer loads every checkpoint in
the directory at start-up, ``_fault`` ones included (so does the Rainbow
trainer, ``kind="rainbow"``), and the DRQN trainer (``kind="qnet_rnn",
skip_fault=True``) skips fault checkpoints; ``latest*`` full-state
autosaves are skipped by all."""

from __future__ import annotations

from typing import List, Optional

from pingpong_tpu_torch.checkpoint.serialize import params_from_dict
from pingpong_tpu_torch.checkpoint.store import (
    list_checkpoints,
    load_checkpoint,
)
from pingpong_tpu_torch.models.qnet_rnn import QNetRNN
from pingpong_tpu_torch.models.rainbow import RainbowNet


def load_params_any(ckpt_path, prefer=("params_b", "params_a", "params"),
                    device="cpu"):
    """Key-chain fallback loader (the reference's ``modelB -> model``)."""
    payload = load_checkpoint(ckpt_path)
    for key in prefer:
        if key in payload and payload[key] is not None:
            return params_from_dict(payload[key], device)
    raise KeyError(f"no params under any of {prefer} in {ckpt_path}")


def load_pool(ckpt_dir, kind: str = "qnet", skip_fault: bool = False,
              limit: Optional[int] = None, exclude_names=("latest",),
              device="cpu") -> List:
    """All checkpoints of ``kind`` ("qnet", "qnet_rnn" or "rainbow") in
    ``ckpt_dir`` (sorted by name) as pool members; checkpoints of another
    kind are skipped."""
    if kind not in ("qnet", "qnet_rnn", "rainbow"):
        raise ValueError(f"unknown pool kind {kind!r}")
    members = []
    for path in list_checkpoints(ckpt_dir):
        if skip_fault and "fault" in path.name:
            continue
        if any(x in path.name for x in exclude_names):
            continue
        try:
            params = load_params_any(path, device=device)
        except (KeyError, ValueError):
            continue
        actual = ("qnet_rnn" if isinstance(params, QNetRNN) else
                  "rainbow" if isinstance(params, RainbowNet) else "qnet")
        if actual != kind:
            continue
        members.append(params)
        if limit is not None and len(members) >= limit:
            break
    return members
