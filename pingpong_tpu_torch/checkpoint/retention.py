"""Checkpoint retention / garbage collection (a copy of
``pingpong_tpu/checkpoint/retention.py`` over the port's store).

Policy: promoted and fault checkpoints are retained separately
(``keep_promoted`` / ``keep_faults`` newest each; 0 = keep all of that
class). The full-train-state autosave (``latest_*``), ``.old`` and
``.tmp-*`` directories and anything whose name is explicitly protected
(e.g. the warm-start ``init_model_path``) are never touched. Ordering is
by generation number parsed from the name (``model{id}-{gen}`` /
``{prefix}{gen}``), falling back to mtime: name-based ordering survives
clock skew and copied files. Defaults are off (keep all), as in the
reference trainers, which never delete a checkpoint.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from pingpong_tpu_torch.checkpoint.store import is_checkpoint

_GEN_RE = re.compile(r"(\d+)(?:_fault)?$")


def _gen_key(p: Path) -> Tuple[int, float]:
    m = _GEN_RE.search(p.name)
    gen = int(m.group(1)) if m else -1
    try:
        mtime = p.stat().st_mtime
    except OSError:
        mtime = 0.0
    return (gen, mtime)


def apply_retention(
    ckpt_dir: Path,
    keep_promoted: int = 0,
    keep_faults: int = 0,
    protect: Optional[Iterable[str]] = None,
) -> List[str]:
    """Delete superseded checkpoints; returns the deleted names.

    ``keep_promoted``/``keep_faults``: newest N of each class to retain
    (by generation number, then mtime); 0 keeps all of that class.
    """
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir() or (keep_promoted <= 0 and keep_faults <= 0):
        return []
    protected = set(protect or ())
    promoted: List[Path] = []
    faults: List[Path] = []
    for p in ckpt_dir.iterdir():
        if not p.is_dir() or not is_checkpoint(p):
            continue
        if p.name in protected or p.name.startswith("latest_"):
            continue
        if p.name.endswith(".old") or ".tmp-" in p.name:
            continue
        (faults if p.name.endswith("_fault") else promoted).append(p)

    deleted: List[str] = []

    def trim(paths: List[Path], keep: int):
        if keep <= 0 or len(paths) <= keep:
            return
        paths.sort(key=_gen_key)
        for p in paths[: len(paths) - keep]:
            shutil.rmtree(p, ignore_errors=True)
            deleted.append(p.name)

    trim(promoted, keep_promoted)
    trim(faults, keep_faults)
    return deleted
