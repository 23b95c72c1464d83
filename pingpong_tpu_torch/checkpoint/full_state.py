"""Full-train-state checkpointing: port of
``pingpong_tpu/checkpoint/orbax_io.py`` on torch serialization.

The light npz store (:mod:`pingpong_tpu_torch.checkpoint.store`) covers the
model checkpoints that tournaments and pools read. This module covers the
heavy case: the WHOLE train state (the replay buffer included, 72 MiB for
the QNet PER at 2^20 and 176 MiB for the DRQN ring at ``configs/rnn.yaml``),
the frozen opponent A and the loop's host generator, for a mid-generation
resume that continues bit for bit.

A checkpoint is a directory ``<name>/`` holding ``state.pt`` (one
``torch.save`` of a flat dict: tree path -> tensor, int, float or None; a
``torch.Generator`` is stored as its ``get_state()`` bytes) and
``framework_meta.json``. It never holds ``meta.json`` and ``arrays.npz``,
so ``store.list_checkpoints`` and the pool loader never take it for a
model checkpoint. The tree is any nest of dataclasses, NamedTuples, dicts,
lists, tensors, generators and scalars (the learners' train states are
such); a restore rebuilds it against a template made by the learner's
``init_state`` and raises on a key, type, shape or dtype mismatch.

Data parallel (one process a card): a checkpoint always holds the WHOLE
state, in the single-device layout. The loops gather it with the
learner's ``gather_state`` (a collective every rank reaches at the same
train step, in the train loop, never in the saver's worker), rank 0 alone
hands it to the saver, and a restore reads the file on every rank and
cuts it to the rank's block with ``shard_state``; so a sharded replay is
saved whole and restored into the ring of each rank.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"
META_FILE = "framework_meta.json"


def _children(node):
    """``(key, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(node, (torch.Tensor, torch.Generator)):
        return None
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of a nest; paths join keys with ``/``."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            if not (node is None or isinstance(
                    node, (torch.Tensor, torch.Generator, bool, int, float,
                           str))):
                raise TypeError(f"{path}: cannot save a {type(node)}")
            out[path] = node
            return
        for k, v in kids:
            walk(v, f"{path}/{k}" if path else k)

    walk(tree, prefix)
    return out


def _rebuild(template: Any, saved: Dict[str, Any], path: str = ""):
    kids = _children(template)
    if kids is None:
        if path not in saved:
            raise KeyError(f"checkpoint has no entry {path!r}")
        return _leaf(template, saved[path], path)
    vals = [_rebuild(v, saved, f"{path}/{k}" if path else k)
            for k, v in kids]
    if dataclasses.is_dataclass(template):
        return type(template)(**{k: v for (k, _), v in zip(kids, vals)})
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*vals)
    if isinstance(template, dict):
        return dict(zip(template.keys(), vals))
    return type(template)(vals)


def _leaf(template, value, path):
    if isinstance(template, torch.Generator):
        ref = template.get_state()
        if not (isinstance(value, torch.Tensor) and value.dtype == ref.dtype
                and value.shape == ref.shape):
            raise ValueError(f"{path}: not a generator state like the "
                             f"template's")
        gen = torch.Generator(device=template.device)
        gen.set_state(value.cpu())
        return gen
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor):
            raise ValueError(f"{path}: expected a tensor, got {type(value)}")
        if value.shape != template.shape or value.dtype != template.dtype:
            raise ValueError(
                f"{path}: checkpoint holds {tuple(value.shape)} "
                f"{value.dtype}, the template {tuple(template.shape)} "
                f"{template.dtype}")
        return value.to(template.device)
    if type(value) is not type(template):
        raise ValueError(f"{path}: checkpoint holds a {type(value).__name__}"
                         f", the template a {type(template).__name__}")
    return value


def _host_leaves(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Generators to their state bytes, tensors to the CPU."""
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Generator):
            v = v.get_state()
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu()
        out[k] = v
    return out


def _write(path: Path, host: Dict[str, Any], metadata: Optional[dict]) -> str:
    """Atomic write in the keep-one-valid-copy sense of the store: the
    checkpoint goes to ``<name>.tmp-<pid>``, the previous one is parked at
    ``<name>.old`` while the new one swaps in, then dropped."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    torch.save(host, tmp / STATE_FILE)
    if metadata is not None:
        with open(tmp / META_FILE, "w") as f:
            json.dump(metadata, f)
    old = path.with_name(path.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    if path.exists():
        os.replace(path, old)
    os.replace(tmp, path)
    if old.exists():
        shutil.rmtree(old)
    return str(path)


def save_train_state(path, state: Any, metadata: Optional[dict] = None) -> str:
    """Save a whole train-state nest (+ JSON-able metadata), synchronously."""
    return _write(Path(path), _host_leaves(flatten_tree(state)), metadata)


def restore_train_state(path, template: Any, device=None) -> Any:
    """Restore into the structure of ``template``; tensors land on the
    template's devices (``device``, if given, is the ``map_location``)."""
    saved = torch.load(Path(path) / STATE_FILE, weights_only=True,
                       map_location=device)
    want = set(flatten_tree(template))
    extra = sorted(set(saved) - want)
    if extra:
        raise KeyError(f"checkpoint entries the template lacks: {extra[:5]}")
    return _rebuild(template, saved)


def load_metadata(path) -> Optional[dict]:
    meta = Path(path) / META_FILE
    if meta.is_file():
        with open(meta) as f:
            return json.load(f)
    return None


def is_train_state_checkpoint(path) -> bool:
    p = Path(path)
    return (p / META_FILE).is_file() or (p.is_dir() and any(p.iterdir()))


class AsyncAutosaver:
    """Background full-state autosave.

    ``save()`` takes the snapshot at call time: a device ``clone`` of every
    tensor on the current stream (the train loop updates its buffers IN
    PLACE, so the worker must own independent copies) and every
    generator's ``get_state()`` read here, not in the worker, so the saved
    streams match the saved tensors. The worker thread then copies the
    clones to pinned host buffers on a stream of its own, behind an event
    recorded after the clones (never a plain ``.cpu()`` on the train
    loop's stream, which would queue behind its kernels), and runs the
    atomic ``torch.save`` write, which releases the GIL while it writes.
    The pinned buffers are kept and reused by the next save of the same
    shapes until ``close()`` (the loops' ``flush_autosave()`` at the end of
    ``run()``): it stops the worker and hands the buffers back to the host allocator's
    cache, where the next saver finds them.

    At most one write is in flight: a new ``save()`` first joins the
    previous one. A hard kill loses at most the in-flight save; the
    previous checkpoint stays valid through the tmp/old swap. Worker errors
    surface on the next ``save()``/``wait()``/``close()``."""

    def __init__(self):
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._pending = 0
        self._done = threading.Condition()
        self._error: Optional[BaseException] = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self._stream = None

    def _ensure_worker(self):
        if self._thread is not None:
            return
        self._queue = queue.Queue()

        def loop():
            while True:
                job = self._queue.get()
                if job is None:
                    return
                path, snapshot, event, metadata = job
                try:
                    _write(path, self._host_copy(snapshot, event), metadata)
                except BaseException as e:  # surfaced by wait()/save()
                    self._error = e
                finally:
                    del snapshot   # the device clones go back to the pool
                    with self._done:
                        self._pending -= 1
                        self._done.notify_all()

        self._thread = threading.Thread(target=loop, name="port-autosave",
                                        daemon=True)
        self._thread.start()

    def _host_copy(self, snapshot: Dict[str, Any], event) -> Dict[str, Any]:
        """The worker's step: device clones -> pinned host copies on the
        saver's stream, waited for."""
        on_card = {k: v for k, v in snapshot.items()
                   if isinstance(v, torch.Tensor) and v.is_cuda}
        if on_card:
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(event)
                for k, v in on_card.items():
                    buf = self._pinned.get(k)
                    if (buf is None or buf.shape != v.shape
                            or buf.dtype != v.dtype):
                        buf = torch.empty(v.shape, dtype=v.dtype,
                                          pin_memory=True)
                        self._pinned[k] = buf
                    v.record_stream(self._stream)
                    buf.copy_(v, non_blocking=True)
            self._stream.synchronize()
        return {k: self._pinned[k] if k in on_card else v
                for k, v in snapshot.items()}

    def wait(self) -> None:
        """Block until all in-flight writes complete; re-raise any worker
        error."""
        with self._done:
            while self._pending:
                self._done.wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Join the in-flight write, stop the worker and drop the pinned
        buffers; a later ``save()`` starts a new worker."""
        try:
            self.wait()
        finally:
            if self._thread is not None:
                self._queue.put(None)
                self._thread.join()
                self._thread = self._queue = None
            self._pinned.clear()
            self._stream = None

    def save(self, path, tree: Any, metadata: dict) -> str:
        self.wait()   # at most one write in flight; surfaces prior errors
        self._ensure_worker()
        snapshot, event = take_snapshot(tree)
        with self._done:
            self._pending += 1
        self._queue.put((Path(path), snapshot, event, metadata))
        return str(Path(path).resolve())


def take_snapshot(tree: Any):
    """The save-time copy of a nest: ``({path: leaf}, event)``, tensors
    cloned on the current stream, generators read now; ``event`` is
    recorded behind the clones when any lies on the card, else None."""
    snapshot = {}
    for k, v in flatten_tree(tree).items():
        if isinstance(v, torch.Generator):
            v = v.get_state()
        elif isinstance(v, torch.Tensor):
            v = v.detach().clone()
        snapshot[k] = v
    event = None
    if any(isinstance(v, torch.Tensor) and v.is_cuda
           for v in snapshot.values()):
        event = torch.cuda.Event()
        event.record()
    return snapshot, event


def autosave_full_state(path, state: Any, params_a: Any, host_gen,
                        metadata: dict, extra: Any = None) -> str:
    """One-call synchronous full autosave for the self-play loops: the
    WHOLE train state (replay included), the frozen opponent A (a flat
    parameter vector), the loop's host generator and ``extra`` (the
    frozen-A noise draw, or None)."""
    return save_train_state(path, full_state_tree(state, params_a, host_gen,
                                                  extra), metadata)


def full_state_tree(state, params_a, host_gen, extra=None) -> dict:
    """The nest the loops save: ``state``, ``params_a``, ``host`` and
    ``extra``."""
    return {"state": state, "params_a": params_a, "host": host_gen,
            "extra": extra}


def restore_full_state(path, template_state: Any, template_params: Any,
                       template_gen: torch.Generator, template_extra=None,
                       device=None):
    """Restore an :func:`autosave_full_state` checkpoint. Returns
    ``(state, params_a, host_gen, extra, metadata)``; raises on a
    key, shape or dtype mismatch (callers fall through to the next restore
    tier)."""
    tree = restore_train_state(
        path, full_state_tree(template_state, template_params, template_gen,
                              template_extra), device=device)
    return (tree["state"], tree["params_a"], tree["host"], tree["extra"],
            load_metadata(path) or {})
