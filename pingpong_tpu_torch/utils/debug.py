"""Numerical-safety and profiling utilities (port of
``pingpong_tpu/utils/debug.py``).

The reference has no profiler hooks or sanitizers. As the JAX package
does with ``jax.profiler`` and ``checkify``, the port supplies a trace
capture around hot sections (``torch.profiler``, a Chrome trace) and a
non-finite check of the physics step, useful when tuning env params such
as restitution > 1 that can diverge.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from pingpong_tpu_torch.env.pong import step

NONFINITE_STEP = "non-finite ball state after env step"


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    card when there is one) and write it as a Chrome trace into
    ``log_dir`` (open with ``chrome://tracing`` or Perfetto). Yields the
    profiler, so the caller can also read ``key_averages()``. With the
    tracer on (``utils/trace.py``) the program's spans opened inside the
    block appear in the trace under their names."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepError:
    """The outcome of :func:`checked_env_step`: one boolean on the step's
    device, read when the caller asks (``checkify``'s ``Error``)."""

    def __init__(self, finite: torch.Tensor):
        self._finite = finite

    def get(self) -> Optional[str]:
        """The error message, or None when the step was finite."""
        return None if bool(self._finite) else NONFINITE_STEP

    def throw(self) -> None:
        """Raise ``FloatingPointError`` if the step was not finite."""
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


def checked_env_step(params, state, action_a, action_b):
    """Env step with a non-finite check: returns ``(error, (state,
    out))``.

    ``error.throw()`` raises if any NaN/Inf appeared in the ball state
    (``ball_x``, ``ball_vx``, ``ball_vy``, ``spin``) after the step — the
    compounding speed scale-up (``my_pong_env_2p.py:227-232`` analog) can
    overflow f32 on degenerate configs. The check is one ``isfinite``
    reduction on the device, read once, by ``throw`` or ``get``.
    """
    new_state, out = step(params, state, action_a, action_b)
    finite = torch.isfinite(torch.stack([
        new_state.ball_x, new_state.ball_vx, new_state.ball_vy,
        new_state.spin])).all()
    return StepError(finite), (new_state, out)


def _leaves(node, path: str):
    """``(path, array-like)`` of every leaf, with JAX ``keystr``-style
    paths (``['key']``, ``.field``, ``[i]``)."""
    if isinstance(node, nn.Module):
        for name, p in node.named_parameters():
            yield f"{path}.{name}", p
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for k, v in zip(node._fields, node):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}[{i}]")
    elif node is not None:
        yield path, node


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finite check over every floating leaf of a nest of
    tuples, NamedTuples, lists, dicts, tensors, arrays and ``nn.Module``
    parameters; raises ``FloatingPointError`` naming the first bad path."""
    for path, leaf in _leaves(tree, ""):
        if isinstance(leaf, torch.Tensor):
            bad = (leaf.is_floating_point()
                   and not bool(torch.isfinite(leaf).all()))
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")
