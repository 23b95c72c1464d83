"""Trajectory recording for the viewer (port of
``pingpong_tpu/viewer/record.py``).

The reference viewer steps the env and models frame by frame inside the
UI loop (``tests/test_viewer_v2.py:134-187`` of the reference). Here, as
in the JAX package, the episode is played on the entry's device (the
card by default) with greedy policies and the hidden state carried, the
state trajectory is fetched to the host once, and rendering replays it
offline, so the UI never waits on the device.

The JAX package runs one jitted ``lax.scan`` of ``max_steps`` steps and
clips the result at the first ``done``. Here the same step (the greedy
actions of ``evaluation/match.py:_policy_actions``, then
``env.pong.step``) runs as torch ops in chunks of ``CHECK_EVERY`` steps
with one host read of ``done`` per chunk; recording stops after the chunk
that holds the first ``done``, so the clipped trajectory is the JAX one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    observe_a,
    observe_b,
    reset,
    step,
)
from pingpong_tpu_torch.evaluation.match import (
    RNN,
    PolicySpec,
    _on,
    _policy_actions,
)
from pingpong_tpu_torch.evaluation.registry import ModelEntry, load_entry
from pingpong_tpu_torch.models.qnet_rnn import init_hidden
from pingpong_tpu_torch.utils.device import resolve_device

CHECK_EVERY = 16   # steps a host read of ``done``, as in the match runner
_FLOATS = ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin", "top_paddle_x",
           "bottom_paddle_x")
_INTS = ("score_a", "score_b", "action_a", "action_b")


@dataclasses.dataclass
class Trajectory:
    """Host-side episode record (arrays of length T)."""

    ball_x: np.ndarray
    ball_y: np.ndarray
    ball_vx: np.ndarray
    ball_vy: np.ndarray
    spin: np.ndarray
    top_paddle_x: np.ndarray
    bottom_paddle_x: np.ndarray
    score_a: np.ndarray
    score_b: np.ndarray
    action_a: np.ndarray
    action_b: np.ndarray
    done: np.ndarray
    length: int

    def clipped(self) -> "Trajectory":
        t = self.length
        return Trajectory(
            **{
                f.name: getattr(self, f.name)[:t]
                for f in dataclasses.fields(self)
                if f.name != "length"
            },
            length=t,
        )


def _side(entry: ModelEntry, dev) -> PolicySpec:
    load_entry(entry)
    return PolicySpec(entry.kind, None if entry.params is None
                      else _on([entry.params], dev))


def record_episode(
    env_params: EnvParams,
    entry_a: ModelEntry,
    entry_b: ModelEntry,
    generator: Optional[torch.Generator] = None,
    max_steps: int = 5000,
    bot_tolerance: float = 0.02,
    device="cuda",
    state: Optional[EnvState] = None,
) -> Trajectory:
    """Play one greedy episode on ``device`` and return the full state
    trajectory. The initial state is ``reset(env_params, 1, generator)``
    (its uniforms drawn on the CPU, so the card and the CPU start from
    the same state for one seed) unless ``state`` gives it (one env,
    batched or not)."""
    dev = resolve_device(device)
    if state is None:
        state = reset(env_params, 1, generator)
    state = EnvState(*(x.reshape(1).to(dev) for x in state))
    side_a, side_b = _side(entry_a, dev), _side(entry_b, dev)
    idx = torch.zeros((1,), dtype=torch.int64, device=dev)
    hid_a = (init_hidden(side_a.params[0], (1,), dev)
             if side_a.kind == RNN else None)
    hid_b = (init_hidden(side_b.params[0], (1,), dev)
             if side_b.kind == RNN else None)
    recs = {name: [] for name in _FLOATS + _INTS + ("done",)}
    t = 0
    while t < max_steps:
        chunk_done = []
        for _ in range(min(CHECK_EVERY, max_steps - t)):
            act_a, hid_a = _policy_actions(side_a, idx, observe_a(state),
                                           hid_a, bot_tolerance)
            act_b, hid_b = _policy_actions(side_b, idx, observe_b(state),
                                           hid_b, bot_tolerance)
            state, out = step(env_params, state, act_a, act_b)
            for name in _FLOATS + ("score_a", "score_b"):
                recs[name].append(getattr(state, name))
            recs["action_a"].append(act_a)
            recs["action_b"].append(act_b)
            chunk_done.append(out.done)
            t += 1
        recs["done"] += chunk_done
        if bool(torch.cat(chunk_done).any()):
            break
    floats = torch.stack([torch.cat(recs[n]) for n in _FLOATS]).cpu().numpy()
    ints = torch.stack([torch.cat(recs[n]).to(torch.int32)
                        for n in _INTS + ("done",)]).cpu().numpy()
    done = ints[-1].astype(bool)
    length = int(done.argmax()) + 1 if done.any() else t
    return Trajectory(**dict(zip(_FLOATS, floats)),
                      **dict(zip(_INTS, ints[:-1])),
                      done=done, length=length).clipped()
