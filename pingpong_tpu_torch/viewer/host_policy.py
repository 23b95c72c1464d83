"""Host-side (pure numpy) greedy inference for the live viewer (port of
``pingpong_tpu/viewer/host_policy.py``).

The live viewer steps the native C++ engine frame by frame in real time;
round-tripping each 7-float observation through the card would put
launch and copy latency on every frame, so the eval-mode (mu-weights)
forward passes of both model families are mirrored here in numpy. Each
net's weights are read once, as float32 numpy in the JAX layout
(``checkpoint/serialize.py:qnet_to_numpy`` / ``qnet_rnn_to_numpy``,
``(in, out)`` weights). Numerics match the torch eval forwards
(``models/qnet.py:qnet_apply``, ``models/qnet_rnn.py:qnet_rnn_step``) to
f32 rounding; a unit test pins the agreement.

Semantics source: the reference viewer's per-frame inference
(``tests/pingpong_viewer/models/agent.py:77-92`` of the reference).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pingpong_tpu_torch.checkpoint.serialize import (
    qnet_rnn_to_numpy,
    qnet_to_numpy,
)
from pingpong_tpu_torch.models.qnet_rnn import QNetRNN


def _relu(x):
    return np.maximum(x, 0.0)


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _noisy_mu(p, x):
    return x @ p["w_mu"] + p["b_mu"]


class HostQNet:
    """Greedy eval-mode QNet (dueling NoisyNet, mu weights)."""

    def __init__(self, params):
        self.p = qnet_to_numpy(params)

    def q(self, obs: np.ndarray) -> np.ndarray:
        h = _relu(_dense(self.p["feat1"], obs))
        h = _relu(_dense(self.p["feat2"], h))
        v = _noisy_mu(self.p["fc_v"], h)
        a = _noisy_mu(self.p["fc_a"], h)
        return v + (a - a.mean(axis=-1, keepdims=True))

    def act(self, obs: np.ndarray) -> int:
        return int(np.argmax(self.q(obs)))


class HostQNetRNN:
    """Greedy eval-mode QNetRNN with explicit (h, c) carried per call."""

    def __init__(self, params):
        self.p = qnet_rnn_to_numpy(params)
        self.hidden = self.init_hidden()

    def init_hidden(self) -> Tuple[np.ndarray, np.ndarray]:
        layers = len(self.p["lstm"])
        hdim = self.p["lstm"][0]["w_hh"].shape[0]
        z = np.zeros((layers, hdim), np.float32)
        return z.copy(), z.copy()

    def reset(self) -> None:
        self.hidden = self.init_hidden()

    def q(self, obs: np.ndarray) -> np.ndarray:
        x = _relu(_dense(self.p["feat1"], obs))
        x = _relu(_dense(self.p["feat2"], x))
        h_all, c_all = self.hidden
        hs, cs = [], []
        for l, layer in enumerate(self.p["lstm"]):
            gates = (
                x @ layer["w_ih"] + layer["b_ih"]
                + h_all[l] @ layer["w_hh"] + layer["b_hh"]
            )
            i, f, g, o = np.split(gates, 4, axis=-1)
            i = 1.0 / (1.0 + np.exp(-i))
            f = 1.0 / (1.0 + np.exp(-f))
            g = np.tanh(g)
            o = 1.0 / (1.0 + np.exp(-o))
            c_new = f * c_all[l] + i * g
            h_new = o * np.tanh(c_new)
            hs.append(h_new)
            cs.append(c_new)
            x = h_new
        self.hidden = (np.stack(hs), np.stack(cs))
        if self.p["shared"] is not None:
            x = _relu(_noisy_mu(self.p["shared"], x))
        v = _noisy_mu(self.p["fc_v"], x)
        a = _noisy_mu(self.p["fc_a"], x)
        return v + (a - a.mean(axis=-1, keepdims=True))

    def act(self, obs: np.ndarray) -> int:
        return int(np.argmax(self.q(obs)))


class HostBot:
    """The hardcoded ball follower (``test_round_robin.py:210-232`` of the
    reference)."""

    def __init__(self, tolerance: float = 0.02):
        self.tolerance = tolerance

    def reset(self) -> None:
        pass

    def act(self, obs: np.ndarray) -> int:
        ball_x, my_x = float(obs[0]), float(obs[4])
        if ball_x < my_x - self.tolerance:
            return 0
        if ball_x > my_x + self.tolerance:
            return 2
        return 1


def host_policy(params, tolerance: float = 0.02):
    """A host policy object for a QNet, a QNetRNN, or None (the bot)."""
    if params is None:
        return HostBot(tolerance)
    if isinstance(params, QNetRNN):
        return HostQNetRNN(params)
    return HostQNet(params)


def serve(rng: np.random.Generator, cfg) -> Tuple[float, float, float]:
    """Randomized serve (vx, vy, spin) matching env/pong.py's serve
    distribution (speed ~ U(range), angle from one of two intervals with
    p=0.5, spin ~ U(range)) on the host RNG."""
    speed = rng.uniform(*cfg.ball_speed_range)
    lo, hi = cfg.ball_angle_intervals[int(rng.random() >= 0.5)]
    angle = np.deg2rad(rng.uniform(lo, hi))
    spin = rng.uniform(*cfg.spin_range)
    return (
        float(speed * np.cos(angle)),
        float(speed * np.sin(angle)),
        float(spin),
    )


def observe_pair(s, i: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(obs_a mirrored, obs_b direct) from a native SoAState row
    (env/pong.py::observe_a/observe_b semantics)."""
    obs_a = np.array([
        s.ball_x[i], 1.0 - s.ball_y[i], s.ball_vx[i], -s.ball_vy[i],
        s.top_x[i], s.bottom_x[i], s.spin[i],
    ], np.float32)
    obs_b = np.array([
        s.ball_x[i], s.ball_y[i], s.ball_vx[i], s.ball_vy[i],
        s.bottom_x[i], s.top_x[i], s.spin[i],
    ], np.float32)
    return obs_a, obs_b
