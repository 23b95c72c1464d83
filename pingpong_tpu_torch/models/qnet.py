"""Dueling NoisyNet DQN (port of ``pingpong_tpu/models/qnet.py``).

Noise-free trunk ``Linear(7,64)-ReLU-Linear(64,64)-ReLU``, noisy dueling
heads ``fc_v: Noisy(64,1)`` and ``fc_a: Noisy(64,3)``,
``Q = V + (A - mean(A))``. Parameters are registered in the JAX package's
``ravel_pytree`` order (feat1.w, feat1.b, feat2.w, feat2.b, then each
noisy head's w_mu, w_sigma, b_mu, b_sigma), so :func:`qnet_to_flat` is the
raveled vector that the optimizer state of either package is laid over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from pingpong_tpu_torch.models.noisy import (
    Dense,
    NoisyLinear,
    NoisyNoise,
    dense_init,
    noisy_init,
    sample_noise,
)

OBS_DIM = 7
N_ACTIONS = 3
HIDDEN = 64


class QNetNoise(NamedTuple):
    v: NoisyNoise
    a: NoisyNoise


class QNet(nn.Module):
    def __init__(self, feat1: Dense, feat2: Dense, fc_v: NoisyLinear,
                 fc_a: NoisyLinear):
        super().__init__()
        self.feat1 = feat1
        self.feat2 = feat2
        self.fc_v = fc_v
        self.fc_a = fc_a

    def forward(self, obs, noise: Optional[QNetNoise] = None):
        return qnet_apply(self, obs, noise)


def qnet_init(generator, obs_dim=OBS_DIM, n_actions=N_ACTIONS,
              hidden=HIDDEN, device="cpu") -> QNet:
    return QNet(
        dense_init(generator, obs_dim, hidden, device),
        dense_init(generator, hidden, hidden, device),
        noisy_init(generator, hidden, 1, device=device),
        noisy_init(generator, hidden, n_actions, device=device),
    )


def qnet_sample_noise(generator, params: QNet, batch=(),
                      device=None) -> QNetNoise:
    """One fresh factorized draw for both heads (``batch`` leading dims
    give independent draws), drawn on the host and put on ``device``
    (``params``' unless given)."""
    dev = params.fc_a.w_mu.device if device is None else device
    h, n_act = params.fc_a.w_mu.shape
    return QNetNoise(
        v=sample_noise(generator, h, params.fc_v.w_mu.shape[1], dev, batch),
        a=sample_noise(generator, h, n_act, dev, batch),
    )


def qnet_apply(params: QNet, obs, noise: Optional[QNetNoise] = None):
    """Q-values ``obs.shape[:-1] + (n_actions,)``; ``noise=None`` is eval
    mode."""
    h = torch.relu(params.feat1(obs))
    h = torch.relu(params.feat2(h))
    v = params.fc_v(h, noise.v if noise else None)
    a = params.fc_a(h, noise.a if noise else None)
    return v + (a - a.mean(dim=-1, keepdim=True))


def argmax3(q: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis of size 3, ties to the lowest index by
    strict ``>`` (``ops/actor_rollout.py::_argmax3_rows``)."""
    a0, a1, a2 = q[..., 0], q[..., 1], q[..., 2]
    i01 = (a1 > a0).to(torch.int32)
    return torch.where(a2 > torch.maximum(a0, a1), 2, i01).to(torch.int32)


def qnet_fold_noise(params: QNet, noise: QNetNoise) -> QNet:
    """Fold one noise draw into the heads (``mu' = mu + sigma * eps``,
    sigmas zeroed): the reference's stale-noise frozen A."""

    def fold(p: NoisyLinear, n: NoisyNoise) -> NoisyLinear:
        return NoisyLinear(p.w_mu + p.w_sigma * n.eps_w,
                           torch.zeros_like(p.w_sigma),
                           p.b_mu + p.b_sigma * n.eps_b,
                           torch.zeros_like(p.b_sigma))

    return QNet(qnet_copy(params.feat1), qnet_copy(params.feat2),
                fold(params.fc_v, noise.v), fold(params.fc_a, noise.a))


def bot_qnet_params(tolerance: float = 0.02, obs_dim: int = OBS_DIM,
                    hidden: int = HIDDEN, device="cpu") -> QNet:
    """The ball-follower bot as exact QNet weights, so it can sit in any
    QNet stack. With ``d = my_paddle_x - ball_x``: ``feat1`` gives
    ``h0 = relu(d)``, ``h1 = relu(-d)``, ``feat2`` passes both through, and
    the A head's mu is ``[d, tolerance, -d]`` (every sigma zero): argmax
    moves left iff ``d > tolerance``, right iff ``-d > tolerance``, else
    stays, as ``models/policy.py::ball_follower_action`` does, up to ties
    at ``d == +-tolerance``."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    w1 = z(obs_dim, hidden)
    w1[4, 0], w1[0, 0] = 1.0, -1.0       # h0 = relu(my_x - ball_x)
    w1[4, 1], w1[0, 1] = -1.0, 1.0       # h1 = relu(ball_x - my_x)
    w2 = z(hidden, hidden)
    w2[0, 0] = w2[1, 1] = 1.0
    wa = z(hidden, N_ACTIONS)
    wa[0, 0], wa[1, 0] = 1.0, -1.0       # A(left) = d
    wa[0, 2], wa[1, 2] = -1.0, 1.0       # A(right) = -d
    ba = z(N_ACTIONS)
    ba[1] = float(tolerance)
    return QNet(Dense(w1, z(hidden)), Dense(w2, z(hidden)),
                NoisyLinear(z(hidden, 1), z(hidden, 1), z(1), z(1)),
                NoisyLinear(wa, z(hidden, N_ACTIONS), ba, z(N_ACTIONS)))


def qnet_copy(module: nn.Module) -> nn.Module:
    """A copy with its own parameter storage."""
    import copy

    return copy.deepcopy(module)


def qnet_to_flat(params: QNet) -> torch.Tensor:
    """The raveled parameter vector, in ``ravel_pytree`` order."""
    return torch.cat([p.detach().reshape(-1) for p in params.parameters()])


def qnet_from_flat(flat: torch.Tensor, like: QNet) -> QNet:
    """A new QNet with ``like``'s shapes holding ``flat``."""
    out = qnet_copy(like)
    qnet_load_flat_(out, flat)
    return out


def flat_views(flat: torch.Tensor, like: nn.Module) -> dict:
    """Parameter name -> the view of the raveled vector ``flat`` that holds
    it, with ``like``'s shapes (autograd through a view reaches
    ``flat``)."""
    views, i = {}, 0
    for name, p in like.named_parameters():
        views[name] = flat[i:i + p.numel()].view(p.shape)
        i += p.numel()
    if i != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} != {i} parameters")
    return views


def qnet_load_flat_(params: QNet, flat: torch.Tensor) -> None:
    """Copy the raveled vector ``flat`` into ``params`` in place."""
    i = 0
    for p in params.parameters():
        n = p.numel()
        p.data.copy_(flat[i:i + n].view_as(p))
        i += n
    if i != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} != {i} parameters")
