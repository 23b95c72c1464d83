"""Frozen copy of ``pingpong_tpu_torch/models/qnet_rnn.py`` (the QNetRNN, its
init and noise), as the port had it when the benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch
from torch import nn

from .noisy import (
    Dense,
    NoisyNoise,
    _param,
    _uniform,
    dense_init,
    noisy_init,
    sample_noise,
)
from .qnet import N_ACTIONS, OBS_DIM


class LSTMLayer(nn.Module):
    def __init__(self, w_ih, w_hh, b_ih, b_hh):
        super().__init__()
        self.w_ih = _param(w_ih)    # (input, 4H), gate order i, f, g, o
        self.w_hh = _param(w_hh)    # (H, 4H)
        self.b_ih = _param(b_ih)    # (4H,)
        self.b_hh = _param(b_hh)    # (4H,)


class QNetRNNNoise(NamedTuple):
    shared: Optional[NoisyNoise]
    v: NoisyNoise
    a: NoisyNoise


class Hidden(NamedTuple):
    h: torch.Tensor    # (layers, batch..., H)
    c: torch.Tensor


class QNetRNN(nn.Module):
    def __init__(self, feat1: Dense, feat2: Dense, lstm, shared, fc_v, fc_a):
        super().__init__()
        self.feat1 = feat1
        self.feat2 = feat2
        self.lstm = nn.ModuleList(lstm)
        self.shared = shared        # NoisyLinear or None
        self.fc_v = fc_v
        self.fc_a = fc_a

    def forward(self, obs_seq, hidden: Hidden,
                noise: Optional[QNetRNNNoise] = None):
        return qnet_rnn_apply(self, obs_seq, hidden, noise)

    @property
    def dims(self):
        """(feature_dim // 2, feature_dim, lstm hidden, head hidden)."""
        hh = self.shared.w_mu.shape[1] if self.shared is not None else 0
        return (self.feat1.w.shape[1], self.feat2.w.shape[1],
                self.lstm[0].w_hh.shape[0], hh)


def lstm_layer_init(generator, input_dim, hidden, device="cpu") -> LSTMLayer:
    bound = 1.0 / hidden ** 0.5
    return LSTMLayer(
        _uniform(generator, (input_dim, 4 * hidden), bound, device),
        _uniform(generator, (hidden, 4 * hidden), bound, device),
        _uniform(generator, (4 * hidden,), bound, device),
        _uniform(generator, (4 * hidden,), bound, device),
    )


def qnet_rnn_init(generator, obs_dim=OBS_DIM, n_actions=N_ACTIONS,
                  feature_dim=128, lstm_hidden_dim=128, lstm_layers=1,
                  head_hidden_dim=128, device="cpu") -> QNetRNN:
    """The JAX package's initializers (U(±1/sqrt(fan_in)) dense and noisy
    mu, sigma 0.017, LSTM U(±1/sqrt(H))) drawn from ``generator``."""
    lstm = [lstm_layer_init(generator,
                            feature_dim if l == 0 else lstm_hidden_dim,
                            lstm_hidden_dim, device)
            for l in range(lstm_layers)]
    shared = (noisy_init(generator, lstm_hidden_dim, head_hidden_dim,
                         device=device) if head_hidden_dim > 0 else None)
    head_in = head_hidden_dim if head_hidden_dim > 0 else lstm_hidden_dim
    return QNetRNN(
        dense_init(generator, obs_dim, feature_dim // 2, device),
        dense_init(generator, feature_dim // 2, feature_dim, device),
        lstm, shared,
        noisy_init(generator, head_in, 1, device=device),
        noisy_init(generator, head_in, n_actions, device=device),
    )


def qnet_rnn_sample_noise(generator, params: QNetRNN,
                          batch=()) -> QNetRNNNoise:
    """One factorized draw for each noisy layer (``batch`` leading dims
    give independent draws); factors come from ``generator`` on the CPU."""
    dev = params.fc_a.w_mu.device

    def draw(layer):
        return sample_noise(generator, *layer.w_mu.shape, dev, batch)

    return QNetRNNNoise(
        shared=draw(params.shared) if params.shared is not None else None,
        v=draw(params.fc_v), a=draw(params.fc_a))


def _gates_to_hc(gates, c):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(p: LSTMLayer, x, h, c):
    """One LSTM step. x: (..., input), h/c: (..., H)."""
    return _gates_to_hc(x @ p.w_ih + p.b_ih + h @ p.w_hh + p.b_hh, c)


def _features(params: QNetRNN, obs):
    return torch.relu(params.feat2(torch.relu(params.feat1(obs))))


def _dueling_head(params: QNetRNN, x, noise: Optional[QNetRNNNoise]):
    if params.shared is not None:
        x = torch.relu(params.shared(x, noise.shared if noise else None))
    v = params.fc_v(x, noise.v if noise else None)
    a = params.fc_a(x, noise.a if noise else None)
    return v + (a - a.mean(dim=-1, keepdim=True))


def qnet_rnn_apply(params: QNetRNN, obs_seq, hidden: Hidden,
                   noise: Optional[QNetRNNNoise] = None):
    """Sequence forward: ``obs_seq (B, T, obs)`` or ``(T, obs)``. Returns
    (Q of the last timestep, final hidden). Layer 0's input projection
    runs for all timesteps at once, as in the JAX function."""
    time_axis = 1 if obs_seq.dim() == 3 else 0
    feats_t = torch.movedim(_features(params, obs_seq), time_axis, 0)
    l0 = params.lstm[0]
    xp0_t = feats_t @ l0.w_ih + l0.b_ih
    h = list(hidden.h)
    c = list(hidden.c)
    x = None
    for t in range(feats_t.shape[0]):
        x = feats_t[t]
        for l, layer in enumerate(params.lstm):
            if l == 0:
                gates = xp0_t[t] + h[0] @ layer.w_hh + layer.b_hh
                h[0], c[0] = _gates_to_hc(gates, c[0])
            else:
                h[l], c[l] = lstm_cell(layer, x, h[l], c[l])
            x = h[l]
    q = _dueling_head(params, x, noise)
    return q, Hidden(h=torch.stack(h), c=torch.stack(c))


def qnet_rnn_copy(params: QNetRNN) -> QNetRNN:
    return copy.deepcopy(params)


def qnet_rnn_to_flat(params: QNetRNN) -> torch.Tensor:
    """The raveled parameter vector, in ``ravel_pytree`` order."""
    return torch.cat([p.detach().reshape(-1) for p in params.parameters()])


def qnet_rnn_from_flat(flat: torch.Tensor, like: QNetRNN) -> QNetRNN:
    """A new QNetRNN with ``like``'s shapes holding ``flat`` (on ``flat``'s
    device)."""
    out = qnet_rnn_copy(like).to(flat.device)
    i = 0
    for p in out.parameters():
        n = p.numel()
        p.data.copy_(flat[i:i + n].view_as(p))
        i += n
    if i != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} != {i} parameters")
    return out
