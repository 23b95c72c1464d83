"""Rainbow's network (Hessel et al. 2018, arXiv:1710.02298) on this
system's trunk: a distributional, noisy, dueling Q-net.

``Linear(7,64)-ReLU-Linear(64,64)-ReLU`` (the QNet's trunk, in place of the
paper's Atari conv torso), then two noisy streams of ``stream`` units:
value ``Noisy(64,S)-ReLU-Noisy(S,A)`` and advantage
``Noisy(64,S)-ReLU-Noisy(S,3A)``, with ``A`` atoms. The logits of action
``a`` are ``v + a_a - mean_a' a_a'`` per atom; ``p(s, a)`` is their
softmax over the atoms, on the support ``z_i = v_min + i dz``, and
``Q(s, a) = sum_i z_i p_i(s, a)``.

Noisy layers are factorised Gaussian with ``sigma`` initialised to
``sigma0 / sqrt(fan_in)`` and ``mu`` to ``U(+-1/sqrt(fan_in))``. A noise
draw is kept as its factors (:class:`Factors`, the outer product is formed
where it is used): the weights' noise of the four streams is 0.17 M floats
a draw, the factors 2,380. Parameters are registered in the order feat1,
feat2, v1, v2, a1, a2 (each noisy layer w_mu, w_sigma, b_mu, b_sigma), the
order of :func:`rainbow_to_flat`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from pingpong_tpu_torch.models.noisy import (
    Dense,
    NoisyLinear,
    dense_init,
    noisy_init,
    scale_noise,
)
from pingpong_tpu_torch.models.qnet import (
    OBS_DIM,
    N_ACTIONS,
    HIDDEN,
    flat_views,
    qnet_copy,
    qnet_from_flat,
    qnet_to_flat,
)

NOISY = ("v1", "v2", "a1", "a2")


class Factors(NamedTuple):
    """One noisy layer's factorised draw: ``eps_w = ein (x) eout``,
    ``eps_b = eout`` (leading batch dims allowed)."""

    ein: torch.Tensor    # (..., in)
    eout: torch.Tensor   # (..., out)


class RainbowNoise(NamedTuple):
    v1: Factors
    v2: Factors
    a1: Factors
    a2: Factors


class RainbowNet(nn.Module):
    def __init__(self, feat1: Dense, feat2: Dense, v1: NoisyLinear,
                 v2: NoisyLinear, a1: NoisyLinear, a2: NoisyLinear,
                 v_min: float, v_max: float):
        super().__init__()
        self.feat1, self.feat2 = feat1, feat2
        self.v1, self.v2, self.a1, self.a2 = v1, v2, a1, a2
        self.v_min, self.v_max = float(v_min), float(v_max)

    @property
    def n_atoms(self) -> int:
        return self.v2.w_mu.shape[1]

    def forward(self, obs, noise: Optional[RainbowNoise] = None):
        return rainbow_q(self, obs, noise)


def rainbow_init(generator, n_atoms: int = 51, stream: int = 512,
                 sigma0: float = 0.5, v_min: float = -10.0,
                 v_max: float = 10.0, device="cpu") -> RainbowNet:
    """Weights from ``generator``, layer by layer in parameter order."""
    def noisy(i, o):
        return noisy_init(generator, i, o, sigma_init=sigma0 / i ** 0.5,
                          device=device)

    return RainbowNet(
        dense_init(generator, OBS_DIM, HIDDEN, device),
        dense_init(generator, HIDDEN, HIDDEN, device),
        noisy(HIDDEN, stream), noisy(stream, n_atoms),
        noisy(HIDDEN, stream), noisy(stream, N_ACTIONS * n_atoms),
        v_min, v_max)


def rainbow_from_config(generator, cfg, device="cpu") -> RainbowNet:
    """:func:`rainbow_init` at a ``DQNConfig``'s Rainbow widths."""
    return rainbow_init(generator, cfg.num_atoms, cfg.stream_hidden,
                        cfg.noisy_sigma0, cfg.v_min, cfg.v_max, device)


def noise_widths(net: RainbowNet):
    """``(in, out)`` of each noisy layer, in :data:`NOISY` order."""
    return [tuple(getattr(net, n).w_mu.shape) for n in NOISY]


def rainbow_sample_noise(generator, net: RainbowNet, batch=(),
                         device=None) -> RainbowNoise:
    """One factorised draw for every noisy layer (``batch`` leading dims
    give independent draws), layer by layer, ``in`` then ``out``, from the
    host ``generator``; put on ``device`` (``net``'s unless given)."""
    dev = net.v1.w_mu.device if device is None else device
    batch = tuple(batch)
    out = []
    for i, o in noise_widths(net):
        ein = scale_noise(torch.randn(batch + (i,), generator=generator))
        eout = scale_noise(torch.randn(batch + (o,), generator=generator))
        out.append(Factors(ein.to(dev), eout.to(dev)))
    return RainbowNoise(*out)


def pack_noise(noise: RainbowNoise) -> torch.Tensor:
    """Factors with leading dims ``(K,)`` -> one ``(K, F)`` matrix."""
    return torch.cat([x for f in noise for x in f], dim=-1)


def unpack_noise(packed: torch.Tensor, net: RainbowNet) -> RainbowNoise:
    """The inverse of :func:`pack_noise` (views of ``packed``)."""
    sizes = [s for io in noise_widths(net) for s in io]
    parts = packed.split(sizes, dim=-1)
    return RainbowNoise(*(Factors(parts[2 * i], parts[2 * i + 1])
                          for i in range(len(NOISY))))


def noise_at(noise: RainbowNoise, k: int) -> RainbowNoise:
    """Draw ``k`` of a batched noise."""
    return RainbowNoise(*(Factors(f.ein[k], f.eout[k]) for f in noise))


def _noisy(p: dict, name: str, x, f: Optional[Factors]):
    w, b = p[f"{name}.w_mu"], p[f"{name}.b_mu"]
    if f is not None:
        w = w + p[f"{name}.w_sigma"] * (f.ein[:, None] * f.eout[None, :])
        b = b + p[f"{name}.b_sigma"] * f.eout
    return x @ w + b


def logits_of(p: dict, obs, noise: Optional[RainbowNoise] = None):
    """:func:`rainbow_logits` from a ``{parameter name: tensor}`` dict (the
    net's parameters, or views of a raveled vector, :func:`logits_flat`)."""
    n = noise if noise is not None else RainbowNoise(None, None, None, None)
    h = torch.relu(obs @ p["feat1.w"] + p["feat1.b"])
    h = torch.relu(h @ p["feat2.w"] + p["feat2.b"])
    v = _noisy(p, "v2", torch.relu(_noisy(p, "v1", h, n.v1)), n.v2)
    a = _noisy(p, "a2", torch.relu(_noisy(p, "a1", h, n.a1)), n.a2)
    a = a.view(*a.shape[:-1], N_ACTIONS, -1)
    return v.unsqueeze(-2) + (a - a.mean(dim=-2, keepdim=True))


def rainbow_logits(net: RainbowNet, obs,
                   noise: Optional[RainbowNoise] = None) -> torch.Tensor:
    """Per-action atom logits ``obs.shape[:-1] + (3, A)``; ``noise=None``
    is eval mode (mu only)."""
    return logits_of(dict(net.named_parameters()), obs, noise)


def logits_flat(flat: torch.Tensor, like: RainbowNet, obs,
                noise: Optional[RainbowNoise] = None) -> torch.Tensor:
    """:func:`rainbow_logits` with the parameters views of the raveled
    vector ``flat`` (autograd through them reaches ``flat``)."""
    return logits_of(flat_views(flat, like), obs, noise)


def support(n_atoms: int, v_min: float, v_max: float,
            device="cpu") -> torch.Tensor:
    """``z_i = v_min + i dz``, ``dz = (v_max - v_min) / (A - 1)``, float32."""
    dz = torch.tensor((v_max - v_min) / (n_atoms - 1), dtype=torch.float32)
    return (torch.arange(n_atoms, dtype=torch.float32) * dz
            + torch.tensor(v_min, dtype=torch.float32)).to(device)


def q_from_logits(logits: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``Q = sum_i z_i softmax_i(logits)`` over the last axis."""
    return (torch.softmax(logits, dim=-1) * z).sum(dim=-1)


def rainbow_q(net: RainbowNet, obs,
              noise: Optional[RainbowNoise] = None) -> torch.Tensor:
    """Q-values ``obs.shape[:-1] + (3,)``."""
    z = support(net.n_atoms, net.v_min, net.v_max, obs.device)
    return q_from_logits(rainbow_logits(net, obs, noise), z)

rainbow_to_flat = qnet_to_flat
rainbow_from_flat = qnet_from_flat
rainbow_copy = qnet_copy
