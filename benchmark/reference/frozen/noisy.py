"""Frozen copy of ``pingpong_tpu_torch/models/noisy.py`` (NoisyNet layers,
their init and noise), as the port had it when the benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


def _uniform(generator, shape, bound, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(device)


class Dense(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = _param(w)     # (in, out)
        self.b = _param(b)     # (out,)

    def forward(self, x):
        return x @ self.w + self.b


class NoisyNoise(NamedTuple):
    eps_w: torch.Tensor    # (in, out)
    eps_b: torch.Tensor    # (out,)


class NoisyLinear(nn.Module):
    def __init__(self, w_mu, w_sigma, b_mu, b_sigma):
        super().__init__()
        self.w_mu = _param(w_mu)          # (in, out)
        self.w_sigma = _param(w_sigma)
        self.b_mu = _param(b_mu)          # (out,)
        self.b_sigma = _param(b_sigma)

    def forward(self, x, noise: Optional[NoisyNoise] = None):
        """``noise=None`` is eval mode (mu only)."""
        if noise is None:
            return x @ self.w_mu + self.b_mu
        w = self.w_mu + self.w_sigma * noise.eps_w
        b = self.b_mu + self.b_sigma * noise.eps_b
        return x @ w + b


def dense_init(generator, in_features, out_features, device="cpu") -> Dense:
    """U(±1/sqrt(fan_in)) for both w and b."""
    bound = 1.0 / in_features ** 0.5
    return Dense(_uniform(generator, (in_features, out_features), bound, device),
                 _uniform(generator, (out_features,), bound, device))


def noisy_init(generator, in_features, out_features, sigma_init=0.017,
               device="cpu") -> NoisyLinear:
    bound = 1.0 / in_features ** 0.5
    return NoisyLinear(
        _uniform(generator, (in_features, out_features), bound, device),
        torch.full((in_features, out_features), sigma_init, device=device),
        _uniform(generator, (out_features,), bound, device),
        torch.full((out_features,), sigma_init, device=device),
    )


def scale_noise(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def sample_noise(generator, in_features, out_features, device="cpu",
                 batch=()) -> NoisyNoise:
    """Factorized Gaussian noise (the reference's ``reset_noise``), with
    optional leading ``batch`` dims (one independent draw each)."""
    batch = tuple(batch)
    eps_in = scale_noise(torch.randn(batch + (in_features,),
                                     generator=generator))
    eps_out = scale_noise(torch.randn(batch + (out_features,),
                                      generator=generator))
    eps_w = eps_in.unsqueeze(-1) * eps_out.unsqueeze(-2)
    return NoisyNoise(eps_w=eps_w.to(device), eps_b=eps_out.to(device))
