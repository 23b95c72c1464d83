"""Frozen copy of ``pingpong_tpu_torch/train/optim.py`` (Adam and clipping as
optax computes them), as the port had it when the benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import math

import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_(params: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor, step: int, lr: float) -> None:
    """One Adam step ``step`` (the count after this update, from 1) on
    ``params``, ``m`` and ``v`` in place."""
    t = torch.tensor(float(step), device=params.device)
    bc1 = 1.0 - torch.exp(t * math.log(B1))
    bc2 = 1.0 - torch.exp(t * math.log(B2))
    mj = m * B1 + g * (1.0 - B1)
    vj = v * B2 + g * g * (1.0 - B2)
    m.copy_(mj)
    v.copy_(vj)
    params.copy_(params - lr * ((mj / bc1) / (torch.sqrt(vj / bc2)
                                              + ADAM_EPS)))


def clip_by_global_norm(g: torch.Tensor, clip: float) -> torch.Tensor:
    """``g`` scaled to a global norm of at most ``clip``."""
    gnorm = torch.sqrt((g * g).sum())
    return g * (clip / torch.clamp(gnorm, min=clip))
