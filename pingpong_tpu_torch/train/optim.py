"""Flat Adam and global-norm clipping as optax computes them, on raveled
parameter vectors, in place.

``optax.adam(lr)``: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
bias correction by the step count, ``eps`` outside the square root.
``optax.clip_by_global_norm(c)`` scales the gradient by ``c / max(|g|,
c)``. The update kernels' plain versions and the autodiff learner paths
share these formulas (``torch.optim`` differs in these details).
"""

from __future__ import annotations

import math

import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_(params: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor, step, lr: float,
          eps: float = ADAM_EPS) -> None:
    """One Adam step ``step`` (the count after this update, from 1; an int
    or a device tensor) on ``params``, ``m`` and ``v`` in place; ``eps``
    is optax's default unless given (Rainbow's learner gives its own)."""
    t = (step.to(torch.float32) if isinstance(step, torch.Tensor)
         else torch.tensor(float(step), device=params.device))
    bc1 = 1.0 - torch.exp(t * math.log(B1))
    bc2 = 1.0 - torch.exp(t * math.log(B2))
    mj = m * B1 + g * (1.0 - B1)
    vj = v * B2 + g * g * (1.0 - B2)
    m.copy_(mj)
    v.copy_(vj)
    params.copy_(params - lr * ((mj / bc1) / (torch.sqrt(vj / bc2)
                                              + eps)))


def clip_by_global_norm(g: torch.Tensor, clip: float) -> torch.Tensor:
    """``g`` scaled to a global norm of at most ``clip``."""
    gnorm = torch.sqrt((g * g).sum())
    return g * (clip / torch.clamp(gnorm, min=clip))
