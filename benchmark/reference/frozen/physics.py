"""Frozen copy of ``pingpong_tpu_torch/env/physics.py`` (the paddle collision),
as the port had it when the benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import torch


def collide_sphere_with_moving_plane(vn, vt, u, omega, e, mu, m, R):
    """Resolve a sphere/moving-plane impact. Returns
    ``(vn_post, vt_post, omega_post)``."""
    vn_post = -e * vn
    Jn = m * (1.0 + e) * torch.abs(vn)
    I = 0.4 * m * R * R
    Jt_star = (2.0 * m / 7.0) * (u + R * omega - vt)
    max_friction_impulse = mu * Jn

    vrel = (vt - u) - R * omega
    # math.copysign(1, vrel) in the reference: +1 at vrel == +0.0
    sign_vrel = torch.where(vrel >= 0.0, 1.0, -1.0)
    Jt = torch.where(
        torch.abs(Jt_star) <= max_friction_impulse,
        Jt_star,
        -max_friction_impulse * sign_vrel,
    )
    # divide by a full tensor: on the card PyTorch divides by a Python
    # scalar as a product with its reciprocal, one rounding away from the
    # quotient that the CPU, the JAX package and the CUDA kernels compute
    vt_post = vt + Jt / torch.full_like(Jt, m)
    omega_post = omega - (R * Jt) / torch.full_like(Jt, I)
    return vn_post, vt_post, omega_post
