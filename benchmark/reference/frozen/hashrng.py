"""Frozen copy of ``pingpong_tpu_torch/ops/pong_kernel.py`` (the counter-hash
draws only), as the port had it when the benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Counter-hash RNG (pingpong_tpu/ops/pong_kernel.py::_hash_uniform)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def hash_u01(seed_mix, ctr, k, row, col) -> torch.Tensor:
    """U[0,1) float32 from the xorshift counter hash. Arguments broadcast;
    uint32 arithmetic is carried in int64 with ``& 0xFFFFFFFF`` (CPU
    torch lacks most uint32 ops)."""
    x = (torch.as_tensor(seed_mix, dtype=torch.int64)
         + ctr * 2654435761 + k * 0x9E3779B9
         + torch.as_tensor(row, dtype=torch.int64) * 40503
         + torch.as_tensor(col, dtype=torch.int64) * 69069) & _M32
    for _ in range(2):
        x = x ^ ((x << 13) & _M32)
        x = x ^ (x >> 17)
        x = x ^ ((x << 5) & _M32)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def tile_seed_mix(seed: int, n_tiles: int, device,
                  tile0: int = 0) -> torch.Tensor:
    """``seed ^ (tile * 747796405)`` per tile, as uint32 in int64, for the
    global tiles ``tile0 .. tile0 + n_tiles - 1``."""
    tiles = torch.arange(tile0, tile0 + n_tiles, dtype=torch.int64,
                         device=device)
    return (seed & _M32) ^ ((tiles * 747796405) & _M32)
