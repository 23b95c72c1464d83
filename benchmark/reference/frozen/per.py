"""Frozen copy of ``pingpong_tpu_torch/replay/per.py`` (the prioritized
replay), as the port had it when the benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

CHUNK = 128        # the block layout's chunk, and every chunk's upper bound


class Transition(NamedTuple):
    obs: torch.Tensor        # (M, obs_dim) f32
    action: torch.Tensor     # (M,) i32
    reward: torch.Tensor     # (M,) f32
    next_obs: torch.Tensor   # (M, obs_dim) f32
    done: torch.Tensor       # (M,) bool


@dataclasses.dataclass
class PERBuffer:
    data: torch.Tensor        # (N, 2d+3) rows or (N/128, 2d+2, 128) blocks
    prios: torch.Tensor       # (N,)
    p_alpha: torch.Tensor     # (N,)
    chunk_sums: torch.Tensor  # (N/chunk,)
    pos: int = 0
    size: int = 0

    @property
    def is_block(self) -> bool:
        return self.data.dim() == 3

    @property
    def obs_dim(self) -> int:
        if self.is_block:
            return (self.data.shape[1] - 2) // 2
        return (self.data.shape[1] - 3) // 2

    @property
    def capacity(self) -> int:
        return self.prios.shape[0]

    @property
    def chunk(self) -> int:
        return self.capacity // self.chunk_sums.shape[0]


def pack_transitions(batch: Transition) -> torch.Tensor:
    """``(M, ...)`` Transition -> ``(M, 2d+3)`` packed rows."""
    return torch.cat([batch.obs, batch.next_obs,
                      batch.action.to(torch.float32)[:, None],
                      batch.reward[:, None],
                      batch.done.to(torch.float32)[:, None]], dim=1)


def pack_block_fields(batch: Transition) -> torch.Tensor:
    """``(M, ...)`` Transition -> ``(M, 2d+2)`` block field rows."""
    ad = batch.action.to(torch.float32) + 4.0 * batch.done.to(torch.float32)
    return torch.cat([batch.obs, batch.next_obs, batch.reward[:, None],
                      ad[:, None]], dim=1)


def decode_block_fields(fields: torch.Tensor, d: int) -> Transition:
    """``(M, 2d+2)`` block field rows -> Transition."""
    ad = fields[:, 2 * d + 1]
    done = ad > 3.5
    return Transition(
        obs=fields[:, :d],
        action=(ad - 4.0 * done.to(torch.float32)).to(torch.int32),
        reward=fields[:, 2 * d],
        next_obs=fields[:, d:2 * d],
        done=done,
    )


def per_push(buf: PERBuffer, batch: Transition, alpha: float) -> PERBuffer:
    """Write M transitions at the ring cursor, stamped with the current
    max raw priority, and recompute every chunk sum densely (in place).
    Rows go in as one slice when the push does not wrap the ring, else by
    a scatter; blocks always scatter by lane."""
    m = batch.action.shape[0]
    cap = buf.capacity
    max_p = buf.prios.max() if buf.size > 0 else torch.tensor(
        1.0, device=buf.prios.device)
    if not buf.is_block and buf.pos + m <= cap:
        sl = slice(buf.pos, buf.pos + m)
        buf.data[sl] = pack_transitions(batch)
        buf.prios[sl] = max_p
        buf.p_alpha[sl] = max_p ** alpha
    else:
        idx = (buf.pos + torch.arange(m, device=buf.data.device)) % cap
        if buf.is_block:
            fields = pack_block_fields(batch)
            buf.data[(idx // CHUNK)[:, None],
                     torch.arange(fields.shape[1], device=idx.device)[None, :],
                     (idx % CHUNK)[:, None]] = fields
        else:
            buf.data[idx] = pack_transitions(batch)
        buf.prios[idx] = max_p
        buf.p_alpha[idx] = max_p ** alpha
    buf.chunk_sums.copy_(buf.p_alpha.view(-1, buf.chunk).sum(dim=1))
    buf.pos = (buf.pos + m) % cap
    buf.size = min(buf.size + m, cap)
    return buf


def exact_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Prefix sums of float32 ``x`` exact in double, rounded to float32
    once: the update kernel's CDF, whatever order a backend sums in."""
    return torch.cumsum(x.double(), dim=dim).float()


def last_writer_wins(idx: torch.Tensor, vals: torch.Tensor):
    """Deduplicate a chronological stream of ``(slot, value)`` writes:
    returns the distinct slots and, for each, the value written last."""
    srt = torch.sort(idx, stable=True).indices
    si, sv = idx[srt], vals[srt]
    last = torch.ones_like(si, dtype=torch.bool)
    last[:-1] = si[:-1] != si[1:]
    return si[last], sv[last]
