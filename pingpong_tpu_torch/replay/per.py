"""Prioritized experience replay in the chunk-block layout (port of the
``block=True`` layout of ``pingpong_tpu/replay/per.py``).

``data`` is ``(N/128, 2*obs_dim+2, 128)`` float32: chunk-major blocks whose
row r, lane l hold field r of slot ``chunk*128 + l``, fields
``[obs | next_obs | reward | action + 4*done]`` (action and done share one
float exactly). Beside it: raw priorities ``prios (N,)``, the cached
``p_alpha = prios**alpha (N,)`` and per-chunk sums ``chunk_sums (N/128,)``
of ``p_alpha``. Sampling is two-level inverse CDF (chunks, then slots in
the chunk). New transitions get the current max raw priority (1.0 when
empty). Unlike the JAX package, pushes update the buffer IN PLACE (the
replay ring is 64 MB at the shipped size); ``pos`` and ``size`` are host
integers.

The classic row layout is not ported: the update kernel reads blocks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

CHUNK = 128


class Transition(NamedTuple):
    obs: torch.Tensor        # (M, obs_dim) f32
    action: torch.Tensor     # (M,) i32
    reward: torch.Tensor     # (M,) f32
    next_obs: torch.Tensor   # (M, obs_dim) f32
    done: torch.Tensor       # (M,) bool


class PERSample(NamedTuple):
    batch: Transition
    indices: torch.Tensor    # (bs,) i64
    weights: torch.Tensor    # (bs,) f32, max-normalized


@dataclasses.dataclass
class PERBuffer:
    data: torch.Tensor        # (N/128, 2d+2, 128) f32
    prios: torch.Tensor       # (N,)
    p_alpha: torch.Tensor     # (N,)
    chunk_sums: torch.Tensor  # (N/128,)
    pos: int = 0
    size: int = 0

    @property
    def obs_dim(self) -> int:
        return (self.data.shape[1] - 2) // 2

    @property
    def capacity(self) -> int:
        return self.prios.shape[0]


def per_init(capacity: int, obs_dim: int = 7, device="cpu") -> PERBuffer:
    if capacity % CHUNK:
        raise ValueError(f"block layout needs capacity % {CHUNK} == 0, "
                         f"got {capacity}")
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return PERBuffer(data=z(capacity // CHUNK, 2 * obs_dim + 2, CHUNK),
                     prios=z(capacity), p_alpha=z(capacity),
                     chunk_sums=z(capacity // CHUNK))


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
    max raw priority, and recompute every chunk sum densely (in place)."""
    m = batch.action.shape[0]
    cap = buf.capacity
    max_p = buf.prios.max() if buf.size > 0 else torch.tensor(
        1.0, device=buf.prios.device)
    idx = (buf.pos + torch.arange(m, device=buf.data.device)) % cap
    fields = pack_block_fields(batch)
    buf.data[(idx // CHUNK)[:, None],
             torch.arange(fields.shape[1], device=idx.device)[None, :],
             (idx % CHUNK)[:, None]] = fields
    buf.prios[idx] = max_p
    buf.p_alpha[idx] = max_p ** alpha
    buf.chunk_sums.copy_(buf.p_alpha.view(-1, CHUNK).sum(dim=1))
    buf.pos = (buf.pos + m) % cap
    buf.size = min(buf.size + m, cap)
    return buf


def per_sample(buf: PERBuffer, batch_size: int, beta, u01: torch.Tensor,
               normalize: bool = True) -> PERSample:
    """Two-level prioritized sample from pre-drawn uniforms ``u01 (bs,)``
    with importance weights ``(N P(i))^-beta`` (max-normalized)."""
    cap = buf.capacity
    n_chunks = cap // CHUNK
    chunk_cdf = torch.cumsum(buf.chunk_sums, dim=0)
    total = chunk_cdf[-1]
    u = u01 * total
    cidx = torch.clamp((chunk_cdf[None, :] < u[:, None]).sum(dim=1),
                       0, n_chunks - 1)
    prev = chunk_cdf[torch.clamp(cidx - 1, min=0)]
    residual = u - torch.where(cidx > 0, prev, torch.zeros_like(prev))
    rows = buf.p_alpha.view(n_chunks, CHUNK)[cidx]
    row_cdf = torch.cumsum(rows, dim=1)
    offset = torch.clamp((row_cdf < residual[:, None]).sum(dim=1),
                         0, CHUNK - 1)
    idx = torch.clamp(cidx * CHUNK + offset, 0, max(buf.size - 1, 0))
    probs = buf.p_alpha[idx] / torch.clamp(total, min=1e-30)
    n = float(buf.size)
    weights = (n * torch.clamp(probs, min=1e-30)) ** (-beta)
    if normalize:
        weights = weights / torch.clamp(weights.max(), min=1e-30)
    fields = buf.data[idx // CHUNK, :, idx % CHUNK]
    return PERSample(batch=decode_block_fields(fields, buf.obs_dim),
                     indices=idx, weights=weights)


def last_writer_wins(idx: torch.Tensor, vals: torch.Tensor):
    """Deduplicate a chronological stream of ``(slot, value)`` writes:
    returns the distinct slots and, for each, the value written last."""
    srt = torch.sort(idx, stable=True).indices
    si, sv = idx[srt], vals[srt]
    last = torch.ones_like(si, dtype=torch.bool)
    last[:-1] = si[:-1] != si[1:]
    return si[last], sv[last]


def beta_schedule(frame_idx: int, beta_start: float, beta_frames: int):
    """Linear beta anneal, in float32 as the JAX package computes it."""
    f = torch.tensor(float(frame_idx), dtype=torch.float32)
    return torch.clamp(
        beta_start + f * (1.0 - beta_start) / beta_frames, max=1.0)
