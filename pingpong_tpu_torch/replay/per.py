"""Prioritized experience replay (port of ``pingpong_tpu/replay/per.py``),
in both of its layouts.

* The ROW layout (``per_init(block=False)``, the autodiff update's):
  ``data`` is ``(N, 2*obs_dim+3)`` float32 rows ``[obs | next_obs | action
  | reward | done]`` (actions and done flags round-trip exactly).
* The BLOCK layout (``per_init(block=True)``, the fused update kernel's):
  ``data`` is ``(N/128, 2*obs_dim+2, 128)``, chunk-major blocks whose row
  r, lane l hold field r of slot ``chunk*128 + l``, fields ``[obs |
  next_obs | reward | action + 4*done]`` (action and done share one float
  exactly).

Beside ``data``: raw priorities ``prios (N,)``, the cached ``p_alpha =
prios**alpha (N,)`` and per-chunk sums ``chunk_sums (N/CHUNK,)`` of
``p_alpha``, where the chunk is the largest power-of-two divisor of the
capacity, at most 128 (:func:`chunk_size`; always 128 for blocks).
Sampling is two-level inverse CDF (chunks, then slots in the chunk), its
prefix sums exact and rounded to float32 once (the update kernel's CDF).
New transitions get the current max raw priority (1.0 when empty); a push
recomputes every chunk sum densely, a priority write-back maintains them
incrementally. Unlike the JAX package, pushes and write-backs update the
buffer IN PLACE (the replay ring is 64 MB at the shipped size); ``pos``
and ``size`` are host integers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


CHUNK = 128        # the block layout's chunk, and every chunk's upper bound


def chunk_size(capacity: int) -> int:
    """Largest power-of-two divisor of ``capacity``, at most
    :data:`CHUNK` (a replay of 100000 gets chunks of 32)."""
    c = 1
    while c < CHUNK and capacity % (c * 2) == 0:
        c *= 2
    return c


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


def per_init(capacity: int, obs_dim: int = 7, device="cpu",
             block: bool = False) -> PERBuffer:
    if block and capacity % CHUNK:
        raise ValueError(f"block layout needs capacity % {CHUNK} == 0, "
                         f"got {capacity}")
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    data = (z(capacity // CHUNK, 2 * obs_dim + 2, CHUNK) if block
            else z(capacity, 2 * obs_dim + 3))
    return PERBuffer(data=data, prios=z(capacity), p_alpha=z(capacity),
                     chunk_sums=z(capacity // chunk_size(capacity)))


def pack_transitions(batch: Transition) -> torch.Tensor:
    """``(M, ...)`` Transition -> ``(M, 2d+3)`` packed rows."""
    return torch.cat([batch.obs, batch.next_obs,
                      batch.action.to(torch.float32)[:, None],
                      batch.reward[:, None],
                      batch.done.to(torch.float32)[:, None]], dim=1)


def decode_rows(rows: torch.Tensor, d: int) -> Transition:
    """``(M, 2d+3)`` packed rows -> Transition."""
    return Transition(obs=rows[:, :d],
                      action=rows[:, 2 * d].to(torch.int32),
                      reward=rows[:, 2 * d + 1], next_obs=rows[:, d:2 * d],
                      done=rows[:, 2 * d + 2] > 0.5)


class NStepRows(NamedTuple):
    """Rows of an n-step replay (the Rainbow learner's): the same row
    layout, with the n-step return ``ret`` in the reward field and the
    bootstrap discount ``disc`` (``gamma^n``, 0 where the episode ended
    inside the n steps) in the done field; ``next_obs`` is the
    observation n steps on (or the terminal one)."""

    obs: torch.Tensor        # (M, obs_dim) f32
    action: torch.Tensor     # (M,) i32
    ret: torch.Tensor        # (M,) f32
    next_obs: torch.Tensor   # (M, obs_dim) f32
    disc: torch.Tensor       # (M,) f32


def decode_nstep_rows(rows: torch.Tensor, d: int) -> NStepRows:
    """``(M, 2d+3)`` packed n-step rows -> NStepRows."""
    return NStepRows(obs=rows[:, :d], action=rows[:, 2 * d].to(torch.int32),
                     ret=rows[:, 2 * d + 1], next_obs=rows[:, d:2 * d],
                     disc=rows[:, 2 * d + 2])


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


def per_sample(buf: PERBuffer, batch_size: int, beta, u01: torch.Tensor,
               normalize: bool = True, decode=None,
               size: torch.Tensor = None) -> PERSample:
    """Two-level prioritized sample from pre-drawn uniforms ``u01 (bs,)``
    with importance weights ``(N P(i))^-beta`` (max-normalized unless
    ``normalize=False``), in either layout; ``decode`` reads the sampled
    rows of the row layout (:func:`decode_rows` unless given). ``size``, a
    device tensor, stands for ``buf.size`` (so that the sample reads no
    host value, as a CUDA graph replays it)."""
    ch = buf.chunk
    n_chunks = buf.capacity // ch
    chunk_cdf = exact_cumsum(buf.chunk_sums)
    total = chunk_cdf[-1]
    u = u01 * total
    cidx = torch.clamp((chunk_cdf[None, :] < u[:, None]).sum(dim=1),
                       0, n_chunks - 1)
    prev = chunk_cdf[torch.clamp(cidx - 1, min=0)]
    residual = u - torch.where(cidx > 0, prev, torch.zeros_like(prev))
    rows = buf.p_alpha.view(n_chunks, ch)[cidx]
    row_cdf = exact_cumsum(rows, dim=1)
    offset = torch.clamp((row_cdf < residual[:, None]).sum(dim=1), 0, ch - 1)
    if size is None:
        idx = torch.clamp(cidx * ch + offset, 0, max(buf.size - 1, 0))
        n = float(buf.size)
    else:
        idx = torch.minimum(torch.clamp(cidx * ch + offset, min=0),
                            torch.clamp(size - 1, min=0))
        n = size.to(torch.float32)
    probs = buf.p_alpha[idx] / torch.clamp(total, min=1e-30)
    weights = (n * torch.clamp(probs, min=1e-30)) ** (-beta)
    if normalize:
        weights = weights / torch.clamp(weights.max(), min=1e-30)
    d = buf.obs_dim
    if buf.is_block:
        batch = decode_block_fields(buf.data[idx // CHUNK, :, idx % CHUNK], d)
    else:
        batch = (decode or decode_rows)(buf.data[idx], d)
    return PERSample(batch=batch, indices=idx, weights=weights)


def last_writer_wins(idx: torch.Tensor, vals: torch.Tensor):
    """Deduplicate a chronological stream of ``(slot, value)`` writes on
    fixed sizes: returns every slot, sorted, each beside the value written
    to it last (found by a search for the end of its run in the stable
    sort), so that a scatter of the pairs leaves each slot that value
    whichever of its duplicates lands. Reads nothing on the host."""
    srt = torch.sort(idx, stable=True).indices
    si = idx[srt]
    last = torch.searchsorted(si, si, right=True) - 1
    return si, vals[srt[last]]


def per_update_priorities(buf: PERBuffer, indices: torch.Tensor,
                          td_errors: torch.Tensor, alpha: float,
                          eps: float = 1e-6) -> PERBuffer:
    """Priority write-back ``|td| + eps`` (in place), with INCREMENTAL
    chunk-sum maintenance: each distinct slot's ``p_alpha`` delta, taken at
    its first occurrence in sorted order, is added into its chunk's sum. A
    slot sampled twice keeps the value written last (the JAX package
    leaves one of them, which one is up to its backend)."""
    indices = indices.long()
    new_p = torch.abs(td_errors) + eps
    old_pa = buf.p_alpha[indices]
    slots, vals = last_writer_wins(indices, new_p)
    buf.prios[slots] = vals
    buf.p_alpha[slots] = vals ** alpha
    written = buf.p_alpha[indices]
    order = torch.sort(indices, stable=True).indices
    sorted_idx = indices[order]
    first = torch.ones_like(sorted_idx, dtype=torch.bool)
    first[1:] = sorted_idx[1:] != sorted_idx[:-1]
    delta = torch.where(first, written[order] - old_pa[order],
                        torch.zeros_like(old_pa))
    buf.chunk_sums.index_add_(0, sorted_idx // buf.chunk, delta)
    return buf


def beta_schedule(frame_idx: int, beta_start: float, beta_frames: int):
    """Linear beta anneal, in float32 as the JAX package computes it."""
    f = torch.tensor(float(frame_idx), dtype=torch.float32)
    return torch.clamp(
        beta_start + f * (1.0 - beta_start) / beta_frames, max=1.0)
