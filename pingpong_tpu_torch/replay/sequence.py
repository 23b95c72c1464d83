"""Device-resident sequence replay for DRQN trace training (port of
``pingpong_tpu/replay/sequence.py``, window-uniform sampling).

A per-env time ring: ``num_envs`` lockstep envs write one transition per
step into a shared column cursor of a ``(num_envs, ring_len)`` ring, each
entry stamped with its env's monotonically increasing episode id. A
window ``[t0, t0+T)`` of row ``b`` is a valid trace when the ids at its
two ends match, it lies in the written region, it is not part of the
in-flight episode, it does not straddle the write seam, and (unless its
last step ends the episode) the element at ``t0+T`` that the derived
``next_obs`` needs is written and time-adjacent. Episodes shorter than
``trace_length`` are not admitted (``ep_count`` counts admitted ones).

``next_obs`` is not stored: a sample fetches ``T+1`` columns and derives
it as the +1-shifted window. The TPU's chunk-major ``(B, R/128, 128*F)``
plane is a layout choice for its gather; the port keeps a flat
``(B, R, F)`` plane with per-step fields ``[obs | action | reward |
done]`` in float32 (actions and done flags round-trip exactly).

Sampling is window-uniform by default. ``seq_init(dir_cap >= 2)`` adds an
episode directory, a ring of ``(env, start cursor, length, episode id)``
records appended time-major as episodes are admitted, for
``seq_sample(episode_uniform=True)``: the reference's two-stage rule, an
admitted episode uniformly with replacement, then a uniform window offset
in it. A record whose columns the ring has since overwritten (its id no
longer at its start) and a window that would wrap the row end are
rejected like any invalid candidate.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pingpong_tpu_torch.utils import trace


@dataclasses.dataclass
class SeqReplay:
    """Mutable ring; :func:`seq_push_rollout` updates it in place."""

    data: torch.Tensor      # (B, R, obs_dim + 3) f32
    ep_id: torch.Tensor     # (B, R) i32, -1 = never written
    cursor: int             # total steps written (shared column cursor)
    ep_count: int           # completed episodes admitted (len >= trace)
    cur_ep_id: torch.Tensor   # (B,) i32 current episode id per env
    cur_ep_len: torch.Tensor  # (B,) i32 running length of the episode
    # the episode directory, (D,) each; one dummy slot when disabled
    dir_env: torch.Tensor     # env row of the admitted episode
    dir_start: torch.Tensor   # absolute cursor of its first step
    dir_len: torch.Tensor     # its length (>= trace_length)
    dir_id: torch.Tensor      # its episode id (the staleness check)
    dir_cursor: int           # episodes ever appended to the directory

    @property
    def obs_dim(self) -> int:
        return self.data.shape[-1] - 3

    @property
    def has_directory(self) -> bool:
        return self.dir_env.shape[0] > 1


class SeqSample(NamedTuple):
    obs: torch.Tensor       # (N, T, obs_dim)
    action: torch.Tensor    # (N, T) i32
    reward: torch.Tensor    # (N, T)
    next_obs: torch.Tensor  # (N, T, obs_dim), derived obs[t0+1 .. t0+T]
    done: torch.Tensor      # (N, T) bool
    valid: torch.Tensor     # (N,) bool: invalid samples are masked


def seq_init(num_envs: int, ring_len: int, obs_dim: int = 7,
             device="cpu", dir_cap: int = 0) -> SeqReplay:
    """``dir_cap >= 2`` adds the episode directory (for
    ``episode_uniform`` sampling); otherwise it is one dummy slot."""
    i32 = lambda n, v=0: torch.full((n,), v, dtype=torch.int32,
                                    device=device)
    d = max(dir_cap, 1)
    return SeqReplay(
        data=torch.zeros((num_envs, ring_len, obs_dim + 3),
                         dtype=torch.float32, device=device),
        ep_id=torch.full((num_envs, ring_len), -1, dtype=torch.int32,
                         device=device),
        cursor=0, ep_count=0, cur_ep_id=i32(num_envs),
        cur_ep_len=i32(num_envs), dir_env=i32(d), dir_start=i32(d),
        dir_len=i32(d), dir_id=i32(d, -1), dir_cursor=0)


def _dir_append(buf: SeqReplay, admitted, env, start, length, ep_id,
                n_admitted: int) -> None:
    """Append the admitted entries of the flat arrays, in order, to the
    directory ring (in place). Past ``dir_cap`` admissions in one call the
    later records overwrite the earlier ones."""
    cap = buf.dir_env.shape[0]
    rows = admitted.nonzero()[:, 0][-cap:]
    slot = (buf.dir_cursor + max(n_admitted - cap, 0)
            + torch.arange(rows.shape[0], device=rows.device)) % cap
    for dst, src in ((buf.dir_env, env), (buf.dir_start, start),
                     (buf.dir_len, length), (buf.dir_id, ep_id)):
        dst[slot] = src[rows].to(torch.int32)
    buf.dir_cursor += n_admitted


def seq_push_rollout(buf: SeqReplay, obs, action, reward, done,
                     trace_length: int) -> None:
    """Write a rollout chunk ``obs (T, B, obs_dim)``, ``action``,
    ``reward``, ``done (T, B)`` in place: T lockstep columns, episode ids
    and running lengths reconstructed from the done mask, episodes of at
    least ``trace_length`` steps admitted."""
    T, B = done.shape
    ring = buf.ep_id.shape[1]
    if T > ring:
        raise ValueError(f"rollout chunk T={T} exceeds ring length {ring}")
    dev = buf.data.device
    cols = (buf.cursor + torch.arange(T, device=dev)) % ring
    done_bt = done.T.to(torch.int32)                          # (B, T)
    prefix = torch.cumsum(done_bt, dim=1, dtype=torch.int32) - done_bt
    ep_ids = buf.cur_ep_id[:, None] + prefix                  # (B, T)
    idx = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    marked = torch.where(done_bt > 0, idx, torch.full_like(idx, -1))
    last_done_incl = torch.cummax(marked, dim=1).values
    last_done_excl = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int32, device=dev),
         last_done_incl[:, :-1]], dim=1)
    length_t = torch.where(last_done_excl < 0,
                           buf.cur_ep_len[:, None] + idx + 1,
                           idx - last_done_excl)
    admitted = (done_bt > 0) & (length_t >= trace_length)
    n_admitted = trace.readback(admitted.sum(), int)
    if buf.has_directory and n_admitted:
        # an episode ending at absolute position cursor + t with length L
        # started at cursor + t - L + 1; appended time-major, as T single
        # steps would append them
        tm = lambda x: x.T.reshape(-1)
        _dir_append(buf, tm(admitted),
                    tm(torch.arange(B, device=dev)[:, None].expand(B, T)),
                    tm(buf.cursor + idx - length_t + 1), tm(length_t),
                    tm(ep_ids), n_admitted)
    any_done = (done_bt > 0).any(dim=1)
    new_cur_len = torch.where(any_done, (T - 1) - last_done_incl[:, -1],
                              buf.cur_ep_len + T)
    packed = torch.cat([obs, action.to(torch.float32)[..., None],
                        reward.to(torch.float32)[..., None],
                        done.to(torch.float32)[..., None]], dim=-1)
    buf.data[:, cols] = packed.transpose(0, 1)
    buf.ep_id[:, cols] = ep_ids
    buf.cursor += T
    buf.ep_count += n_admitted
    buf.cur_ep_id = buf.cur_ep_id + done_bt.sum(dim=1, dtype=torch.int32)
    buf.cur_ep_len = new_cur_len.to(torch.int32)


def window_valid(buf: SeqReplay, env, t0, trace_length: int):
    """The JAX package's ``_window_valid`` rules for ``(env, t0)``
    windows (see the module docstring)."""
    ring = buf.ep_id.shape[1]
    T = trace_length
    id_lo = buf.ep_id[env, t0]
    id_hi = buf.ep_id[env, t0 + T - 1]
    written = min(buf.cursor, ring)
    in_range = (t0 + T) <= written
    not_inflight = id_hi != buf.cur_ep_id[env]
    seam = buf.cursor % ring
    wrapped = buf.cursor >= ring
    straddles_seam = wrapped & (seam > t0) & (seam < t0 + T)
    ok = (id_lo == id_hi) & (id_lo >= 0) & in_range & not_inflight \
        & ~straddles_seam
    end_done = buf.data[env, t0 + T - 1, buf.obs_dim + 2] > 0.5
    if wrapped:
        next_ok = seam != (t0 + T) % ring
    else:
        next_ok = (t0 + T) < buf.cursor
    return ok & (end_done | next_ok)


def draw_candidates(buf: SeqReplay, generator: torch.Generator, n: int,
                    trace_length: int, rounds: int = 4):
    """``rounds * n`` uniform ``(env, t0)`` candidates from ``generator``
    (on the CPU), in the layout :func:`seq_sample` takes."""
    num_envs, ring = buf.ep_id.shape
    env = torch.randint(0, num_envs, (rounds * n,), generator=generator)
    t0 = torch.randint(0, ring - trace_length + 1, (rounds * n,),
                       generator=generator)
    return env, t0


def draw_episode_candidates(buf: SeqReplay, generator: torch.Generator,
                            n: int, trace_length: int, rounds: int = 4):
    """``rounds * n`` episode-uniform candidates ``(directory slot,
    window offset)``: the slot uniform over the filled directory, the
    offset uniform over the episode's windows (from a uniform drawn on the
    CPU, scaled on the buffer's device)."""
    n_dir = min(buf.dir_cursor, buf.dir_env.shape[0])
    slot = torch.randint(0, max(n_dir, 1), (rounds * n,), generator=generator)
    u = torch.rand((rounds * n,), generator=generator)
    slot, u = slot.to(buf.dir_len.device), u.to(buf.dir_len.device)
    hi = torch.clamp(buf.dir_len[slot].long() - trace_length + 1, min=1)
    off = torch.minimum((u * hi).long(), hi - 1)
    return slot, off


def seq_sample(buf: SeqReplay, batch_size: int, trace_length: int,
               cand_a, cand_b, rejection_rounds: int = 4,
               episode_uniform: bool = False) -> SeqSample:
    """``batch_size`` trace windows from ``rejection_rounds * batch_size``
    candidates (round-major: candidate ``r * batch_size + i`` is slot
    ``i``'s round ``r``), all checked in one pass; each slot keeps its
    first valid round, and slots with none are ``valid=False`` (window
    ``(0, 0)``). The candidates are ``(env, t0)`` windows
    (:func:`draw_candidates`), or with ``episode_uniform`` ``(directory
    slot, window offset)`` pairs (:func:`draw_episode_candidates`)."""
    dev = buf.data.device
    T = trace_length
    ring = buf.ep_id.shape[1]
    cand_a = cand_a.to(dev, torch.int64)
    cand_b = cand_b.to(dev, torch.int64)
    if episode_uniform:
        if not buf.has_directory:
            raise ValueError(
                "episode_uniform sampling needs seq_init(dir_cap >= 2)")
        n_dir = min(buf.dir_cursor, buf.dir_env.shape[0])
        slot = cand_a
        cand_env = buf.dir_env[slot].long()
        cand_t0 = (buf.dir_start[slot].long() + cand_b) % ring
        no_wrap = cand_t0 + T <= ring
        t0_in = torch.where(no_wrap, cand_t0, 0)
        ok = (no_wrap & window_valid(buf, cand_env, t0_in, T)
              & (buf.ep_id[cand_env, cand_t0] == buf.dir_id[slot]))
        if n_dir == 0:
            ok = torch.zeros_like(ok)
    else:
        cand_env, cand_t0 = cand_a, cand_b
        ok = window_valid(buf, cand_env, cand_t0, T)
    ok_r = ok.view(rejection_rounds, batch_size)
    first = torch.argmax(ok_r.to(torch.int8), dim=0)
    pick = first * batch_size + torch.arange(batch_size, device=dev)
    valid = ok_r.any(dim=0)
    env = torch.where(valid, cand_env[pick], 0)
    t0 = torch.where(valid, cand_t0[pick], 0)
    tt = (t0[:, None] + torch.arange(T + 1, device=dev)[None, :]) % ring
    rows = buf.data[env[:, None], tt]                       # (N, T+1, F)
    d = buf.obs_dim
    return SeqSample(
        obs=rows[:, :T, :d], action=rows[:, :T, d].to(torch.int32),
        reward=rows[:, :T, d + 1], next_obs=rows[:, 1:, :d],
        done=rows[:, :T, d + 2] > 0.5, valid=valid)
