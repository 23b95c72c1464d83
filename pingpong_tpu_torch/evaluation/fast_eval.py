"""Fused-kernel win-rate estimation for the self-play gates (port of
``pingpong_tpu/evaluation/fast_eval.py``).

Streams greedy episodes through a rollout kernel in eval mode (learner
sigmas and epsilon zero, no transitions) and reads the win/episode
counters: one launch per ``chunk_steps`` steps of ``n_envs`` envs, until at
least ``min_episodes`` episodes finished (each chunk counted in the
tracer's ``gate::chunks``, ``gate::env_steps`` and ``gate::episodes``).
The QNet gates run the actor kernel with no step cap; the recurrent gates
run the recurrent kernel with both LSTM streams carried across chunks and
the DRQN config's ``max_episode_steps``. The estimator differs from
exactly-N games only in that the episode count is >= N; the per-episode
win distribution is the same.

A QNet gate seat launches kernel 1 on its own operands: both nets as the
kernel's flat vectors (:class:`GateNet`, gathered from the raveled
parameters; the loop keeps a frozen net's packs in :class:`FrozenPacks`
for the net's lifetime), the start state copied once from pinned memory,
each chunk's output state fed to the next, and one host read a chunk.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from pingpong_tpu_torch.env.pong import EnvParams, reset, serve_from_uniforms
from pingpong_tpu_torch.models.qnet import QNet, qnet_copy, qnet_to_flat
from pingpong_tpu_torch.models.qnet_rnn import QNetRNN, qnet_rnn_copy
from pingpong_tpu_torch.ops.actor_rollout import (
    actor_rollout_rows,
    flat_mirror_pack,
    flat_seat_pack,
)
from pingpong_tpu_torch.ops.recurrent_rollout import (
    pack_qnet_rnn,
    pack_rnn_sigma,
    recurrent_rollout,
    rnn_kernel_flat,
)
from pingpong_tpu_torch.utils import trace


def _count_chunk(env_steps: int, episodes: int) -> None:
    """A gate chunk in the tracer's counters (``gate::chunks``,
    ``gate::env_steps``, ``gate::episodes``)."""
    trace.count("gate::chunks")
    trace.count("gate::env_steps", env_steps)
    trace.count("gate::episodes", episodes)


def _zero_sigma(params: QNet) -> QNet:
    out = qnet_copy(params)
    out.fc_a.w_sigma.data.zero_()
    out.fc_a.b_sigma.data.zero_()
    return out


class GateNet(NamedTuple):
    """One QNet in kernel 1's flat layout (``ops/actor_rollout.py::
    packed_flat``), as it sits in a gate: ``seat (NET,)`` the learner seat
    with zero sigmas, ``mirror (1, NET)`` the mirror-folded opponent slot
    (None where no seat of the gate needs it)."""

    seat: torch.Tensor
    mirror: Optional[torch.Tensor]


def gate_net(flat: torch.Tensor, like: QNet, mirror: bool = True) -> GateNet:
    """A net's gate packs gathered from its raveled parameters (``flat``
    in ``qnet_to_flat`` order, e.g. the learner's ``state.params``;
    ``like`` gives the shapes), counted in ``gate::packs``."""
    trace.count("gate::packs")
    return GateNet(flat_seat_pack(flat, like),
                   flat_mirror_pack(flat, like) if mirror else None)


def _as_gate_net(params, device) -> GateNet:
    if isinstance(params, GateNet):
        return params
    return gate_net(qnet_to_flat(params).to(device), params)


class FrozenPacks:
    """The gate packs of frozen nets, each kept with the net it was made
    from (held by reference) for as long as this holder lives: whoever
    replaces the nets starts a new holder. Reuses count in
    ``gate::pack_hits``."""

    def __init__(self, device):
        self.device = device
        self._held: List[Tuple[QNet, GateNet]] = []

    def __call__(self, net: QNet) -> GateNet:
        for held, packs in self._held:
            if held is net:
                trace.count("gate::pack_hits")
                return packs
        packs = _as_gate_net(net, self.device)
        self._held.append((net, packs))
        return packs


def _start_rows(env_params, n_envs, generator, device) -> torch.Tensor:
    """:func:`~pingpong_tpu_torch.env.pong.reset`'s start state, drawn as
    it draws, as kernel 1's ``f_in (8, n)`` rows, on the device in one copy
    from pinned host memory (the stream does not wait for it)."""
    u = torch.rand((4, n_envs), generator=generator, dtype=torch.float32)
    vx, vy, spin = serve_from_uniforms(env_params, u[0], u[1], u[2], u[3])
    rows = torch.empty((8, n_envs), dtype=torch.float32,
                       pin_memory=torch.device(device).type == "cuda")
    rows[[0, 1, 4, 5]] = 0.5            # ball x, y, both paddles
    rows[2], rows[3], rows[6] = vx, vy, spin
    rows[7] = 0.0                       # episode return
    return rows.to(device, non_blocking=True)


def _stream_seat(env_params, seat, opp, generator, min_episodes, n_envs,
                 chunk_steps, max_chunks, tile_rows, device):
    """Greedy episodes with the packed ``seat`` in the kernel's learner
    seat (player B) and the one-slot ``opp`` as the bound opponent (player
    A, mirror-folded): every env on slot 0, so the launch needs no bounds
    read, and each chunk's state feeds the next. One read of the chunk's
    stats a chunk. Returns (bottom_wins, draws, episodes)."""
    if n_envs % tile_rows:
        raise ValueError(f"batch {n_envs} must be a multiple of {tile_rows}")
    f_in = _start_rows(env_params, n_envs, generator, device)
    i_in = torch.zeros((5, n_envs), dtype=torch.int32, device=device)
    wins = draws = episodes = 0
    for _ in range(max_chunks):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        f_in, i_in, stats = actor_rollout_rows(
            env_params, f_in, i_in, seat, opp, seed=seed, eps_i=0,
            steps=chunk_steps, max_episode_steps=0, tile_rows=tile_rows)
        # [games/wins vs A, games/wins vs pool, return sum, ended, draws]
        t = trace.readback(stats.sum(dim=1))
        s = [int(t[i]) for i in (0, 1, 2, 3, 6)]
        _count_chunk(n_envs * chunk_steps, s[0] + s[2])
        episodes += s[0] + s[2]
        wins += s[1] + s[3]
        draws += s[4]
        if episodes >= min_episodes:
            break
    return wins, draws, episodes


def fused_win_rate(env_params: EnvParams, params_a, params_b,
                   generator: torch.Generator, min_episodes: int,
                   n_envs: int = 4096, chunk_steps: int = 256,
                   max_chunks: int = 32, tile_rows: int = 512,
                   device="cuda"):
    """B's win rate vs frozen A (``pallas_win_rate`` in the JAX package);
    each net a QNet or its :class:`GateNet`. Returns ``(win_rate_b,
    episodes_played)``."""
    a, b = _as_gate_net(params_a, device), _as_gate_net(params_b, device)
    wins, _, episodes = _stream_seat(
        env_params, b.seat, a.mirror, generator, min_episodes, n_envs,
        chunk_steps, max_chunks, tile_rows, device)
    return (wins / episodes if episodes else 0.0), episodes


def fused_win_rate_balanced(env_params: EnvParams, params_a, params_b,
                            generator: torch.Generator, min_episodes: int,
                            n_envs: int = 4096, chunk_steps: int = 256,
                            max_chunks: int = 32, tile_rows: int = 512,
                            device="cuda"):
    """Side-balanced gate (``pallas_win_rate_balanced``): >= min/2
    episodes per seating; seat 2 puts A in the learner seat, so B's wins
    there are ``episodes - A wins - draws``. The two seats weigh equally.
    Each net a QNet or its :class:`GateNet` (with its mirror). Returns
    ``(win_rate_total, win_rate_as_b, win_rate_as_a, episodes_total)``."""
    a, b = _as_gate_net(params_a, device), _as_gate_net(params_b, device)
    half = max(1, min_episodes // 2)
    wins_b, _, eps_b = _stream_seat(
        env_params, b.seat, a.mirror, generator, half, n_envs,
        chunk_steps, max_chunks, tile_rows, device)
    wins_a_opp, draws_a, eps_a = _stream_seat(
        env_params, a.seat, b.mirror, generator, half, n_envs,
        chunk_steps, max_chunks, tile_rows, device)
    rate_b = wins_b / max(eps_b, 1)
    rate_a = (eps_a - wins_a_opp - draws_a) / max(eps_a, 1)
    return (rate_b + rate_a) / 2, rate_b, rate_a, eps_b + eps_a


# ---- recurrent (DRQN) family --------------------------------------------


def _zero_rnn_sigma(params: QNetRNN) -> QNetRNN:
    out = qnet_rnn_copy(params)
    for layer in (out.fc_a, out.shared):
        if layer is not None:
            layer.w_sigma.data.zero_()
            layer.b_sigma.data.zero_()
    return out


def _stream_seat_rnn(env_params, bottom, top, generator, min_episodes,
                     n_envs, chunk_steps, max_chunks, tile_rows,
                     max_episode_steps, device):
    """Recurrent analog of :func:`_stream_seat`: greedy episodes with
    ``bottom`` in the kernel's learner seat, hidden states carried across
    chunks (zero-reset on episode ends in-kernel). Returns
    (bottom_wins, draws, episodes)."""
    learner = _zero_rnn_sigma(bottom).to(device)
    lw, sig = pack_qnet_rnn(learner), pack_rnn_sigma(learner)
    opp = pack_qnet_rnn([qnet_rnn_copy(top).to(device)], mirror=True)
    opp_flat = rnn_kernel_flat(opp) if opp.w1t.is_cuda else None
    state = reset(env_params, n_envs, generator, device)
    H = bottom.lstm[0].w_hh.shape[0]
    hid = torch.zeros((4 * H, n_envs), dtype=torch.float32, device=device)
    opp_idx = torch.zeros((n_envs,), dtype=torch.int32, device=device)
    ep_ret = torch.zeros((n_envs,), dtype=torch.float32, device=device)
    wins = draws = episodes = 0
    for _ in range(max_chunks):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        state, opp_idx, ep_ret, hid, _, stats, _, _ = recurrent_rollout(
            env_params, state, opp_idx, ep_ret, hid, lw, sig, opp, seed=seed,
            epsilon=0.0, steps=chunk_steps,
            max_episode_steps=max_episode_steps, tile_rows=tile_rows,
            emit_transitions=False, opponents_flat=opp_flat)
        s = trace.readback(stats)
        _count_chunk(n_envs * chunk_steps, s[0] + s[2])
        episodes += s[0] + s[2]
        wins += s[1] + s[3]
        draws += s[4]
        if episodes >= min_episodes:
            break
    return wins, draws, episodes


def rnn_win_rate(env_params: EnvParams, params_a: QNetRNN,
                 params_b: QNetRNN, generator: torch.Generator,
                 min_episodes: int, n_envs: int = 2048,
                 chunk_steps: int = 256, max_chunks: int = 32,
                 tile_rows: int = 512, max_episode_steps: int = 1000,
                 device="cuda"):
    """Fused single-seat gate for the recurrent family. Returns
    ``(win_rate_b, episodes_played)``."""
    wins, _, episodes = _stream_seat_rnn(
        env_params, params_b, params_a, generator, min_episodes, n_envs,
        chunk_steps, max_chunks, tile_rows, max_episode_steps, device)
    return (wins / episodes if episodes else 0.0), episodes


def rnn_win_rate_balanced(env_params: EnvParams, params_a: QNetRNN,
                          params_b: QNetRNN, generator: torch.Generator,
                          min_episodes: int, n_envs: int = 2048,
                          chunk_steps: int = 256, max_chunks: int = 32,
                          tile_rows: int = 512, max_episode_steps: int = 1000,
                          device="cuda"):
    """Side-balanced recurrent gate: >= min/2 episodes per seating, the
    two seats weighted equally. Returns ``(win_rate_total, win_rate_as_b,
    win_rate_as_a, episodes_total)``."""
    half = max(1, min_episodes // 2)
    kw = dict(n_envs=n_envs, chunk_steps=chunk_steps, max_chunks=max_chunks,
              tile_rows=tile_rows, max_episode_steps=max_episode_steps,
              device=device)
    wins_b, _, eps_b = _stream_seat_rnn(env_params, params_b, params_a,
                                        generator, half, **kw)
    wins_a_opp, draws_a, eps_a = _stream_seat_rnn(
        env_params, params_a, params_b, generator, half, **kw)
    rate_b = wins_b / max(eps_b, 1)
    rate_a = (eps_a - wins_a_opp - draws_a) / max(eps_a, 1)
    return (rate_b + rate_a) / 2, rate_b, rate_a, eps_b + eps_a
