"""Fused-kernel win-rate estimation for the self-play gates (port of
``pingpong_tpu/evaluation/fast_eval.py``): greedy episodes through a
rollout kernel in eval mode (learner sigmas and epsilon zero, no
transitions) until at least ``min_episodes`` finished, so the episode
count is >= N where the reference plays exactly N; the per-episode win
distribution is the same. Both families' seats run one chunk loop
(:func:`_stream_chunks`) and one side-balanced rule; a seat gives the start
state, the launch and its counters' layout. A QNet seat runs kernel 1 with
no step cap on both nets as its flat vectors (:class:`GateNet`, gathered
from the raveled parameters; the loop keeps a frozen net's packs in
:class:`FrozenPacks` for its lifetime), the start state copied once from
pinned memory. A recurrent seat packs both nets and runs kernel 3 with
both LSTM streams carried across chunks and the DRQN ``max_episode_steps``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from pingpong_tpu_torch.env.pong import EnvParams, reset, serve_from_uniforms
from pingpong_tpu_torch.models.qnet import QNet, qnet_to_flat
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


def _stream_chunks(launch, fields, generator, min_episodes, max_chunks,
                   chunk_env_steps):
    """The gates' chunk loop: a seed a chunk for ``launch(seed)``, which
    runs the chunk and returns its counters on the device, one host read of
    them (``fields`` index ``[games vs A, wins vs A, games vs pool, wins vs
    pool, draws]``), the tracer's ``gate::chunks``, ``gate::env_steps`` and
    ``gate::episodes``. Returns (bottom_wins, draws, episodes)."""
    wins = draws = episodes = 0
    for _ in range(max_chunks):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        t = trace.readback(launch(seed))
        games_a, wins_a, games_p, wins_p, drawn = (int(t[i]) for i in fields)
        trace.count("gate::chunks")
        trace.count("gate::env_steps", chunk_env_steps)
        trace.count("gate::episodes", games_a + games_p)
        episodes += games_a + games_p
        wins += wins_a + wins_p
        draws += drawn
        if episodes >= min_episodes:
            break
    return wins, draws, episodes


def _actor_seat(bottom: GateNet, top: GateNet, min_episodes, env_params,
                generator, n_envs, chunk_steps, max_chunks, tile_rows,
                device):
    """Kernel 1 with ``bottom``'s seat pack in the learner seat (player B)
    and ``top``'s one-slot mirror as the bound opponent (player A): every
    env on slot 0, so the launch needs no bounds read."""
    if n_envs % tile_rows:
        raise ValueError(f"batch {n_envs} must be a multiple of {tile_rows}")
    f_in = _start_rows(env_params, n_envs, generator, device)
    i_in = torch.zeros((5, n_envs), dtype=torch.int32, device=device)

    def launch(seed):
        nonlocal f_in, i_in
        f_in, i_in, stats = actor_rollout_rows(
            env_params, f_in, i_in, bottom.seat, top.mirror, seed=seed,
            eps_i=0, steps=chunk_steps, max_episode_steps=0,
            tile_rows=tile_rows)
        return stats.sum(dim=1)

    # [games/wins vs A, games/wins vs pool, return sum, ended, draws]
    return _stream_chunks(launch, (0, 1, 2, 3, 6), generator, min_episodes,
                          max_chunks, n_envs * chunk_steps)


def _zero_rnn_sigma(params: QNetRNN) -> QNetRNN:
    out = qnet_rnn_copy(params)
    for layer in (out.fc_a, out.shared):
        if layer is not None:
            layer.w_sigma.data.zero_()
            layer.b_sigma.data.zero_()
    return out


def _recurrent_seat(bottom: QNetRNN, top: QNetRNN, min_episodes, env_params,
                    generator, n_envs, chunk_steps, max_chunks, tile_rows,
                    max_episode_steps, device):
    """Kernel 3 with ``bottom`` in the learner seat and ``top`` as the
    one-slot opponent, both packed from copies; the hidden states carried
    across chunks (zero-reset on episode ends in-kernel)."""
    learner = _zero_rnn_sigma(bottom).to(device)
    lw, sig = pack_qnet_rnn(learner), pack_rnn_sigma(learner)
    opp = pack_qnet_rnn([qnet_rnn_copy(top).to(device)], mirror=True)
    opp_flat = rnn_kernel_flat(opp) if opp.w1t.is_cuda else None
    state = reset(env_params, n_envs, generator, device)
    H = bottom.lstm[0].w_hh.shape[0]
    hid = torch.zeros((4 * H, n_envs), dtype=torch.float32, device=device)
    opp_idx = torch.zeros((n_envs,), dtype=torch.int32, device=device)
    ep_ret = torch.zeros((n_envs,), dtype=torch.float32, device=device)

    def launch(seed):
        nonlocal state, opp_idx, ep_ret, hid
        state, opp_idx, ep_ret, hid, _, stats, _, _ = recurrent_rollout(
            env_params, state, opp_idx, ep_ret, hid, lw, sig, opp, seed=seed,
            epsilon=0.0, steps=chunk_steps,
            max_episode_steps=max_episode_steps, tile_rows=tile_rows,
            emit_transitions=False, opponents_flat=opp_flat)
        return stats

    return _stream_chunks(launch, (0, 1, 2, 3, 4), generator, min_episodes,
                          max_chunks, n_envs * chunk_steps)


def _win_rate(seat, a, b, min_episodes, *args):
    wins, _, episodes = seat(b, a, min_episodes, *args)
    return (wins / episodes if episodes else 0.0), episodes


def _win_rate_balanced(seat, a, b, min_episodes, *args):
    """>= min/2 episodes a seating, the two weighing equally; seat 2 puts A
    in the learner seat, so B's wins there are ``episodes - A wins -
    draws``."""
    half = max(1, min_episodes // 2)
    wins_b, _, eps_b = seat(b, a, half, *args)
    wins_a_opp, draws_a, eps_a = seat(a, b, half, *args)
    rate_b = wins_b / max(eps_b, 1)
    rate_a = (eps_a - wins_a_opp - draws_a) / max(eps_a, 1)
    return (rate_b + rate_a) / 2, rate_b, rate_a, eps_b + eps_a


def fused_win_rate(env_params: EnvParams, params_a, params_b,
                   generator: torch.Generator, min_episodes: int,
                   n_envs: int = 4096, chunk_steps: int = 256,
                   max_chunks: int = 32, tile_rows: int = 512,
                   device="cuda"):
    """B's win rate vs frozen A (``pallas_win_rate`` in the JAX package);
    each net a QNet or its :class:`GateNet`. Returns ``(win_rate_b,
    episodes_played)``."""
    a, b = _as_gate_net(params_a, device), _as_gate_net(params_b, device)
    return _win_rate(_actor_seat, a, b, min_episodes, env_params, generator,
                     n_envs, chunk_steps, max_chunks, tile_rows, device)


def fused_win_rate_balanced(env_params: EnvParams, params_a, params_b,
                            generator: torch.Generator, min_episodes: int,
                            n_envs: int = 4096, chunk_steps: int = 256,
                            max_chunks: int = 32, tile_rows: int = 512,
                            device="cuda"):
    """Side-balanced gate (``pallas_win_rate_balanced``); each net a QNet
    or its :class:`GateNet` (with its mirror). Returns ``(win_rate_total,
    win_rate_as_b, win_rate_as_a, episodes_total)``."""
    a, b = _as_gate_net(params_a, device), _as_gate_net(params_b, device)
    return _win_rate_balanced(_actor_seat, a, b, min_episodes, env_params,
                              generator, n_envs, chunk_steps, max_chunks,
                              tile_rows, device)


def rnn_win_rate(env_params: EnvParams, params_a: QNetRNN,
                 params_b: QNetRNN, generator: torch.Generator,
                 min_episodes: int, n_envs: int = 2048,
                 chunk_steps: int = 256, max_chunks: int = 32,
                 tile_rows: int = 512, max_episode_steps: int = 1000,
                 device="cuda"):
    """Fused single-seat gate for the recurrent family. Returns
    ``(win_rate_b, episodes_played)``."""
    return _win_rate(_recurrent_seat, params_a, params_b, min_episodes,
                     env_params, generator, n_envs, chunk_steps, max_chunks,
                     tile_rows, max_episode_steps, device)


def rnn_win_rate_balanced(env_params: EnvParams, params_a: QNetRNN,
                          params_b: QNetRNN, generator: torch.Generator,
                          min_episodes: int, n_envs: int = 2048,
                          chunk_steps: int = 256, max_chunks: int = 32,
                          tile_rows: int = 512, max_episode_steps: int = 1000,
                          device="cuda"):
    """Side-balanced recurrent gate. Returns ``(win_rate_total,
    win_rate_as_b, win_rate_as_a, episodes_total)``."""
    return _win_rate_balanced(_recurrent_seat, params_a, params_b,
                              min_episodes, env_params, generator, n_envs,
                              chunk_steps, max_chunks, tile_rows,
                              max_episode_steps, device)
