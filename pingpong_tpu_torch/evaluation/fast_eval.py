"""Fused-kernel win-rate estimation for the self-play gates (port of the
QNet part of ``pingpong_tpu/evaluation/fast_eval.py``).

Streams greedy episodes through the actor-rollout kernel in eval mode
(learner sigmas and epsilon zero, no transitions, no step cap) and reads
the win/episode counters: one launch per ``chunk_steps`` steps of
``n_envs`` envs, until at least ``min_episodes`` episodes finished. The
estimator differs from exactly-N games only in that the episode count is
>= N; the per-episode win distribution is the same.
"""

from __future__ import annotations

import torch

from pingpong_tpu_torch.env.pong import EnvParams, reset
from pingpong_tpu_torch.models.qnet import QNet, qnet_copy
from pingpong_tpu_torch.ops.actor_rollout import actor_rollout, pack_qnet


def _zero_sigma(params: QNet) -> QNet:
    out = qnet_copy(params)
    out.fc_a.w_sigma.data.zero_()
    out.fc_a.b_sigma.data.zero_()
    return out


def _stream_seat(env_params, bottom, top, generator, min_episodes, n_envs,
                 chunk_steps, max_chunks, tile_rows, device):
    """Greedy episodes with ``bottom`` in the kernel's learner seat
    (player B) and ``top`` as the bound opponent (player A, mirror-folded).
    Returns (bottom_wins, draws, episodes)."""
    learner = pack_qnet(_zero_sigma(bottom).to(device))
    opp = pack_qnet([qnet_copy(top).to(device)], mirror=True)
    state = reset(env_params, n_envs, generator, device)
    opp_idx = torch.zeros((n_envs,), dtype=torch.int32, device=device)
    ep_ret = torch.zeros((n_envs,), dtype=torch.float32, device=device)
    wins = draws = episodes = 0
    for _ in range(max_chunks):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        state, opp_idx, ep_ret, _, stats, _, _ = actor_rollout(
            env_params, state, opp_idx, ep_ret, learner, opp, seed=seed,
            epsilon=0.0, steps=chunk_steps, tile_rows=tile_rows,
            emit_transitions=False)
        s = stats.tolist()
        episodes += s[0] + s[2]
        wins += s[1] + s[3]
        draws += s[4]
        if episodes >= min_episodes:
            break
    return wins, draws, episodes


def fused_win_rate(env_params: EnvParams, params_a: QNet, params_b: QNet,
                   generator: torch.Generator, min_episodes: int,
                   n_envs: int = 4096, chunk_steps: int = 256,
                   max_chunks: int = 32, tile_rows: int = 512,
                   device="cuda"):
    """B's win rate vs frozen A (``pallas_win_rate`` in the JAX package).
    Returns ``(win_rate_b, episodes_played)``."""
    wins, _, episodes = _stream_seat(
        env_params, params_b, params_a, generator, min_episodes, n_envs,
        chunk_steps, max_chunks, tile_rows, device)
    return (wins / episodes if episodes else 0.0), episodes


def fused_win_rate_balanced(env_params: EnvParams, params_a: QNet,
                            params_b: QNet, generator: torch.Generator,
                            min_episodes: int, n_envs: int = 4096,
                            chunk_steps: int = 256, max_chunks: int = 32,
                            tile_rows: int = 512, device="cuda"):
    """Side-balanced gate (``pallas_win_rate_balanced``): >= min/2
    episodes per seating; seat 2 puts A in the learner seat, so B's wins
    there are ``episodes - A wins - draws``. The two seats weigh equally.
    Returns ``(win_rate_total, win_rate_as_b, win_rate_as_a,
    episodes_total)``."""
    half = max(1, min_episodes // 2)
    wins_b, _, eps_b = _stream_seat(
        env_params, params_b, params_a, generator, half, n_envs,
        chunk_steps, max_chunks, tile_rows, device)
    wins_a_opp, draws_a, eps_a = _stream_seat(
        env_params, params_a, params_b, generator, half, n_envs,
        chunk_steps, max_chunks, tile_rows, device)
    rate_b = wins_b / max(eps_b, 1)
    rate_a = (eps_a - wins_a_opp - draws_a) / max(eps_a, 1)
    return (rate_b + rate_a) / 2, rate_b, rate_a, eps_b + eps_a
