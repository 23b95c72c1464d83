"""Batched policy-vs-policy matches (port of
``pingpong_tpu/evaluation/match.py``).

N games run in lockstep: each step advances every unfinished game and
finished games freeze. The JAX package runs the loop as one
``lax.while_loop`` on the device; here it is a loop of torch ops over all
games at once, plain PyTorch as the JAX version is plain XLA (no Pallas
kernel). Its stop test (every game finished) is a host sync, so it runs
every ``check_every`` steps; finished games are frozen, so the results do
not depend on it, and the loop never steps past ``max_steps``.

Win rules are the JAX package's: the winner of a game is the side whose
score reached ``max_score`` (``reward_b > reward_a`` on the final step);
a game still running at ``max_steps`` is decided by score (equal scores
are a draw) and counts ``steps = max_steps``.

Policies are eval-mode (mu weights, no exploration). A side is a QNet
stack, a QNetRNN stack (hidden state carried across steps), a Rainbow
stack (greedy on the expected value of its distribution) or the
ball-follower bot; each game indexes its side's stack (``idx``), so one
batch holds games against many opponents. The serves of the games' first
resets come from a ``torch.Generator`` (``env/pong.py::reset``), or the
caller passes the initial states.
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Tuple

import torch

from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    observe_a,
    observe_b,
    reset,
    step,
)
from pingpong_tpu_torch.models.policy import ball_follower_action
from pingpong_tpu_torch.models.qnet import argmax3, qnet_apply
from pingpong_tpu_torch.models.qnet_rnn import Hidden, init_hidden, qnet_rnn_step
from pingpong_tpu_torch.models.rainbow import rainbow_q
from pingpong_tpu_torch.utils.device import resolve_device

# policy kinds
QNET = 0
RNN = 1
BOT = 2
RAINBOW = 3


class PolicySpec(NamedTuple):
    """A batched side: ``kind``, and ``params`` a list of nets (the stack
    slots) or None for the bot; per-game ``idx`` selects the slot."""

    kind: int
    params: Optional[List]


class MatchResult(NamedTuple):
    score_a: torch.Tensor    # (N,) i32
    score_b: torch.Tensor    # (N,) i32
    win_a: torch.Tensor      # (N,) bool
    win_b: torch.Tensor      # (N,) bool
    draw: torch.Tensor       # (N,) bool
    steps: torch.Tensor      # (N,) i32


def _on(nets, device):
    """The stack's nets on ``device`` (copies where they live elsewhere;
    ``Module.to`` would move the caller's nets)."""
    out = []
    for p in nets:
        if next(p.parameters()).device != device:
            p = copy.deepcopy(p).to(device)
        out.append(p)
    return out


def _pick(per_slot: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``per_slot (K, N, ...)`` -> each game's slot, ``(N, ...)``."""
    if per_slot.shape[0] == 1:
        return per_slot[0]
    return per_slot[idx, torch.arange(idx.shape[0], device=idx.device)]


def _policy_actions(spec: PolicySpec, idx, obs, hidden: Optional[Hidden],
                    tol: float):
    """Greedy eval actions for one side. Returns (actions, next hidden)."""
    if spec.kind == BOT:
        return ball_follower_action(obs, tolerance=tol), hidden
    if spec.kind == QNET:
        acts = torch.stack([argmax3(qnet_apply(p, obs)) for p in spec.params])
        return _pick(acts, idx), hidden
    if spec.kind == RNN:
        outs = [qnet_rnn_step(p, obs, hidden) for p in spec.params]
        acts = torch.stack([argmax3(q) for q, _ in outs])
        # (K, L, N, H) -> (K, N, L, H) for the per-game gather
        h = torch.stack([hid.h for _, hid in outs]).transpose(1, 2)
        c = torch.stack([hid.c for _, hid in outs]).transpose(1, 2)
        return _pick(acts, idx), Hidden(h=_pick(h, idx).transpose(0, 1),
                                        c=_pick(c, idx).transpose(0, 1))
    if spec.kind == RAINBOW:
        acts = torch.stack([argmax3(rainbow_q(p, obs)) for p in spec.params])
        return _pick(acts, idx), hidden
    raise ValueError(f"unknown policy kind {spec.kind}")


def make_match_fn(env_params: EnvParams, spec_a: PolicySpec,
                  spec_b: PolicySpec, max_steps: int = 20_000,
                  bot_tolerance: float = 0.01, check_every: int = 16,
                  device="cuda"):
    """Build ``run(params_a, params_b, idx_a, idx_b, generator=None,
    env_state=None) -> MatchResult``: ``len(idx_a)`` games, the first
    resets drawn from ``generator`` unless ``env_state`` gives them.
    ``spec_*`` fix the policy kinds; their params are ignored."""
    dev = resolve_device(device)
    kind_a, kind_b = spec_a.kind, spec_b.kind

    def run(params_a, params_b, idx_a, idx_b, generator=None,
            env_state: Optional[EnvState] = None) -> MatchResult:
        n = int(idx_a.shape[0])
        if env_state is None:
            env_state = reset(env_params, n, generator, dev)
        state = EnvState(*(x.to(dev) for x in env_state))
        sa = PolicySpec(kind_a, None if params_a is None
                        else _on(params_a, dev))
        sb = PolicySpec(kind_b, None if params_b is None
                        else _on(params_b, dev))
        ia = idx_a.to(dev, torch.int64)
        ib = idx_b.to(dev, torch.int64)
        hid_a = init_hidden(sa.params[0], (n,), dev) if kind_a == RNN else None
        hid_b = init_hidden(sb.params[0], (n,), dev) if kind_b == RNN else None
        fin = torch.zeros((n,), dtype=torch.bool, device=dev)
        win_a = torch.zeros_like(fin)
        win_b = torch.zeros_like(fin)
        end_steps = torch.zeros((n,), dtype=torch.int32, device=dev)
        t = 0
        while n and t < max_steps:
            act_a, ha = _policy_actions(sa, ia, observe_a(state), hid_a,
                                        bot_tolerance)
            act_b, hb = _policy_actions(sb, ib, observe_b(state), hid_b,
                                        bot_tolerance)
            new_state, out = step(env_params, state, act_a, act_b)
            just_done = out.done & ~fin
            win_a = win_a | (just_done & (out.reward_a > out.reward_b))
            win_b = win_b | (just_done & (out.reward_b > out.reward_a))
            end_steps = torch.where(just_done, t + 1, end_steps)
            # freeze finished games
            state = EnvState(*(torch.where(fin, old, new)
                               for new, old in zip(new_state, state)))
            mask = fin[None, :, None]
            if hid_a is not None:
                hid_a = Hidden(h=torch.where(mask, hid_a.h, ha.h),
                               c=torch.where(mask, hid_a.c, ha.c))
            if hid_b is not None:
                hid_b = Hidden(h=torch.where(mask, hid_b.h, hb.h),
                               c=torch.where(mask, hid_b.c, hb.c))
            fin = fin | out.done
            t += 1
            if t % check_every == 0 and bool(fin.all()):
                break
        # unfinished games: decided by score (a draw if equal)
        unfinished = ~fin
        win_a = win_a | (unfinished & (state.score_a > state.score_b))
        win_b = win_b | (unfinished & (state.score_b > state.score_a))
        end_steps = torch.where(unfinished, t, end_steps)
        return MatchResult(score_a=state.score_a, score_b=state.score_b,
                           win_a=win_a, win_b=win_b, draw=~(win_a | win_b),
                           steps=end_steps)

    return run


def eval_win_rate(match_fn, params_a_stack, params_b_stack, idx_a, idx_b,
                  generator: torch.Generator,
                  n_games: int) -> Tuple[float, MatchResult]:
    """Play ``n_games`` and return B's win rate (wins / episodes) and the
    result."""
    result = match_fn(params_a_stack, params_b_stack, idx_a[:n_games],
                      idx_b[:n_games], generator=generator)
    return float(result.win_b.to(torch.float32).mean()), result


def eval_win_rate_balanced(match_fn, opp_stack, learner_stack, idx_opp,
                           idx_learner, generator: torch.Generator,
                           n_games: int) -> Tuple[float, float, float]:
    """Side-balanced gate: ``n_games // 2`` games seat the learner as B
    (bottom), the rest as A (top), the first ``n`` entries of each index
    array per seating; a win counts from the learner's side either way.
    Needs a ``match_fn`` of one policy kind on both seats. Returns
    ``(win_rate_total, win_rate_as_b, win_rate_as_a)``."""
    n_b = n_games // 2
    n_a = n_games - n_b
    res_b = match_fn(opp_stack, learner_stack, idx_opp[:n_b],
                     idx_learner[:n_b], generator=generator)
    res_a = match_fn(learner_stack, opp_stack, idx_learner[:n_a],
                     idx_opp[:n_a], generator=generator)
    wins_as_b = float(res_b.win_b.to(torch.float32).sum())
    wins_as_a = float(res_a.win_a.to(torch.float32).sum())
    return ((wins_as_b + wins_as_a) / n_games, wins_as_b / max(n_b, 1),
            wins_as_a / max(n_a, 1))
