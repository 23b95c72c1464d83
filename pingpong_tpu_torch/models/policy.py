"""Batched action selection (port of ``pingpong_tpu/models/policy.py``):
``obs (B, 7) -> actions (B,)``; the recurrent policies also carry their
hidden state."""

from __future__ import annotations

import torch

from pingpong_tpu_torch.models.qnet import (
    QNet,
    argmax3,
    qnet_apply,
    qnet_sample_noise,
)
from pingpong_tpu_torch.models.qnet_rnn import Hidden, QNetRNN, qnet_rnn_step
from pingpong_tpu_torch.ops.pong_kernel import bot_actions


def epsilon_greedy(generator, q_values, epsilon: float, n_actions: int = 3):
    """Per-row epsilon-greedy over ``(B, n_actions)`` Q-values; the
    uniforms come from ``generator`` on the CPU."""
    batch = q_values.shape[:-1]
    explore = torch.rand(batch, generator=generator) < epsilon
    random_a = torch.randint(0, n_actions, batch, generator=generator,
                             dtype=torch.int32)
    greedy_a = argmax3(q_values)
    dev = q_values.device
    return torch.where(explore.to(dev), random_a.to(dev), greedy_a)


def qnet_act_train(generator, params: QNet, obs, epsilon: float):
    """Learner actor: a fresh head-noise draw, then epsilon-greedy."""
    noise = qnet_sample_noise(generator, params)
    return epsilon_greedy(generator, qnet_apply(params, obs, noise), epsilon)


def qnet_act_greedy(params: QNet, obs):
    """Eval mode: mu weights, no epsilon."""
    return argmax3(qnet_apply(params, obs))


def rnn_act_greedy(params: QNetRNN, obs, hidden: Hidden):
    """Eval-mode recurrent step: mu weights, no epsilon. Returns
    ``(actions, next hidden)``."""
    q, new_hidden = qnet_rnn_step(params, obs, hidden)
    return argmax3(q), new_hidden


def ball_follower_action(obs, tolerance: float = 0.02):
    """The hardcoded ball-follower bot on a player's observation: left (0)
    if ``ball_x < my_paddle_x - tol``, right (2) if ``ball_x > my_paddle_x
    + tol``, else stay (1); ``obs[..., 0]`` is ball_x, ``obs[..., 4]`` the
    player's own paddle."""
    return bot_actions(obs[..., 0], obs[..., 4], tolerance)
