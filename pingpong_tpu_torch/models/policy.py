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
from pingpong_tpu_torch.models.qnet_rnn import (
    Hidden,
    QNetRNN,
    qnet_rnn_sample_noise,
    qnet_rnn_step,
)
from pingpong_tpu_torch.ops.pong_kernel import bot_actions


def epsilon_greedy(generator, q_values, epsilon, n_actions: int = 3,
                   draws=None):
    """Per-row epsilon-greedy over ``(B, n_actions)`` Q-values: explore
    where a uniform is below ``epsilon`` (a float, or a tensor on the
    Q-values' device). The uniforms and random actions come from
    ``generator`` on the CPU, or ``draws = (uniforms, actions)`` gives
    them."""
    dev = q_values.device
    if draws is None:
        batch = q_values.shape[:-1]
        draws = (torch.rand(batch, generator=generator),
                 torch.randint(0, n_actions, batch, generator=generator,
                               dtype=torch.int32))
    u, random_a = (x.to(dev) for x in draws)
    return torch.where(u < epsilon, random_a, argmax3(q_values))


def qnet_act_train(generator, params: QNet, obs, epsilon: float):
    """Learner actor: a fresh head-noise draw, then epsilon-greedy."""
    noise = qnet_sample_noise(generator, params)
    return epsilon_greedy(generator, qnet_apply(params, obs, noise), epsilon)


def qnet_act_greedy(params: QNet, obs):
    """Eval mode: mu weights, no epsilon."""
    return argmax3(qnet_apply(params, obs))


def rnn_act_train(generator, params: QNetRNN, obs, hidden: Hidden,
                  epsilon: float):
    """Learner RNN step: a fresh noise draw, then epsilon-greedy; the
    hidden state advances on explore steps too. Returns ``(actions, next
    hidden)``."""
    noise = qnet_rnn_sample_noise(generator, params)
    q, new_hidden = qnet_rnn_step(params, obs, hidden, noise)
    return epsilon_greedy(generator, q, epsilon), new_hidden


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
