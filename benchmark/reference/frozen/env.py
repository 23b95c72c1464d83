"""Frozen copy of ``pingpong_tpu_torch/env/pong.py`` (the env: serves, spin,
Magnus, collisions, speed-up), as the port had it when the benchmark was
written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .physics import collide_sphere_with_moving_plane


class EnvParams(NamedTuple):
    """Static per-run env parameters (float32-rounded Python scalars)."""

    paddle_width: float
    paddle_speed: float
    max_score: int
    enable_spin: float
    magnus_factor: float
    restitution: float
    friction: float
    ball_mass: float
    ball_radius: float
    speed_min: float
    speed_max: float
    spin_min: float
    spin_max: float
    angle_intervals: Tuple[Tuple[float, float], Tuple[float, float]]
    speed_scale_every: int
    speed_increment: float


class EnvState(NamedTuple):
    """Per-env dynamic state; every field has a leading batch axis."""

    ball_x: torch.Tensor
    ball_y: torch.Tensor
    ball_vx: torch.Tensor
    ball_vy: torch.Tensor
    spin: torch.Tensor
    top_paddle_x: torch.Tensor      # player A
    bottom_paddle_x: torch.Tensor   # player B
    score_a: torch.Tensor           # i32
    score_b: torch.Tensor           # i32
    bounce_count: torch.Tensor      # i32
    t: torch.Tensor                 # i32 steps since reset
    done: torch.Tensor              # bool


class StepOut(NamedTuple):
    obs_a: torch.Tensor
    obs_b: torch.Tensor
    reward_a: torch.Tensor
    reward_b: torch.Tensor
    done: torch.Tensor


def _f32(x) -> float:
    return float(np.float32(x))


def env_params_from_config(cfg: EnvConfig) -> EnvParams:
    iv = cfg.ball_angle_intervals
    return EnvParams(
        paddle_width=_f32(cfg.paddle_width),
        paddle_speed=_f32(cfg.paddle_speed),
        max_score=int(cfg.max_score),
        enable_spin=1.0 if cfg.enable_spin else 0.0,
        magnus_factor=_f32(cfg.magnus_factor),
        restitution=_f32(cfg.restitution),
        friction=_f32(cfg.friction),
        ball_mass=_f32(cfg.ball_mass),
        ball_radius=_f32(cfg.world_ball_radius),
        speed_min=_f32(cfg.ball_speed_range[0]),
        speed_max=_f32(cfg.ball_speed_range[1]),
        spin_min=_f32(cfg.spin_range[0]),
        spin_max=_f32(cfg.spin_range[1]),
        angle_intervals=((_f32(iv[0][0]), _f32(iv[0][1])),
                         (_f32(iv[1][0]), _f32(iv[1][1]))),
        speed_scale_every=int(cfg.speed_scale_every),
        speed_increment=_f32(cfg.speed_increment),
    )


# ---------------------------------------------------------------------------
# Serve / reset
# ---------------------------------------------------------------------------

def serve_from_uniforms(params: EnvParams, u_speed, u_pick, u_angle, u_spin):
    """Serve velocity and spin from four U[0,1) tensors: speed in
    ``[speed_min, speed_max)``, the second angle interval when
    ``u_pick >= 0.5``, spin in ``[spin_min, spin_max)``
    (``ops/pong_kernel.py::_serve_fields``)."""
    speed = params.speed_min + u_speed * (params.speed_max - params.speed_min)
    (lo0, hi0), (lo1, hi1) = params.angle_intervals
    ang = torch.where(u_pick >= 0.5, lo1 + u_angle * (hi1 - lo1),
                      lo0 + u_angle * (hi0 - lo0))
    ang = ang * (math.pi / 180.0)
    spin = params.spin_min + u_spin * (params.spin_max - params.spin_min)
    return speed * torch.cos(ang), speed * torch.sin(ang), spin


def reset(params: EnvParams, n: int, generator: torch.Generator,
          device="cpu") -> EnvState:
    """``n`` fresh episodes (ball centred, paddles centred, random serve).
    The uniforms come from ``generator`` on the CPU."""
    u = torch.rand((4, n), generator=generator, dtype=torch.float32)
    vx, vy, spin = serve_from_uniforms(params, u[0], u[1], u[2], u[3])
    half = torch.full((n,), 0.5, dtype=torch.float32)
    zi = torch.zeros((n,), dtype=torch.int32)
    state = EnvState(
        ball_x=half, ball_y=half.clone(), ball_vx=vx, ball_vy=vy, spin=spin,
        top_paddle_x=half.clone(), bottom_paddle_x=half.clone(),
        score_a=zi, score_b=zi.clone(), bounce_count=zi.clone(), t=zi.clone(),
        done=torch.zeros((n,), dtype=torch.bool),
    )
    return EnvState(*(x.to(device) for x in state))


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------

def observe_a(state: EnvState) -> torch.Tensor:
    """A's vertically mirrored view, ``(..., 7)``."""
    return torch.stack([
        state.ball_x, 1.0 - state.ball_y, state.ball_vx, -state.ball_vy,
        state.top_paddle_x, state.bottom_paddle_x, state.spin,
    ], dim=-1)


def observe_b(state: EnvState) -> torch.Tensor:
    """B's direct view, ``(..., 7)``."""
    return torch.stack([
        state.ball_x, state.ball_y, state.ball_vx, state.ball_vy,
        state.bottom_paddle_x, state.top_paddle_x, state.spin,
    ], dim=-1)


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def _paddle_velocity(action: torch.Tensor, paddle_speed: float):
    """Action {0, 1, 2} -> {-v, 0, +v}."""
    return (action.to(torch.float32) - 1.0) * paddle_speed


def step(params: EnvParams, state: EnvState, action_a: torch.Tensor,
         action_b: torch.Tensor) -> Tuple[EnvState, StepOut]:
    """One branchless env transition for the whole batch."""
    ps = params.paddle_speed
    u_a = _paddle_velocity(action_a, ps)
    u_b = _paddle_velocity(action_b, ps)
    top_x = torch.clamp(state.top_paddle_x + u_a, 0.0, 1.0)
    bot_x = torch.clamp(state.bottom_paddle_x + u_b, 0.0, 1.0)

    # Magnus + Euler integration
    vx = state.ball_vx + (params.enable_spin * params.magnus_factor
                          * state.spin * state.ball_vy)
    vy = state.ball_vy
    x = state.ball_x + vx
    y = state.ball_y + vy

    # side walls mirror the position
    hit_left = x < 0.0
    hit_right = x > 1.0
    x = torch.where(hit_left, -x, torch.where(hit_right, 2.0 - x, x))
    vx = torch.where(hit_left | hit_right, -vx, vx)

    half_w = params.paddle_width * 0.5
    phys = (params.restitution, params.friction, params.ball_mass,
            params.ball_radius)

    # top paddle line y < 0 (player A defends)
    cross_top = y < 0.0
    in_top = (top_x - half_w <= x) & (x <= top_x + half_w)
    hit_top = cross_top & in_top
    miss_top = cross_top & ~in_top
    vn_t, vt_t, om_t = collide_sphere_with_moving_plane(
        vy, vx, u_a, state.spin, *phys)

    # bottom paddle line y > 1 (player B defends)
    cross_bot = y > 1.0
    in_bot = (bot_x - half_w <= x) & (x <= bot_x + half_w)
    hit_bot = cross_bot & in_bot
    miss_bot = cross_bot & ~in_bot
    vn_b, vt_b, om_b = collide_sphere_with_moving_plane(
        -vy, vx, u_b, state.spin, *phys)

    hit_any = hit_top | hit_bot
    vy = torch.where(hit_top, vn_t, torch.where(hit_bot, -vn_b, vy))
    vx = torch.where(hit_top, vt_t, torch.where(hit_bot, vt_b, vx))
    spin = torch.where(hit_top, om_t, torch.where(hit_bot, om_b, state.spin))
    y = torch.where(hit_top, 0.0, torch.where(hit_bot, 1.0, y))

    # bounce counting + progressive speed-up
    bounce = state.bounce_count + hit_any.to(torch.int32)
    scale_now = hit_any & (bounce % params.speed_scale_every == 0)
    scale = torch.where(scale_now, 1.0 + params.speed_increment, 1.0)
    vx = vx * scale
    vy = vy * scale

    # scoring
    reward_b = miss_top.to(torch.float32) - miss_bot.to(torch.float32)
    score_a = state.score_a + miss_bot.to(torch.int32)
    score_b = state.score_b + miss_top.to(torch.int32)
    done = (score_a >= params.max_score) | (score_b >= params.max_score)

    new_state = EnvState(
        ball_x=x, ball_y=y, ball_vx=vx, ball_vy=vy, spin=spin,
        top_paddle_x=top_x, bottom_paddle_x=bot_x,
        score_a=score_a, score_b=score_b, bounce_count=bounce,
        t=state.t + 1, done=done,
    )
    out = StepOut(obs_a=observe_a(new_state), obs_b=observe_b(new_state),
                  reward_a=-reward_b, reward_b=reward_b, done=done)
    return new_state, out


def step_autoreset_batch(params: EnvParams, state: EnvState,
                         generator: torch.Generator, action_a: torch.Tensor,
                         action_b: torch.Tensor, max_episode_steps: int = 0,
                         u: Optional[torch.Tensor] = None
                         ) -> Tuple[EnvState, StepOut]:
    """Batched step with masked auto-reset. ``max_episode_steps > 0`` also
    ends (truncates) an episode at that many steps, with ``done`` set in
    the returned :class:`StepOut`, which carries the terminal observation
    and reward of the step. The returned state is re-served where an
    episode ended; the serves of the whole batch come from four ``(B,)``
    uniforms drawn from ``generator``, which lives on the state's device
    (``env/pong.py::step_autoreset_batch`` and ``_serve_batch`` of the JAX
    package, one key for the whole batch); ``u (4, B)`` on the state's
    device gives them instead."""
    new, out = step(params, state, action_a, action_b)
    ended = out.done
    if max_episode_steps:
        ended = ended | (new.t >= max_episode_steps)
        out = out._replace(done=ended)
    if u is None:
        u = torch.rand((4,) + tuple(state.ball_x.shape), generator=generator,
                       dtype=torch.float32, device=state.ball_x.device)
    svx, svy, sspin = serve_from_uniforms(params, u[0], u[1], u[2], u[3])
    zi = torch.zeros_like(new.t)
    nxt = EnvState(
        ball_x=torch.where(ended, 0.5, new.ball_x),
        ball_y=torch.where(ended, 0.5, new.ball_y),
        ball_vx=torch.where(ended, svx, new.ball_vx),
        ball_vy=torch.where(ended, svy, new.ball_vy),
        spin=torch.where(ended, sspin, new.spin),
        top_paddle_x=torch.where(ended, 0.5, new.top_paddle_x),
        bottom_paddle_x=torch.where(ended, 0.5, new.bottom_paddle_x),
        score_a=torch.where(ended, zi, new.score_a),
        score_b=torch.where(ended, zi, new.score_b),
        bounce_count=torch.where(ended, zi, new.bounce_count),
        t=torch.where(ended, zi, new.t),
        done=torch.zeros_like(ended),
    )
    return nxt, out
