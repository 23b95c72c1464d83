"""Live viewer: real-time play on the native C++ engine (port of
``pingpong_tpu/viewer/live.py``).

The replay viewer (``viewer/replay.py``) records whole episodes on the
device and plays them back; this mode instead runs the match LIVE — the
env steps in the C++ engine (``csrc/pong_engine.cpp``) and both policies
run as host numpy forwards (``viewer/host_policy.py``), so every frame is
computed on demand on the host, with no accelerator involved: that is the
JAX package's design, not a fallback. It is the analog of the reference
viewer's frame-by-frame loop (``tests/test_viewer_v2.py:134-187`` of the
reference), which steps env and models inside the UI loop.

``run_live`` drives a generator of frames so it is testable headless;
``play_live`` wraps it in the interactive pygame window (same controls as
the replay player: SPACE pause, +/- and slider for speed, Q/ESC quit).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from pingpong_tpu_torch.config.schema import EnvConfig
from pingpong_tpu_torch.native.engine import NativeEngine, SoAState
from pingpong_tpu_torch.viewer.host_policy import (
    host_policy,
    observe_pair,
    serve,
)
from pingpong_tpu_torch.viewer.render import FrameRenderer


class LiveTrajectory:
    """Append-only trajectory view over the live match; duck-types the
    fields :class:`FrameRenderer` reads (list indexing suffices)."""

    FIELDS = (
        "ball_x", "ball_y", "ball_vx", "ball_vy", "spin",
        "top_paddle_x", "bottom_paddle_x", "score_a", "score_b",
    )

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, [])

    def append(self, s: SoAState) -> None:
        self.ball_x.append(float(s.ball_x[0]))
        self.ball_y.append(float(s.ball_y[0]))
        self.ball_vx.append(float(s.ball_vx[0]))
        self.ball_vy.append(float(s.ball_vy[0]))
        self.spin.append(float(s.spin[0]))
        self.top_paddle_x.append(float(s.top_x[0]))
        self.bottom_paddle_x.append(float(s.bottom_x[0]))
        self.score_a.append(int(s.score_a[0]))
        self.score_b.append(int(s.score_b[0]))

    @property
    def length(self) -> int:
        return len(self.ball_x)


def _reset_state(state: SoAState, rng: np.random.Generator, env_cfg) -> None:
    vx, vy, spin = serve(rng, env_cfg)
    state.ball_x[0] = 0.5
    state.ball_y[0] = 0.5
    state.ball_vx[0] = vx
    state.ball_vy[0] = vy
    state.spin[0] = spin
    state.top_x[0] = 0.5
    state.bottom_x[0] = 0.5
    state.score_a[0] = 0
    state.score_b[0] = 0
    state.bounce[0] = 0
    state.t[0] = 0


def run_live(
    env_cfg: EnvConfig,
    params_a,
    params_b,
    episodes: int = 1,
    seed: int = 0,
    max_steps: int = 5000,
    size: int = 400,
    bot_tolerance: float = 0.02,
) -> Iterator[np.ndarray]:
    """Yield rendered RGB frames of live episodes (headless-testable)."""
    engine = NativeEngine(env_cfg)
    rng = np.random.default_rng(seed)
    pol_a = host_policy(params_a, bot_tolerance)
    pol_b = host_policy(params_b, bot_tolerance)
    renderer = FrameRenderer()
    for _ in range(episodes):
        state = SoAState.zeros(1)
        _reset_state(state, rng, env_cfg)
        if hasattr(pol_a, "reset"):
            pol_a.reset()
        if hasattr(pol_b, "reset"):
            pol_b.reset()
        traj = LiveTrajectory()
        traj.append(state)
        for _t in range(max_steps):
            obs_a, obs_b = observe_pair(state)
            act_a = np.array([pol_a.act(obs_a)], np.int32)
            act_b = np.array([pol_b.act(obs_b)], np.int32)
            _, done = engine.step(state, act_a, act_b)
            traj.append(state)
            yield renderer.render_frame(
                traj, traj.length - 1, env_cfg.paddle_width, size
            )
            if bool(done[0]):
                break


def play_live(
    env_cfg: EnvConfig,
    params_a,
    params_b,
    episodes: int = 1,
    seed: int = 0,
    size: int = 400,
    fps: int = 60,
    max_steps: int = 5000,
) -> None:
    """Interactive pygame window over :func:`run_live` frames."""
    import pygame

    from pingpong_tpu_torch.viewer.pygame_ui import SLIDER_H, SpeedSlider

    pygame.init()
    screen = pygame.display.set_mode((size, size + SLIDER_H))
    pygame.display.set_caption("pingpong_tpu live (C++ engine)")
    font = pygame.font.SysFont(None, 18)
    clock = pygame.time.Clock()
    slider = SpeedSlider(x=60, y=size + SLIDER_H // 2, w=size - 120)
    paused = False
    frames = run_live(env_cfg, params_a, params_b, episodes=episodes,
                      seed=seed, max_steps=max_steps, size=size)
    frame: Optional[np.ndarray] = None
    try:
        while True:
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    return
                slider.handle_event(event)
                if event.type == pygame.KEYDOWN:
                    if event.key in (pygame.K_q, pygame.K_ESCAPE):
                        return
                    if event.key == pygame.K_SPACE:
                        paused = not paused
                    if event.key in (pygame.K_PLUS, pygame.K_EQUALS,
                                     pygame.K_UP):
                        slider.value = min(5.0, slider.value + 0.1)
                    if event.key in (pygame.K_MINUS, pygame.K_DOWN):
                        slider.value = max(0.1, slider.value - 0.1)
            if not paused:
                try:
                    frame = next(frames)
                except StopIteration:
                    return
            if frame is not None:
                surf = pygame.surfarray.make_surface(
                    np.transpose(frame, (1, 0, 2))
                )
                screen.fill((18, 20, 32))
                screen.blit(surf, (0, 0))
            slider.draw(screen)
            label = font.render(f"{slider.value:.1f}x  [live/C++]", True,
                                (220, 220, 230))
            screen.blit(label, (10, size + SLIDER_H // 2 - 8))
            pygame.display.flip()
            clock.tick(max(1, int(fps * slider.value)))
    finally:
        pygame.quit()
