"""In-env debug renderer — live view of any (batched) EnvState (port of
``pingpong_tpu/env/debug_render.py``).

Parity with the reference env's built-in debug ``render()``
(``envs/my_pong_env_2p.py:265-306`` of the reference): the reference can
open a pygame window during ANY env use and draw the current state at 60
FPS. The port's env is a set of batched tensor functions, so the
equivalent is a host-side adapter: call :meth:`DebugRenderer.render` with
an :class:`~pingpong_tpu_torch.env.pong.EnvState` on any device (batched
or not — pick one env with ``index``) anywhere in a host loop and it
draws that state. Only the one env drawn is copied to the host, in one
transfer. The RGB frame is always returned, so tests and notebooks can
consume frames without a display; a pygame window opens as well when a
display exists. Drawing itself reuses the viewer's
:class:`~pingpong_tpu_torch.viewer.render.FrameRenderer` (grid, trail,
spin cross, score line), which is a superset of the reference's debug
view.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from pingpong_tpu_torch.viewer.record import Trajectory
from pingpong_tpu_torch.viewer.render import FrameRenderer

TRAIL = 18   # frames of ball trail kept for the debug view
_FIELDS = ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin", "top_paddle_x",
           "bottom_paddle_x", "score_a", "score_b")


def has_display() -> bool:
    """A window can open: always off Linux, else when X or Wayland is
    there."""
    return sys.platform != "linux" or bool(
        os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


class DebugRenderer:
    def __init__(self, paddle_width: float, size: int = 400,
                 fps: int = 60, window: bool = True):
        self.paddle_width = float(paddle_width)
        self.size = int(size)
        self.fps = int(fps)
        self._renderer = FrameRenderer()
        self._hist: list = []
        self._screen = None
        self._clock = None
        self._want_window = window and has_display()

    def render(self, state, index: int = 0) -> np.ndarray:
        """Draw env ``index`` of ``state``; returns the RGB frame
        (H, W, 3). Opens/updates a pygame window when a display exists."""
        row = torch.stack([
            getattr(state, n).reshape(-1)[index].to(torch.float32)
            for n in _FIELDS]).cpu().numpy()
        self._hist.append(row)
        if len(self._hist) > TRAIL + 1:
            self._hist.pop(0)
        h = np.stack(self._hist)
        t = len(self._hist) - 1
        traj = Trajectory(
            ball_x=h[:, 0], ball_y=h[:, 1], ball_vx=h[:, 2],
            ball_vy=h[:, 3], spin=h[:, 4], top_paddle_x=h[:, 5],
            bottom_paddle_x=h[:, 6], score_a=h[:, 7], score_b=h[:, 8],
            action_a=np.zeros(t + 1, np.int32),
            action_b=np.zeros(t + 1, np.int32),
            done=np.zeros(t + 1, bool),
            length=t + 1,
        )
        frame = self._renderer.render_frame(
            traj, t, self.paddle_width, size=self.size
        )
        if self._want_window:
            self._blit(frame)
        return frame

    def _blit(self, frame: np.ndarray) -> None:
        try:
            import pygame
        except ImportError:
            self._want_window = False
            return
        try:
            if self._screen is None:
                pygame.init()
                self._screen = pygame.display.set_mode(
                    (self.size, self.size)
                )
                pygame.display.set_caption("pingpong_tpu_torch debug")
                self._clock = pygame.time.Clock()
            pygame.event.pump()
            surf = pygame.surfarray.make_surface(frame.swapaxes(0, 1))
            self._screen.blit(surf, (0, 0))
            pygame.display.flip()
            self._clock.tick(self.fps)   # ref caps at 60 FPS (:269)
        except pygame.error:
            # the display refused the window: stay in array-only mode
            self._want_window = False

    def close(self) -> None:
        if self._screen is not None:
            import pygame

            pygame.quit()
            self._screen = None
