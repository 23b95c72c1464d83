"""Interactive pygame playback of recorded trajectories (port of
``pingpong_tpu/viewer/pygame_ui.py``).

Interactive-feature parity with the reference viewer
(``tests/test_viewer.py:496-678`` / ``test_viewer_v2.py:189-278`` /
``pingpong_viewer/rendering/pygame_renderer.py:13-253`` of the
reference): SPACE pauses, +/- (and the arrow keys)
scale playback speed, Q/ESC quits, a DRAGGABLE speed slider
(0.1x-5.0x FPS multiplier, ref test_viewer.py:415-460) sits under the
arena, and a winner banner shows at episode end. Rendering reuses
:class:`FrameRenderer` frames, so visuals are identical to the headless
GIF path. Import is deferred so headless machines never touch pygame.
"""

from __future__ import annotations

from typing import List

from pingpong_tpu_torch.viewer.record import Trajectory
from pingpong_tpu_torch.viewer.render import FrameRenderer

SPEED_MIN, SPEED_MAX = 0.1, 5.0
SLIDER_H = 36            # extra window strip under the arena


class SpeedSlider:
    """Draggable horizontal slider mapping track position to a playback
    speed factor (ref pygame_renderer.py slider + test_viewer.py:415-460)."""

    def __init__(self, x: int, y: int, w: int, value: float = 1.0):
        self.x, self.y, self.w = x, y, w
        self.value = value
        self.dragging = False

    def _value_from_px(self, px: int) -> float:
        frac = min(1.0, max(0.0, (px - self.x) / self.w))
        return SPEED_MIN + frac * (SPEED_MAX - SPEED_MIN)

    def handle_px(self) -> int:
        frac = (self.value - SPEED_MIN) / (SPEED_MAX - SPEED_MIN)
        return int(self.x + frac * self.w)

    def handle_event(self, event) -> None:
        import pygame

        if event.type == pygame.MOUSEBUTTONDOWN and event.button == 1:
            hx = self.handle_px()
            mx, my = event.pos
            if abs(my - self.y) <= 10 and self.x - 8 <= mx <= self.x + self.w + 8:
                self.dragging = True
                self.value = self._value_from_px(mx)
        elif event.type == pygame.MOUSEMOTION and self.dragging:
            self.value = self._value_from_px(event.pos[0])
        elif event.type == pygame.MOUSEBUTTONUP and event.button == 1:
            self.dragging = False

    def draw(self, screen) -> None:
        import pygame

        pygame.draw.line(screen, (90, 95, 120),
                         (self.x, self.y), (self.x + self.w, self.y), 3)
        hx = self.handle_px()
        pygame.draw.circle(screen, (240, 200, 90), (hx, self.y), 7)


def play_interactive(
    trajectories: List[Trajectory],
    paddle_width: float,
    size: int = 400,
    fps: int = 60,
) -> None:
    import numpy as np
    import pygame

    pygame.init()
    screen = pygame.display.set_mode((size, size + SLIDER_H))
    pygame.display.set_caption("pingpong_tpu viewer")
    font = pygame.font.SysFont(None, 18)
    clock = pygame.time.Clock()
    renderer = FrameRenderer()
    slider = SpeedSlider(x=60, y=size + SLIDER_H // 2, w=size - 120)
    paused = False

    try:
        for traj in trajectories:
            t = 0
            while t < traj.length:
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
                            slider.value = min(SPEED_MAX, slider.value + 0.1)
                        if event.key in (pygame.K_MINUS, pygame.K_DOWN):
                            slider.value = max(SPEED_MIN, slider.value - 0.1)
                if not paused:
                    frame = renderer.render_frame(traj, t, paddle_width, size)
                    surf = pygame.surfarray.make_surface(
                        np.transpose(frame, (1, 0, 2))
                    )
                    screen.fill((18, 20, 32))
                    screen.blit(surf, (0, 0))
                    t += 1
                slider.draw(screen)
                label = font.render(f"{slider.value:.1f}x", True,
                                    (220, 220, 230))
                screen.blit(label, (10, size + SLIDER_H // 2 - 8))
                pygame.display.flip()
                clock.tick(max(1, int(fps * slider.value)))
            # winner banner + short hold (ref shows banner then waits 2s)
            a, b = int(traj.score_a[-1]), int(traj.score_b[-1])
            winner = "A wins" if a > b else ("B wins" if b > a else "draw")
            pygame.display.set_caption(f"pingpong_tpu viewer — {winner} {a}:{b}")
            pygame.time.wait(1500)
    finally:
        pygame.quit()
