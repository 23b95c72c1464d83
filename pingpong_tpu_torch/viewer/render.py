"""Viewer rendering backends (port of ``pingpong_tpu/viewer/render.py``;
the drawing code is the same, so a trajectory renders to the same pixels
in both packages).

Keeps the reference viewer package's key design idea — an abstract
renderer with swappable backends
(``tests/pingpong_viewer/rendering/renderer.py:9-68`` of the reference) —
with two implementations:

* :class:`FrameRenderer` — headless RGB frames (PIL drawing) with the
  reference monolith's visual vocabulary (``test_viewer.py:186-492``):
  grid background, paddles, ball with a fading trail, rotating spin cross,
  score/speed/spin info line;
* the interactive pygame window (``pygame_ui.py``), with pause and speed
  control, which shows :class:`FrameRenderer` frames.
"""

from __future__ import annotations

import abc
import math
from pathlib import Path
from typing import Optional

import numpy as np

from pingpong_tpu_torch.viewer.record import Trajectory

# visual constants (analog of pingpong_viewer/config/constants.py)
BG = (12, 14, 24)
GRID = (30, 34, 52)
BALL = (255, 255, 255)
TRAIL = (90, 140, 255)
PADDLE_A = (80, 220, 120)
PADDLE_B = (255, 170, 60)
SPIN_CROSS = (255, 80, 80)
TEXT = (210, 210, 220)
PADDLE_PX_H = 10
BALL_PX_R = 8
TRAIL_LEN = 18
GRID_STEP = 50


class Renderer(abc.ABC):
    """Swappable rendering backend (ref renderer.py:9-68)."""

    @abc.abstractmethod
    def render_frame(self, traj: Trajectory, t: int, paddle_width: float,
                     size: int) -> Optional[np.ndarray]:
        ...


class Effect:
    """Base effect: position + remaining lifetime (analog of the
    reference's pingpong_viewer/rendering/effects.py:10-25)."""

    def __init__(self, x: float, y: float, lifetime: int):
        self.x = x
        self.y = y
        self.age = 0
        self.lifetime = lifetime

    def update(self) -> None:
        self.age += 1

    @property
    def alive(self) -> bool:
        return self.age <= self.lifetime

    @property
    def fade(self) -> float:
        return max(0.0, 1.0 - self.age / max(self.lifetime, 1))


class CollisionEffect(Effect):
    """Expanding-ring flash on paddle impacts (ref effects.py:27-52)."""

    def __init__(self, x: float, y: float):
        super().__init__(x, y, lifetime=8)

    def draw(self, d) -> None:
        r = 10 + self.age * 3
        c = int(255 * self.fade)
        d.ellipse([self.x - r, self.y - r, self.x + r, self.y + r],
                  outline=(c, c, 80), width=2)


class ParticleEffect(Effect):
    """A spark flying off an impact point with simple ballistic motion
    (ref effects.py:54-70)."""

    def __init__(self, x: float, y: float, vx: float, vy: float):
        super().__init__(x, y, lifetime=14)
        self.vx = vx
        self.vy = vy

    def update(self) -> None:
        super().update()
        self.x += self.vx
        self.y += self.vy
        self.vy += 0.35          # gravity-ish pull, like the reference
        self.vx *= 0.96

    def draw(self, d) -> None:
        r = max(1, int(3 * self.fade))
        c = (int(255 * self.fade), int(200 * self.fade), int(90 * self.fade))
        d.ellipse([self.x - r, self.y - r, self.x + r, self.y + r], fill=c)


class EffectManager:
    """Owns all live effects; spawns a ring + a deterministic particle
    burst per paddle impact (ref effects.py:72-118). An impact is detected
    when the ball is snapped exactly onto a paddle line (env/pong.py sets
    y to 0.0 / 1.0 on a hit)."""

    N_PARTICLES = 10

    def __init__(self):
        self.effects = []

    def add_collision(self, x: float, y: float) -> None:
        self.effects.append(CollisionEffect(x, y))
        # deterministic burst (no RNG state: angle from particle index,
        # speed jitter from the impact position)
        down = 1.0 if y < 1 else -1.0
        for i in range(self.N_PARTICLES):
            a = math.pi * (0.15 + 0.7 * i / (self.N_PARTICLES - 1))
            speed = 2.0 + 2.5 * (((x * 7919) % 97) / 97.0 + i % 3) / 3.0
            self.effects.append(ParticleEffect(
                x, y, speed * math.cos(a), down * speed * math.sin(a)
            ))

    def update(self, traj: Trajectory, t: int, size: int) -> None:
        y = float(traj.ball_y[t])
        if y == 0.0 or y == 1.0:
            self.add_collision(float(traj.ball_x[t]) * size, y * size)
        for e in self.effects:
            e.update()
        self.effects = [e for e in self.effects if e.alive]

    def draw(self, d) -> None:
        for e in self.effects:
            e.draw(d)

    @property
    def active_count(self) -> int:
        return len(self.effects)


def make_ball_sprite(radius: int = BALL_PX_R):
    """Procedurally drawn rotatable ball sprite (the reference rotates an
    image asset by the accumulated spin angle, test_viewer.py:282-293 /
    assets/sunglasses.png; we draw our own two-tone ball so the rotation
    reads visually without shipping binary assets)."""
    from PIL import Image, ImageDraw

    s = radius * 2 + 2
    img = Image.new("RGBA", (s, s), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    c = s // 2
    d.ellipse([c - radius, c - radius, c + radius, c + radius],
              fill=(245, 245, 245, 255))
    # two opposing colored wedges make the rotation visible
    d.pieslice([c - radius, c - radius, c + radius, c + radius],
               start=-30, end=30, fill=(255, 120, 60, 255))
    d.pieslice([c - radius, c - radius, c + radius, c + radius],
               start=150, end=210, fill=(80, 150, 255, 255))
    d.ellipse([c - 2, c - 2, c + 2, c + 2], fill=(20, 20, 30, 255))
    return img


class FrameRenderer(Renderer):
    """Headless RGB frame rendering via PIL."""

    def __init__(self, ball_sprite: bool = True):
        from PIL import Image, ImageDraw  # noqa: F401  (import check)

        self.spin_angle = 0.0
        self.effects = EffectManager()
        self.sprite = make_ball_sprite() if ball_sprite else None

    def render_frame(self, traj, t, paddle_width, size=400):
        from PIL import Image, ImageDraw

        img = Image.new("RGB", (size, size), BG)
        d = ImageDraw.Draw(img)
        for g in range(0, size, GRID_STEP):
            d.line([(g, 0), (g, size)], fill=GRID)
            d.line([(0, g), (size, g)], fill=GRID)

        # trail
        t0 = max(0, t - TRAIL_LEN)
        for i, tt in enumerate(range(t0, t)):
            frac = (i + 1) / max(t - t0, 1)
            x = int(traj.ball_x[tt] * size)
            y = int(traj.ball_y[tt] * size)
            r = max(1, int(BALL_PX_R * frac * 0.7))
            col = tuple(int(c * frac * 0.6) for c in TRAIL)
            d.ellipse([x - r, y - r, x + r, y + r], fill=col)

        bx = int(traj.ball_x[t] * size)
        by = int(traj.ball_y[t] * size)
        # accumulated spin angle drives the ball rotation (ref
        # test_viewer.py:282-293 rotates the ball image the same way)
        self.spin_angle += float(traj.spin[t])
        if self.sprite is not None:
            rot = self.sprite.rotate(-self.spin_angle, resample=0)
            img.paste(rot, (bx - rot.width // 2, by - rot.height // 2), rot)
        else:
            d.ellipse(
                [bx - BALL_PX_R, by - BALL_PX_R,
                 bx + BALL_PX_R, by + BALL_PX_R],
                fill=BALL,
            )
            # rotating spin cross (ref my_pong_env_2p.py:281-294 / viewer)
            rc = BALL_PX_R - 2
            for off in (0.0, 90.0):
                a = math.radians(self.spin_angle + off)
                d.line(
                    [
                        (bx + rc * math.cos(a), by + rc * math.sin(a)),
                        (bx - rc * math.cos(a), by - rc * math.sin(a)),
                    ],
                    fill=SPIN_CROSS,
                    width=2,
                )

        self.effects.update(traj, t, size)
        self.effects.draw(d)

        pw = int(paddle_width * size)
        tx = int(traj.top_paddle_x[t] * size)
        d.rectangle([tx - pw // 2, 0, tx + pw // 2, PADDLE_PX_H], fill=PADDLE_A)
        bx2 = int(traj.bottom_paddle_x[t] * size)
        d.rectangle(
            [bx2 - pw // 2, size - PADDLE_PX_H, bx2 + pw // 2, size],
            fill=PADDLE_B,
        )

        speed = math.hypot(float(traj.ball_vx[t]), float(traj.ball_vy[t]))
        d.text(
            (6, size // 2 - 8),
            f"A {int(traj.score_a[t])} : {int(traj.score_b[t])} B   "
            f"v={speed:.3f}  spin={float(traj.spin[t]):+.2f}  t={t}",
            fill=TEXT,
        )
        return np.asarray(img)


def render_gif(
    traj: Trajectory, out_path, paddle_width: float, size: int = 400,
    fps: int = 60, every: int = 1,
) -> str:
    """Render a trajectory to an animated GIF."""
    from PIL import Image

    r = FrameRenderer()
    frames = [
        Image.fromarray(r.render_frame(traj, t, paddle_width, size))
        for t in range(0, traj.length, every)
    ]
    out_path = str(out_path)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    frames[0].save(
        out_path,
        save_all=True,
        append_images=frames[1:],
        duration=max(1000 // fps, 10) * every,
        loop=0,
    )
    return out_path
