"""Viewer entry: record episodes on the device, replay them as GIF or in
a pygame window (port of ``pingpong_tpu/viewer/replay.py``).

CLI surface of the reference's viewer tools (``test_viewer.py`` /
``test_viewer_v2.py``): pick two checkpoints (or the baseline bot), play
``episodes`` greedy games, render. Headless by default (GIF via PIL);
``interactive`` opens the pygame window.

Seeding: one ``torch.Generator`` seeded with ``seed`` draws one reset per
episode. The JAX package splits a key per episode instead; serve draws
are reproducible per backend, so only the distribution of serves is
shared between the two packages.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from pingpong_tpu_torch.env.pong import env_params_from_config
from pingpong_tpu_torch.evaluation.match import BOT, QNET, RNN
from pingpong_tpu_torch.evaluation.registry import BOT_ID, ModelEntry
from pingpong_tpu_torch.models.qnet_rnn import QNetRNN
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.viewer.record import record_episode
from pingpong_tpu_torch.viewer.render import render_gif


def _entry_from(path: Optional[str]) -> ModelEntry:
    if path is None:
        return ModelEntry(BOT_ID, BOT, None)
    params = load_params_any(path)
    kind = RNN if isinstance(params, QNetRNN) else QNET
    return ModelEntry(Path(path).name, kind, str(path), params)


def run_viewer(
    cfg,
    model_a: Optional[str],
    model_b: Optional[str],
    out: str = "view.gif",
    episodes: int = 1,
    interactive: bool = False,
    seed: int = 0,
    max_steps: int = 5000,
    device="cuda",
) -> int:
    env_params = env_params_from_config(cfg.env)
    entry_a = _entry_from(model_a)
    entry_b = _entry_from(model_b)
    generator = torch.Generator().manual_seed(seed)
    trajectories = []
    for ep in range(episodes):
        traj = record_episode(env_params, entry_a, entry_b, generator,
                              max_steps, device=device)
        trajectories.append(traj)
        print(
            f"[view] episode {ep + 1}: {traj.length} steps, "
            f"A {int(traj.score_a[-1])} : {int(traj.score_b[-1])} B"
        )

    if interactive:
        from pingpong_tpu_torch.viewer.pygame_ui import play_interactive

        play_interactive(trajectories, cfg.env.paddle_width,
                         size=cfg.env.render_size)
        return 0

    base = Path(out)
    for i, traj in enumerate(trajectories):
        path = base if episodes == 1 else base.with_name(
            f"{base.stem}_{i + 1}{base.suffix}"
        )
        render_gif(traj, path, cfg.env.paddle_width, size=cfg.env.render_size)
        print(f"[view] wrote {path}")
    return 0
