"""Training and tournament plots (matplotlib, headless); a copy of
``pingpong_tpu/utils/plotting.py``.

The reward curves of a self-play run (raw series and window-50 smoothing),
the per-generation gate chart, and the tournament charts (win-rate bars and
the head-to-head heatmap), without a seaborn dependency. matplotlib is
imported when a plot is drawn, not with this module: callers treat a failed
plot as a warning.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_reward_history(
    rewards: Sequence[float], out_path: str, window: int = 50,
    title: str = "Self-play training reward",
) -> Optional[str]:
    if len(rewards) == 0:
        return None
    plt = _mpl()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(rewards, dtype=np.float64)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(arr, alpha=0.3, label="Reward B")
    if len(arr) >= window:
        smooth = np.convolve(arr, np.ones(window) / window, mode="valid")
        ax.plot(range(window - 1, len(arr)), smooth, label=f"Smoothed (w={window})")
    ax.set_xlabel("Episode block")
    ax.set_ylabel("Reward B")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_selfplay_records(records: List, out_path: str) -> Optional[str]:
    """Per-generation eval win rates + promotion outcome."""
    if not records:
        return None
    plt = _mpl()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    gens = [r.generation for r in records]
    wa = [r.win_vs_a for r in records]
    wp = [r.win_vs_pool for r in records]
    colors = ["tab:green" if r.promoted else "tab:red" for r in records]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(gens, wa, "o-", label="win rate vs A")
    ax.plot(gens, wp, "s--", label="win rate vs pool")
    for g, w, c in zip(gens, wa, colors):
        ax.scatter([g], [w], color=c, zorder=5)
    ax.set_xlabel("Generation")
    ax.set_ylabel("Eval win rate")
    ax.set_ylim(0, 1)
    ax.set_title("Generation promotion gates (green=promoted, red=fault)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_win_rate_bars(
    names: Sequence[str], win_rates: Sequence[float], out_path: str,
    title: str = "Tournament win rates",
) -> str:
    plt = _mpl()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    order = np.argsort(win_rates)[::-1]
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.9), 4.5))
    ax.bar(
        [names[i] for i in order],
        [win_rates[i] for i in order],
        color="tab:blue",
    )
    ax.set_ylabel("Win rate")
    ax.set_ylim(0, 1)
    ax.set_title(title)
    plt.setp(ax.get_xticklabels(), rotation=30, ha="right")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_h2h_heatmap(
    names: Sequence[str], matrix: np.ndarray, out_path: str,
    title: str = "Head-to-head win rate (row vs column)",
) -> str:
    plt = _mpl()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    n = len(names)
    fig, ax = plt.subplots(figsize=(max(5, n * 0.8 + 2), max(4, n * 0.7 + 1.5)))
    im = ax.imshow(matrix, cmap="RdYlGn", vmin=0.0, vmax=1.0)
    ax.set_xticks(range(n), names, rotation=45, ha="right")
    ax.set_yticks(range(n), names)
    for i in range(n):
        for j in range(n):
            if i == j or not np.isfinite(matrix[i, j]):
                continue
            ax.text(j, i, f"{matrix[i, j]:.2f}", ha="center", va="center",
                    fontsize=8)
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
