"""Round-robin tournament: all pairs, batched (port of
``pingpong_tpu/evaluation/round_robin.py``).

Every C(n, 2) pair plays ``episodes_per_match`` greedy games; all pairings
run as a few batched matches (one per pair of policy families). Outputs
are the JAX package's: ``match_records_{ts}.csv`` (one row per game with
scores and winner), ``summary_ranking_{ts}.csv`` (wins, losses, draws and
win rate), a win-rate bar chart, a head-to-head heatmap and a console
ranking table. A draw is possible (winner by final score). The CSVs are
written with the ``csv`` module, with the same headers and rows as the JAX
package's pandas writer; a plot that fails prints a warning and the run
goes on.
"""

from __future__ import annotations

import csv
import itertools
import sys
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from pingpong_tpu_torch.env.pong import env_params_from_config
from pingpong_tpu_torch.evaluation.registry import (
    MatchRunner,
    discover_models,
)

RECORD_FIELDS = ["p1", "p2", "p1_score", "p2_score", "winner", "timestamp"]
SUMMARY_FIELDS = ["model", "wins", "losses", "draws", "games", "win_rate"]


def write_csv(path: Path, fields: List[str], rows: List[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def ranking_rows(ids: List[str], records: List[dict]) -> List[dict]:
    """Per model: wins, losses, draws, games and win rate over the match
    records, best win rate first (ties keep the model order)."""
    stats = {m: {"win": 0, "lose": 0, "draw": 0} for m in ids}
    for r in records:
        p1, p2, w = r["p1"], r["p2"], r["winner"]
        if p1 not in stats or p2 not in stats:
            continue
        if w == "draw":
            stats[p1]["draw"] += 1
            stats[p2]["draw"] += 1
        else:
            stats[w]["win"] += 1
            stats[p2 if w == p1 else p1]["lose"] += 1
    rows = []
    for m in ids:
        s = stats[m]
        total = s["win"] + s["lose"] + s["draw"]
        rows.append({"model": m, "wins": s["win"], "losses": s["lose"],
                     "draws": s["draw"], "games": total,
                     "win_rate": s["win"] / total if total else 0.0})
    return sorted(rows, key=lambda r: -r["win_rate"])


def h2h_matrix(ids: List[str], records: List[dict]) -> np.ndarray:
    """Row model's win rate against the column model (NaN where they
    never met and on the diagonal)."""
    pos = {m: k for k, m in enumerate(ids)}
    n = len(ids)
    wins = np.zeros((n, n))
    games = np.zeros((n, n))
    for r in records:
        if r["p1"] not in pos or r["p2"] not in pos:
            continue
        i, j = pos[r["p1"]], pos[r["p2"]]
        games[i, j] += 1
        games[j, i] += 1
        if r["winner"] == r["p1"]:
            wins[i, j] += 1
        elif r["winner"] == r["p2"]:
            wins[j, i] += 1
    with np.errstate(invalid="ignore", divide="ignore"):
        h2h = np.where(games > 0, wins / np.maximum(games, 1), np.nan)
    np.fill_diagonal(h2h, np.nan)
    return h2h


def plot_tournament(names, win_rates, ids, h2h, out: Path, ts: str) -> None:
    """The win-rate bars and the heatmap; a failure only warns."""
    try:
        from pingpong_tpu_torch.utils.plotting import (
            plot_h2h_heatmap,
            plot_win_rate_bars,
        )

        plot_win_rate_bars(names, win_rates, str(out / f"win_rates_{ts}.png"))
        plot_h2h_heatmap(ids, h2h, str(out / f"h2h_heatmap_{ts}.png"))
    except Exception as e:  # plotting must never fail the run
        print(f"[warn] plot failed: {e}", file=sys.stderr)


def game_records(top, bottom, res) -> List[dict]:
    """One match record a game (``p1`` the top seat)."""
    sa = res.score_a.cpu().tolist()
    sb = res.score_b.cpu().tolist()
    now = datetime.now(timezone.utc).isoformat()
    return [{"p1": top.id, "p2": bottom.id, "p1_score": a, "p2_score": b,
             "winner": top.id if a > b else (bottom.id if b > a else "draw"),
             "timestamp": now} for a, b in zip(sa, sb)]


def run_round_robin(cfg, ckpt_dir, out_dir, episodes_per_match: int = 100,
                    include_bot: bool = True, seed: int = 0,
                    entries: Optional[List] = None,
                    bot_tolerance: float = 0.01, swap_sides: bool = False,
                    device="cuda") -> int:
    """``swap_sides``: half the games of a pair in each seating. All
    pairings play in a few batched matches (bit-identical to
    ``MatchRunner.play`` per pair)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    runner = MatchRunner(env_params_from_config(cfg.env),
                         bot_tolerance=bot_tolerance, device=device)
    if entries is None:
        dirs = ckpt_dir if isinstance(ckpt_dir, (list, tuple)) else [ckpt_dir]
        entries = discover_models(dirs, include_bot=include_bot)
    if len(entries) < 2:
        print(f"[round-robin] need >=2 models, found {len(entries)}")
        return 1

    gen = torch.Generator().manual_seed(int(seed))
    t_start = time.perf_counter()
    pairs = list(itertools.combinations(range(len(entries)), 2))
    # seatings (top, bottom, n_games); the records keep the true seating
    jobs = []
    for i, j in pairs:
        a, b = entries[i], entries[j]
        if swap_sides:
            half = episodes_per_match // 2
            jobs += [(a, b, half), (b, a, episodes_per_match - half)]
        else:
            jobs.append((a, b, episodes_per_match))
    played = runner.play_pairs_batched(jobs, gen)

    records = []
    per_pair = {}
    for top, bottom, res in played:
        recs = game_records(top, bottom, res)
        records += recs
        w, d = per_pair.setdefault(tuple(sorted((top.id, bottom.id))),
                                   ({top.id: 0, bottom.id: 0}, [0]))
        for r in recs:
            if r["winner"] == "draw":
                d[0] += 1
            else:
                w[r["winner"]] += 1
    for i, j in pairs:
        a, b = entries[i], entries[j]
        w, d = per_pair[tuple(sorted((a.id, b.id)))]
        print(f"[round-robin] {a.id} vs {b.id}: {w[a.id]}-{w[b.id]} "
              f"(draws {d[0]})" + (" [side-balanced]" if swap_sides else ""))

    dt = time.perf_counter() - t_start
    games = len(records)
    print(f"[round-robin] {games} games in {dt:.1f}s "
          f"({games / max(dt, 1e-9):.0f} games/s)")

    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    write_csv(out / f"match_records_{ts}.csv", RECORD_FIELDS, records)
    ids = [e.id for e in entries]
    summary = ranking_rows(ids, records)
    write_csv(out / f"summary_ranking_{ts}.csv", SUMMARY_FIELDS, summary)
    by_id = {r["model"]: r["win_rate"] for r in summary}
    plot_tournament(ids, [by_id[m] for m in ids], ids,
                    h2h_matrix(ids, records), out, ts)

    print(f"\n{'rank':<5}{'model':<28}{'W':>6}{'L':>6}{'D':>6}"
          f"{'win rate':>10}")
    for rank, row in enumerate(summary, 1):
        print(f"{rank:<5}{row['model']:<28}{row['wins']:>6}"
              f"{row['losses']:>6}{row['draws']:>6}{row['win_rate']:>10.4f}")
    return 0
