"""Persistent, resumable arena tournament with a JSON match database
(port of ``pingpong_tpu/evaluation/arena.py``; the same database).

* JSON DB ``{"models": [...], "match_history": [...]}`` with model entries
  ``{id, type, path, description}`` and match records ``{p1, p2, winner,
  p1_score, p2_score, timestamp}``; winner by final score, draws possible;
* ``register_models`` appends only unseen ids, so new checkpoints join an
  existing tournament;
* incremental match plan: per sorted pair, ``episodes_per_match -
  already_played`` games, so a rerun resumes where the last save left off
  (a database the JAX package wrote resumes here too);
* the summary is recomputed from the whole history; a timestamped ranking
  CSV, win-rate bars and an H2H heatmap go under the results directory
  (a plot that fails only warns).

Each remaining pairing's games run batched; the database is saved after
every batch, or after every slice of at most ``save_every`` games.
"""

from __future__ import annotations

import itertools
import json
from collections import Counter
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import torch

from pingpong_tpu_torch.env.pong import env_params_from_config
from pingpong_tpu_torch.evaluation.match import BOT, QNET, RNN
from pingpong_tpu_torch.evaluation.registry import (
    MatchRunner,
    ModelEntry,
    discover_models,
    job_seeds,
)
from pingpong_tpu_torch.evaluation.round_robin import (
    SUMMARY_FIELDS,
    game_records,
    h2h_matrix,
    plot_tournament,
    ranking_rows,
    write_csv,
)

_KIND_BY_NAME = {"QNet": QNET, "QNetRNN": RNN, "HardcodedBallFollower": BOT}


def load_database(db_path: Path) -> Dict:
    db_path = Path(db_path)
    if db_path.exists() and db_path.stat().st_size > 0:
        try:
            with open(db_path, "r", encoding="utf-8") as f:
                data = json.load(f)
            data.setdefault("models", [])
            data.setdefault("match_history", [])
            return data
        except json.JSONDecodeError:
            print(f"[arena] corrupt database {db_path}; starting fresh")
    return {"models": [], "match_history": []}


def save_database(db_path: Path, data: Dict) -> None:
    db_path = Path(db_path)
    tmp = db_path.with_suffix(db_path.suffix + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, ensure_ascii=False)
    tmp.replace(db_path)


def register_models(database: Dict, candidates: List[Dict]) -> bool:
    known = {m["id"] for m in database["models"]}
    added = False
    for cand in candidates:
        if cand["id"] not in known:
            database["models"].append(cand)
            known.add(cand["id"])
            added = True
    return added


def create_match_plan(database: Dict, episodes_per_match: int) -> List[Dict]:
    ids = [m["id"] for m in database["models"]]
    played = Counter()
    for rec in database["match_history"]:
        played[tuple(sorted((rec["p1"], rec["p2"])))] += 1
    plan = []
    for p1, p2 in itertools.combinations(ids, 2):
        remaining = episodes_per_match - played[tuple(sorted((p1, p2)))]
        if remaining > 0:
            plan.append({"p1_id": p1, "p2_id": p2,
                         "episodes_to_run": remaining})
    return plan


def _entries_from_db(database: Dict) -> Dict[str, ModelEntry]:
    out = {}
    for m in database["models"]:
        kind = _KIND_BY_NAME.get(m.get("type", "QNet"), QNET)
        out[m["id"]] = ModelEntry(m["id"], kind, m.get("path"))
    return out


def run_tournament(runner: MatchRunner, database: Dict, db_path: Path,
                   match_plan: List[Dict], generator: torch.Generator,
                   swap_sides: bool = False, save_every: int = 0) -> None:
    """Plays every remaining pairing in one batched match per family pair
    (results bit-identical to ``MatchRunner.play`` per pair) and saves the
    DB once per batch. ``save_every=N`` splits the plan into slices of
    at most N games, each its own batched match followed by a save, so a
    crash loses at most N games; ``save_every=1`` saves after every game,
    the reference arena's granularity."""
    entries = _entries_from_db(database)
    jobs = []
    job_pair = []
    for item in match_plan:
        a = entries[item["p1_id"]]
        b = entries[item["p2_id"]]
        n = item["episodes_to_run"]
        seatings = ([(a, b, n // 2), (b, a, n - n // 2)] if swap_sides
                    else [(a, b, n)])
        for top, bottom, m in seatings:
            if m == 0:
                continue
            if save_every > 0:
                # no slice element exceeds the save budget
                while m > save_every:
                    jobs.append((top, bottom, save_every))
                    job_pair.append((a.id, b.id, n))
                    m -= save_every
            jobs.append((top, bottom, m))
            job_pair.append((a.id, b.id, n))

    wins: Dict = {}

    def record(played_slice, pair_slice):
        for (top, bottom, res), (aid, bid, _n) in zip(played_slice,
                                                      pair_slice):
            recs = game_records(top, bottom, res)
            database["match_history"] += [
                {k: r[k] for k in ("p1", "p2", "winner", "p1_score",
                                   "p2_score", "timestamp")} for r in recs]
            w = wins.setdefault((aid, bid), {aid: 0, bid: 0})
            for r in recs:
                if r["winner"] != "draw":
                    w[r["winner"]] += 1

    if jobs and save_every > 0:
        i = 0
        while i < len(jobs):
            j, budget = i, save_every
            while j < len(jobs) and jobs[j][2] <= budget:
                budget -= jobs[j][2]
                j += 1
            j = max(j, i + 1)
            slice_gen = torch.Generator().manual_seed(
                job_seeds(generator, 1)[0])
            record(runner.play_pairs_batched(jobs[i:j], slice_gen),
                   job_pair[i:j])
            save_database(db_path, database)       # resume point per slice
            i = j
    elif jobs:
        record(runner.play_pairs_batched(jobs, generator), job_pair)
        save_database(db_path, database)           # resume point per batch
    for (aid, bid, n) in dict.fromkeys(job_pair):
        w = wins[(aid, bid)]
        print(f"[arena] {aid} vs {bid}: +{n} games ({w[aid]}-{w[bid]})"
              + (" [side-balanced]" if swap_sides else ""))


def generate_summary_report(database: Dict) -> List[dict]:
    """The ranking rows over the whole history, best win rate first."""
    return ranking_rows([m["id"] for m in database["models"]],
                        database["match_history"])


def format_summary(rows: List[dict]) -> str:
    """A right-aligned text table of the ranking rows."""
    cells = [SUMMARY_FIELDS] + [
        [f"{r[k]:.4f}" if isinstance(r[k], float) else str(r[k])
         for k in SUMMARY_FIELDS] for r in rows]
    widths = [max(len(row[i]) for row in cells)
              for i in range(len(SUMMARY_FIELDS))]
    return "\n".join(" ".join(c.rjust(w) for c, w in zip(row, widths))
                     for row in cells)


def run_arena(cfg, ckpt_dir, db_path, out_dir, episodes_per_match: int = 100,
              include_bot: bool = True, seed: int = 0,
              candidates: Optional[List[Dict]] = None,
              bot_tolerance: float = 0.02, swap_sides: bool = False,
              save_every: int = 0, device="cuda") -> int:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    db_path = Path(db_path)

    database = load_database(db_path)
    if candidates is None:
        dirs = ckpt_dir if isinstance(ckpt_dir, (list, tuple)) else [ckpt_dir]
        found = discover_models(dirs, include_bot=include_bot)
        candidates = [
            {"id": e.id, "type": e.type_name, "path": e.path,
             "description": f"auto-discovered from {e.path}" if e.path
             else "baseline bot"}
            for e in found
        ]
    register_models(database, candidates)
    save_database(db_path, database)

    plan = create_match_plan(database, episodes_per_match)
    total = sum(p["episodes_to_run"] for p in plan)
    print(f"[arena] {len(database['models'])} models, "
          f"{len(plan)} pairings with {total} games remaining")

    runner = MatchRunner(env_params_from_config(cfg.env),
                         bot_tolerance=bot_tolerance, device=device)
    run_tournament(runner, database, db_path, plan,
                   torch.Generator().manual_seed(int(seed)),
                   swap_sides=swap_sides, save_every=save_every)

    summary = generate_summary_report(database)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    write_csv(out / f"summary_ranking_{ts}.csv", SUMMARY_FIELDS, summary)
    ids = [m["id"] for m in database["models"]]
    if len(ids) >= 2:
        plot_tournament([r["model"] for r in summary],
                        [r["win_rate"] for r in summary], ids,
                        h2h_matrix(ids, database["match_history"]), out, ts)
    print(format_summary(summary))
    return 0
