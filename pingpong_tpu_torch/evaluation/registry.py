"""Tournament model registry: discovery, loading, batched match dispatch
(port of ``pingpong_tpu/evaluation/registry.py``).

Models are discovered from checkpoint directories, tagged by family
(QNet / QNetRNN / the ball-follower bot) and, for a whole tournament,
grouped by the pair of families so that every pairing of a group runs in
one batched match (:mod:`pingpong_tpu_torch.evaluation.match`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from pingpong_tpu_torch.checkpoint.store import list_checkpoints
from pingpong_tpu_torch.env.pong import EnvState, reset
from pingpong_tpu_torch.evaluation.match import (
    BOT,
    QNET,
    RNN,
    MatchResult,
    PolicySpec,
    make_match_fn,
)
from pingpong_tpu_torch.models.qnet_rnn import QNetRNN
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.utils.device import resolve_device

BOT_ID = "HardcodedBot"


@dataclasses.dataclass
class ModelEntry:
    id: str
    kind: int              # QNET / RNN / BOT
    path: Optional[str]
    params: Optional[object] = None

    @property
    def type_name(self) -> str:
        return {QNET: "QNet", RNN: "QNetRNN",
                BOT: "HardcodedBallFollower"}[self.kind]


def discover_models(ckpt_dirs, include_bot: bool = True,
                    skip_fault: bool = False) -> List[ModelEntry]:
    """Every loadable checkpoint of the directories becomes a candidate
    (id = directory name); ``latest*`` autosaves never do, and ``fault``
    checkpoints not when ``skip_fault``."""
    entries: List[ModelEntry] = []
    seen = set()
    if isinstance(ckpt_dirs, (str, Path)):
        ckpt_dirs = [ckpt_dirs]
    for d in ckpt_dirs:
        for path in list_checkpoints(d):
            if skip_fault and "fault" in path.name:
                continue
            if "latest" in path.name:
                continue
            if path.name in seen:
                continue
            try:
                params = load_params_any(path)
            except (KeyError, ValueError):
                continue
            kind = RNN if isinstance(params, QNetRNN) else QNET
            entries.append(ModelEntry(path.name, kind, str(path), params))
            seen.add(path.name)
    if include_bot:
        entries.append(ModelEntry(BOT_ID, BOT, None))
    return entries


def load_entry(entry: ModelEntry) -> ModelEntry:
    if entry.params is None and entry.kind != BOT:
        entry.params = load_params_any(entry.path)
    return entry


def job_seeds(generator: torch.Generator, n_jobs: int) -> List[int]:
    """One seed per job, drawn from the run's generator in job order."""
    return [int(torch.randint(0, 2**62, (1,), generator=generator))
            for _ in range(n_jobs)]


class MatchRunner:
    """Keeps one match function per (kind_a, kind_b) pair."""

    def __init__(self, env_params, max_steps: int = 20_000,
                 bot_tolerance: float = 0.02, device="cuda"):
        self.env_params = env_params
        self.max_steps = max_steps
        self.bot_tolerance = bot_tolerance
        self.device = resolve_device(device)
        self._fns: Dict[Tuple[int, int], object] = {}

    def _fn(self, kind_a: int, kind_b: int):
        key = (kind_a, kind_b)
        if key not in self._fns:
            self._fns[key] = make_match_fn(
                self.env_params, PolicySpec(kind_a, None),
                PolicySpec(kind_b, None), max_steps=self.max_steps,
                bot_tolerance=self.bot_tolerance, device=self.device)
        return self._fns[key]

    def _resets(self, n_games: int, seed: int) -> EnvState:
        return reset(self.env_params, n_games,
                     torch.Generator().manual_seed(seed), self.device)

    def play(self, a: ModelEntry, b: ModelEntry, n_games: int,
             seed: int) -> MatchResult:
        """``n_games`` of a (top) vs b (bottom) in one batch, the first
        resets drawn from a generator seeded with ``seed``."""
        load_entry(a)
        load_entry(b)
        stack = lambda p: None if p is None else [p]
        idx = torch.zeros((n_games,), dtype=torch.int32)
        return self._fn(a.kind, b.kind)(
            stack(a.params), stack(b.params), idx, idx,
            env_state=self._resets(n_games, seed))

    def play_pairs_batched(self, jobs, generator: torch.Generator):
        """Every pairing in one batched match per family pair.

        ``jobs``: list of ``(a: ModelEntry, b: ModelEntry, n_games)``. A
        group stacks each distinct entry of a side once and plays all its
        games with per-game slot indices. Each job's seed is drawn from
        ``generator`` in job order and its games' resets from that seed,
        as the sequential path draws them, and games never interact, so
        the results are bit-identical to ``play`` called per job.

        Returns ``[(a, b, MatchResult), ...]`` in job order."""
        seeds = job_seeds(generator, len(jobs))
        groups: Dict[Tuple[int, int], list] = {}
        for j, (a, b, _) in enumerate(jobs):
            load_entry(a)
            load_entry(b)
            groups.setdefault((a.kind, b.kind), []).append(j)

        results: List[Optional[MatchResult]] = [None] * len(jobs)
        for (kind_a, kind_b), job_ids in groups.items():
            def side(pick, kind):
                slot_of, nets = {}, []
                for j in job_ids:
                    e = pick(jobs[j])
                    if e.id not in slot_of:
                        slot_of[e.id] = len(nets)
                        nets.append(e.params)
                return slot_of, (None if kind == BOT else nets)

            slot_a, stack_a = side(lambda job: job[0], kind_a)
            slot_b, stack_b = side(lambda job: job[1], kind_b)
            idx_a, idx_b, states, offsets = [], [], [], {}
            total = 0
            for j in job_ids:
                a, b, n = jobs[j]
                offsets[j] = (total, total + n)
                total += n
                idx_a.append(torch.full((n,), slot_a[a.id], dtype=torch.int32))
                idx_b.append(torch.full((n,), slot_b[b.id], dtype=torch.int32))
                states.append(self._resets(n, seeds[j]))
            res = self._fn(kind_a, kind_b)(
                stack_a, stack_b, torch.cat(idx_a), torch.cat(idx_b),
                env_state=EnvState(*(torch.cat(f) for f in zip(*states))))
            for j in job_ids:
                lo, hi = offsets[j]
                results[j] = MatchResult(*(x[lo:hi] for x in res))
        return [(a, b, r) for (a, b, _), r in zip(jobs, results)]
