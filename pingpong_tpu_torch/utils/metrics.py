"""Training metrics: rolling win-rate windows, throughput, JSONL logging.

The reference tracks rolling win rates with per-episode deques and prints
every ``win_rate_interval`` episodes with interval wall-clock
(``scripts/train_iterative.py:116-121, 247-259``). With
vectorized envs, episodes complete in per-iteration bursts, so the window
is kept as (games, wins) pairs and trimmed to the last N episodes.
env-steps/s and steps/s are first-class logged metrics (the BASELINE
target metric).
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Deque, Optional, Tuple


class WinRateWindow:
    """Games-weighted rolling window over the last ``maxlen`` episodes."""

    def __init__(self, maxlen: int):
        self.maxlen = maxlen
        self._chunks: Deque[Tuple[int, int]] = deque()
        self._games = 0
        self._wins = 0

    def add(self, games: int, wins: int) -> None:
        if games <= 0:
            return
        self._chunks.append((games, wins))
        self._games += games
        self._wins += wins
        while self._games - self._chunks[0][0] >= self.maxlen:
            g, w = self._chunks.popleft()
            self._games -= g
            self._wins -= w

    @property
    def games(self) -> int:
        return self._games

    def rate(self) -> float:
        return self._wins / self._games if self._games else 0.0


class Stopwatch:
    def __init__(self):
        self.start = time.perf_counter()
        self.last = self.start

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        return dt

    def total(self) -> float:
        return time.perf_counter() - self.start


class MetricsLogger:
    """Console + JSONL metrics sink."""

    def __init__(self, log_path: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._fh = None
        if log_path:
            Path(log_path).parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(log_path, "a")

    def log(self, record: dict) -> None:
        if self._fh:
            # wall-clock stamp on the persisted line only (console stays
            # compact); lets post-hoc tooling compute per-generation and
            # gen-N wall-clock (the BASELINE.json headline) from any run
            stamped = {"ts": round(time.time(), 3), **record}
            self._fh.write(json.dumps(stamped) + "\n")
            self._fh.flush()
        if self.echo:
            parts = []
            for k, v in record.items():
                if isinstance(v, float):
                    parts.append(f"{k}={v:.4g}")
                else:
                    parts.append(f"{k}={v}")
            print("[metrics] " + " ".join(parts), flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
