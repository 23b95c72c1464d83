"""The generation loop of both agent families, :class:`SelfPlayLoop`; the
QNet and DRQN loops (``selfplay/loop.py``, ``selfplay/loop_rnn.py``) are
its subclasses. It has no JAX twin: each JAX loop writes it out in
full.

* a try: B trains against A and the pool for ``episodes_per_generation``
  episodes, then is gated greedily vs A and vs the pool, ``eval_episodes``
  games each (an empty pool counts as win rate 1.0), through the family's
  fused kernel or the match runner; a side-balanced gate logs
  ``eval_seats``. Both rates at their thresholds promote (A <- B, a
  checkpoint); after ``max_retries_for_generation`` tries a ``_fault``
  checkpoint resets B and the generation counts as done;
* a full-state autosave (``checkpoint/full_state.py``: the replay, env
  states, optimizer, counters, A, the loop's generator and A's noise draw)
  every ``save_latest_checkpoint_interval_steps`` train steps, restored at
  start-up with the generation's label and a bit-equal state; retention
  after every checkpoint (the warm start is protected);
* data parallel over a process group of more than one rank (``mesh_cfg``,
  a ``mesh`` event): every rank runs the same seeded gates and takes rank
  0's win rates; the autosave gathers the state (a collective) and rank 0
  alone writes it, the checkpoints and the retention;
* spans (``utils/trace.py``): ``loop::try`` (marked ``(generation, try)``),
  ``loop::opponents``, ``loop::train_block`` (in it ``loop::autosave``),
  ``loop::gate`` (``eval_s`` is its length; ``gate::opponent`` an opponent,
  one for the match runner), ``loop::checkpoint``, ``loop::reset``; with
  ``log_spans`` a ``spans`` event drains the tracer each try.
"""

from __future__ import annotations

import abc
import dataclasses
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from pingpong_tpu_torch.checkpoint.full_state import (
    AsyncAutosaver,
    autosave_full_state,
    full_state_tree,
    is_train_state_checkpoint,
    restore_full_state,
)
from pingpong_tpu_torch.checkpoint.retention import apply_retention
from pingpong_tpu_torch.checkpoint.store import save_checkpoint
from pingpong_tpu_torch.config.schema import EnvConfig, MeshConfig
from pingpong_tpu_torch.evaluation.match import (
    PolicySpec,
    eval_win_rate_balanced,
    make_match_fn,
)
from pingpong_tpu_torch.parallel.mesh import (
    broadcast_values,
    is_coordinator,
    mesh_for_world,
)
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.metrics import (
    MetricsLogger,
    Stopwatch,
    WinRateWindow,
)


@dataclasses.dataclass
class GenerationRecord:
    generation: int
    promoted: bool
    tries: int
    win_vs_a: float
    win_vs_pool: float
    episodes: int
    checkpoint: str


class Family(NamedTuple):
    """What the loop uses of an agent family's types and config fields."""

    kind: str                           # checkpoints' model_kind
    learner: type
    policy: str                         # the match runner's policy kind
    to_flat: Callable
    from_flat: Callable
    to_dict: Callable
    gates: Tuple[Callable, Callable]    # fused: single-seat, side-balanced
    checkpoint: str                     # name pattern of cfg and gen
    ckpt_dir_field: str
    init_path_field: str                # the warm start, kept by retention


class SelfPlayLoop(abc.ABC):
    """The generation loop of one run; ``run()`` executes it. A family
    gives its :class:`Family` and its decisions, the abstract methods:
    ``_start`` draws A, B's state and the pool from ``self.gen`` in its
    order, then :meth:`_resume`; ``_fields`` gives its own fields of a
    checkpoint, an ``eval`` and an ``interval`` record; ``_fused_gate``
    gives ``(b, kwargs)`` for a gate's fused seats, or None."""

    family: Family

    def __init__(self, env_cfg: EnvConfig, cfg, workdir: str = ".",
                 seed: int = 0, logger: Optional[MetricsLogger] = None,
                 device="cuda", mesh_cfg: Optional[MeshConfig] = None,
                 log_spans: bool = False):
        fam = self.family
        self.env_cfg, self.cfg, self.log_spans = env_cfg, cfg, log_spans
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / getattr(cfg, fam.ckpt_dir_field)
        self.logger = logger or MetricsLogger()
        # data-parallel when the process group has more than one rank
        self.mesh = mesh_for_world(mesh_cfg)
        if self.mesh is not None:
            self.logger.log({"event": "mesh",
                             "devices": torch.distributed.get_world_size(),
                             "shape": dict(self.mesh.shape)})
        self.coordinator = is_coordinator()
        self.learner = fam.learner(env_cfg, cfg, device=device, mesh=self.mesh)
        self.device = self.learner.device
        self.env_params = self.learner.env_params
        self.gen = torch.Generator().manual_seed(int(seed))
        self.match_fn = make_match_fn(self.env_params,
                                      PolicySpec(fam.policy, None),
                                      PolicySpec(fam.policy, None),
                                      device=self.device)
        self._autosaver = AsyncAutosaver()
        self.win_a_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.win_pool_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.records: List[GenerationRecord] = []
        self.reward_history: List[float] = []
        self.done_generations = self.current_generation = 0
        self._since_autosave = 0
        self._resumed_mid_generation = False
        self._a_fold_noise = None         # A's noise draw, autosaved
        # A and the pool as a fused gate takes them (a family keeping their
        # packs replaces these with its FrozenPacks)
        self._a_packs = self._pool_packs = lambda net: net
        self._start()

    # -- the family's decisions ----------------------------------------------
    @abc.abstractmethod
    def _start(self) -> None: ...
    @abc.abstractmethod
    def _noise_like(self, like): ...
    @abc.abstractmethod
    def _restored(self, params_a, noise) -> None: ...
    @abc.abstractmethod
    def _promote(self) -> None: ...
    @abc.abstractmethod
    def _fault_params(self): ...
    @abc.abstractmethod
    def _new_generation(self) -> None: ...
    @abc.abstractmethod
    def _fields(self, record: str, metrics=None) -> dict: ...
    @abc.abstractmethod
    def _fused_gate(self): ...
    @abc.abstractmethod
    def _gate_quota(self, n_games: int, n_opponents: int) -> int: ...
    @abc.abstractmethod
    def _match_opponents(self, n_opponents: int,
                         n_games: int) -> torch.Tensor: ...

    # -- start-up, autosave and restore --------------------------------------
    def _seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self.gen))

    def _resume(self, tier: int) -> bool:
        """Restore the full-state autosave, logged as a ``restore`` of
        ``tier``; False when there is none or it does not fit."""
        latest = self.ckpt_dir / self.cfg.latest_checkpoint_filename
        if not is_train_state_checkpoint(latest):
            return False
        try:
            self._restore_full_state(latest)
            self.logger.log({"event": "restore", "tier": tier,
                             "path": str(latest)})
        except Exception as e:
            self.logger.log({"event": "restore_failed", "tier": tier,
                             "error": str(e)})
            return False
        return True

    def autosave(self, wait: bool = False) -> str:
        """Full-state autosave. With ``cfg.async_autosave`` (the default)
        the call takes a device snapshot and a worker thread writes it;
        ``wait=True`` blocks until the file is on disk. Under a mesh every
        rank gathers the whole state here and rank 0 alone saves it."""
        with trace.span("loop::autosave"):
            target = self.ckpt_dir / self.cfg.latest_checkpoint_filename
            state = self.learner.gather_state(self.state)   # collective
            if not self.coordinator:
                return str(target.resolve())
            meta = {"generation": self.current_generation,
                    "done_generations": self.done_generations,
                    "model_kind": self.family.kind}
            flat_a = self.family.to_flat(self.params_a)
            if self.cfg.async_autosave:
                path = self._autosaver.save(target, full_state_tree(
                    state, flat_a, self.gen, self._a_fold_noise), meta)
                if wait:
                    self._autosaver.wait()
            else:
                path = autosave_full_state(target, state, flat_a, self.gen,
                                           meta, self._a_fold_noise)
            self.logger.log({"event": "autosave",
                             "train_steps": self.state.train_steps})
            return str(path)

    def flush_autosave(self) -> None:
        """Join any in-flight async autosave write, then stop the saver's
        worker and free its pinned buffers (the next autosave starts them
        anew)."""
        self._autosaver.close()

    def _restore_full_state(self, path) -> None:
        like = self.learner.template
        state, flat_a, gen, noise, meta = restore_full_state(
            path, self.learner.init_global_state(0, like),
            self.family.to_flat(like), self.gen, self._noise_like(like),
            device=self.device)
        self.state = self.learner.shard_state(state)
        self.gen = gen
        self.current_generation = int(meta.get("generation", 0))
        self.done_generations = int(meta.get("done_generations", 0))
        self._restored(self.family.from_flat(flat_a, like), noise)
        # an autosave taken mid-generation: run() continues that
        # generation with the restored B instead of starting the next one
        self._resumed_mid_generation = (
            self.current_generation > self.done_generations)

    def _save(self, name: str, generation: int) -> str:
        with trace.span("loop::checkpoint"):
            if not self.coordinator:   # rank 0 owns the checkpoint writes
                return str(self.ckpt_dir / name)
            st = self.state
            payload = {
                "params_b": self.family.to_dict(self.learner.params_b(st)),
                "params_a": self.family.to_dict(self.params_a),
                **self._fields("checkpoint"),
                "epsilon": float(st.epsilon), "episode": int(st.episodes),
                "generation": generation, "train_steps": int(st.train_steps),
                "model_kind": self.family.kind}
            path = save_checkpoint(self.ckpt_dir / name, payload)
            cfg = self.cfg
            if cfg.keep_checkpoints > 0 or cfg.keep_fault_checkpoints > 0:
                init = getattr(cfg, self.family.init_path_field)
                deleted = apply_retention(
                    self.ckpt_dir, keep_promoted=cfg.keep_checkpoints,
                    keep_faults=cfg.keep_fault_checkpoints,
                    protect=[Path(init).name] if init else None)
                if deleted:
                    self.logger.log({"event": "retention", "deleted": deleted})
            return str(path)

    # -- a try -----------------------------------------------------------------
    def _train_block(self, episodes_target: int) -> None:
        """Train iterations against ``[A, pool...]`` until
        ``episodes_target`` more episodes complete, autosaving every
        ``save_latest_checkpoint_interval_steps`` train steps."""
        sp = self.cfg.selfplay
        interval = self.cfg.save_latest_checkpoint_interval_steps
        goal = self.state.episodes + episodes_target
        watch = Stopwatch()
        with trace.span("loop::opponents"):
            pool_size = len(self.pool)
            opp = self.learner.prepare_opponents(
                [self.params_a_play] + list(self.pool))
        env_steps = 0
        last_log_eps = self.state.episodes
        with trace.span("loop::train_block"):
            while self.state.episodes < goal:
                steps_before = self.state.train_steps
                self.state, m = self.learner.train_iteration(
                    self.state, opp, pool_size)
                env_steps += m.env_steps
                self._since_autosave += (self.state.train_steps
                                         - steps_before)
                if interval > 0 and self._since_autosave >= interval:
                    self._since_autosave = 0
                    self.autosave()
                self.win_a_window.add(m.games_vs_a, m.wins_vs_a)
                self.win_pool_window.add(m.games_vs_pool, m.wins_vs_pool)
                if m.episodes > 0:
                    self.reward_history.append(
                        m.episode_return_sum / m.episodes)
                eps_now = self.state.episodes
                if eps_now - last_log_eps >= sp.win_rate_interval:
                    dt = watch.lap()
                    self.logger.log({
                        "event": "interval", "episode": eps_now,
                        "win_vs_A": self.win_a_window.rate(),
                        "win_vs_pool": self.win_pool_window.rate(),
                        "epsilon": m.epsilon, "loss": float(m.mean_loss),
                        "env_steps_per_s": env_steps / max(dt, 1e-9),
                        **self._fields("interval", m)})
                    env_steps = 0
                    last_log_eps = eps_now

    def _gate(self) -> List[float]:
        """B's win rates vs A and vs the pool (rank 0's on every rank)."""
        n = self.cfg.selfplay.eval_episodes
        fused = self._fused_gate()
        w_a = self._eval_vs([self.params_a_play], n, fused, self._a_packs)
        w_pool = self._eval_vs(self.pool, n, fused, self._pool_packs)
        return broadcast_values([w_a, w_pool], self.mesh, self.device)

    def _eval_vs(self, opponents: list, n_games: int, fused,
                 frozen: Callable) -> float:
        """B vs a set of opponents: through the family's fused gate, each
        opponent in the form ``frozen`` keeps of it for at least
        :meth:`_gate_quota` episodes, or through the match runner."""
        if not opponents:
            return 1.0
        if fused is None:
            return self._match_eval_vs(opponents, n_games)
        (b, kw), balanced = fused, self.cfg.selfplay.swap_sides_eval
        play = self.family.gates[balanced]
        per = self._gate_quota(n_games, len(opponents))
        # the rates (balanced: total, as B, as A) weighted by episodes
        sums, total = [0.0] * (3 if balanced else 1), 0
        for opp in opponents:
            with trace.span("gate::opponent"):
                *rates, eps = play(self.env_params, frozen(opp), b, self.gen,
                                   min_episodes=per, **kw)
            sums = [s + r * eps for s, r in zip(sums, rates)]
            total += eps
        rate, *seats = (s / max(total, 1) for s in sums)
        if seats:
            self.logger.log({"event": "eval_seats", "win_as_b": seats[0],
                             "win_as_a": seats[1]})
        return rate

    def _match_eval_vs(self, opponents: list, n_games: int) -> float:
        """The match-runner gate: one batch of games (one a seating when
        side-balanced), each against :meth:`_match_opponents`' member."""
        params_b = self.learner.params_b(self.state)
        idx_opp = self._match_opponents(len(opponents), n_games)
        n = idx_opp.shape[0]
        idx_b = torch.zeros((n,), dtype=torch.int32)
        with trace.span("gate::opponent"):
            if not self.cfg.selfplay.swap_sides_eval:
                result = self.match_fn(list(opponents), [params_b], idx_opp,
                                       idx_b, generator=self.gen)
                return trace.readback(result.win_b.to(torch.float32).mean(),
                                      float)
            rate, as_b, as_a = eval_win_rate_balanced(
                self.match_fn, list(opponents), [params_b], idx_opp, idx_b,
                self.gen, n)
        self.logger.log({"event": "eval_seats", "win_as_b": as_b,
                         "win_as_a": as_a})
        return rate

    def _try(self, gen: int, tries: int) -> bool:
        """One try of generation ``gen``: its train block, its gate and
        the decision. Returns True when the generation is done (promoted,
        or a fault after the last try)."""
        sp = self.cfg.selfplay
        self.logger.log({"event": "try", "generation": gen, "try": tries})
        self._train_block(sp.episodes_per_generation)
        with trace.timed_span("loop::gate") as gate:
            w_a, w_pool = self._gate()
        self.logger.log({"event": "eval", "generation": gen,
                         "win_vs_A": w_a, "win_vs_pool": w_pool,
                         **self._fields("eval"), "eval_s": gate.seconds})
        promoted = (w_a >= sp.curr_win_threshold
                    and w_pool >= sp.pool_win_threshold)
        if not promoted and tries < sp.max_retries_for_generation:
            return False
        if promoted:
            self._promote()
        name = self.family.checkpoint.format(cfg=self.cfg, gen=gen)
        path = self._save(name + ("" if promoted else "_fault"), gen)
        self.records.append(GenerationRecord(
            gen, promoted, tries, w_a, w_pool, self.state.episodes, path))
        self.logger.log({"event": "promoted" if promoted else "fault",
                         "generation": gen, "checkpoint": path})
        if not promoted:
            with trace.span("loop::reset"):
                self.state = self.learner.reset_learner(
                    self.state, self._fault_params())
        self.done_generations += 1
        return True

    def run(self) -> List[GenerationRecord]:
        sp = self.cfg.selfplay
        while self.done_generations < sp.max_generations:
            if self._resumed_mid_generation:
                # a restore landed mid-generation: keep its label and the
                # restored B, optimizer and epsilon
                self._resumed_mid_generation = False
            else:
                self.current_generation += 1
                self._new_generation()
            gen, tries, done = self.current_generation, 0, False
            while not done:
                tries += 1
                with trace.span("loop::try", try_id=(gen, tries)):
                    done = self._try(gen, tries)
                if self.log_spans:
                    self.logger.log({"event": "spans", "generation": gen,
                                     "try": tries,
                                     **trace.summarize(trace.drain())})
        if self.cfg.save_latest_checkpoint_interval_steps > 0:
            self.autosave()            # the final full state
        self.flush_autosave()
        return self.records
