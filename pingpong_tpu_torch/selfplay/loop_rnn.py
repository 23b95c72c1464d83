"""Iterative self-play with generation promotion for the DRQN (LSTM) agent;
port of ``pingpong_tpu/selfplay/loop_rnn.py``.

* each new generation starts B from A's weights with a fresh optimizer,
  target and per-generation epsilon;
* promotion gate: the win rate vs A AND vs the whole pool clear the
  thresholds; the pool eval splits ``eval_episodes`` evenly over members;
* on promotion the new generation is APPENDED to the runtime pool (up to
  ``pool_max``); after ``max_retries_for_generation`` tries a ``_fault``
  checkpoint is written, B is reset from A (ring kept), and the
  generation counts as done;
* the pool is loaded from disk at start-up, fault checkpoints excluded;
* three-tier restore: (1) the full-state autosave
  ``latest_rnn_training_state`` resumes the whole train state (the
  sequence ring, env and hidden states, optimizer, counters), frozen A,
  the loop's generator and the generation counters; (2) else
  ``init_model_path_rnn`` warm-starts the weights (key chain params_a ->
  params_b -> params); (3) else random init;
* the full state autosaves every ``save_latest_checkpoint_interval_steps``
  train steps (``checkpoint/full_state.py``); retention runs after every
  save;
* gates through the fused recurrent kernel (``use_pallas_eval`` and a
  net of kernel 3's architecture) or the batched match runner
  (``evaluation/match.py``), as the JAX loop decides;
* data parallel (``mesh_cfg``), as ``selfplay/loop.py``: a mesh when the
  process group has more than one rank, the same seeded gates on every
  rank with rank 0's win rates broadcast, the gathered autosave and every
  file written by rank 0 alone;
* the tracer's spans (``utils/trace.py``) and the ``spans`` event of
  ``log_spans``, as ``selfplay/loop.py`` has them.

The learner picks its route from the config (``train/drqn.py``); every
DRQN option of the JAX trainer runs on one device or on a mesh.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import torch

from pingpong_tpu_torch.checkpoint.full_state import (
    AsyncAutosaver,
    autosave_full_state,
    full_state_tree,
    is_train_state_checkpoint,
    restore_full_state,
)
from pingpong_tpu_torch.checkpoint.retention import apply_retention
from pingpong_tpu_torch.checkpoint.serialize import (
    params_from_dict,
    qnet_rnn_to_dict,
)
from pingpong_tpu_torch.checkpoint.store import (
    is_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from pingpong_tpu_torch.config.schema import DRQNConfig, EnvConfig, MeshConfig
from pingpong_tpu_torch.evaluation.fast_eval import (
    rnn_win_rate,
    rnn_win_rate_balanced,
)
from pingpong_tpu_torch.evaluation.match import (
    RNN,
    PolicySpec,
    eval_win_rate_balanced,
    make_match_fn,
)
from pingpong_tpu_torch.models.qnet_rnn import (
    QNetRNN,
    qnet_rnn_copy,
    qnet_rnn_from_flat,
    qnet_rnn_to_flat,
)
from pingpong_tpu_torch.selfplay.loop import GenerationRecord
from pingpong_tpu_torch.parallel.mesh import (
    broadcast_values,
    is_coordinator,
    mesh_for_world,
)
from pingpong_tpu_torch.selfplay.pool import load_pool
from pingpong_tpu_torch.train.drqn import (
    DRQNLearner,
    kernel_architecture,
    stack_rnn_opponents,
)
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.metrics import (
    MetricsLogger,
    Stopwatch,
    WinRateWindow,
)


class DRQNSelfPlay:
    """The generation loop of one DRQN run; ``run()`` executes it."""

    def __init__(self, env_cfg: EnvConfig, cfg: DRQNConfig,
                 workdir: str = ".", seed: int = 0,
                 logger: Optional[MetricsLogger] = None, device="cuda",
                 mesh_cfg: Optional[MeshConfig] = None,
                 log_spans: bool = False):
        self.env_cfg = env_cfg
        self.log_spans = log_spans
        self.cfg = cfg
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / cfg.ckpt_dir_rnn
        self.logger = logger or MetricsLogger()
        # data-parallel when the process group has more than one rank
        self.mesh = mesh_for_world(mesh_cfg)
        if self.mesh is not None:
            self.logger.log({"event": "mesh",
                             "devices": torch.distributed.get_world_size(),
                             "shape": dict(self.mesh.shape)})
        self.coordinator = is_coordinator()
        self.learner = DRQNLearner(env_cfg, cfg, device=device, mesh=self.mesh)
        self.device = self.learner.device
        self.env_params = self.learner.env_params
        self.gen = torch.Generator().manual_seed(int(seed))
        self.match_fn = make_match_fn(self.env_params, PolicySpec(RNN, None),
                                      PolicySpec(RNN, None),
                                      device=self.device)
        self.win_a_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.win_pool_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.records: List[GenerationRecord] = []
        self.reward_history: List[float] = []

        # runtime pool from disk, faults excluded
        self.pool: List[QNetRNN] = load_pool(
            self.ckpt_dir, kind="qnet_rnn", skip_fault=True,
            limit=cfg.pool_max)
        self._autosaver = AsyncAutosaver()

        # ---- three-tier restore
        self.done_generations = 0
        self.current_generation = 0
        self._since_autosave = 0
        self._resumed_mid_generation = False
        latest = self.ckpt_dir / cfg.latest_checkpoint_filename
        if is_train_state_checkpoint(latest):
            try:
                self._restore_full_state(latest)
                self.logger.log({"event": "restore", "tier": 1,
                                 "path": str(latest)})
                return
            except Exception as e:
                self.logger.log({"event": "restore_failed", "tier": 1,
                                 "error": str(e)})
        params = None
        if cfg.init_model_path_rnn:
            init_path = self.workdir / cfg.init_model_path_rnn
            if is_checkpoint(init_path):
                payload = load_checkpoint(init_path)
                for key in ("params_a", "params_b", "params"):
                    if payload.get(key) is not None:
                        params = params_from_dict(payload[key])
                        break
            if params is not None:
                self.logger.log({"event": "restore", "tier": 2,
                                 "path": str(init_path)})
        if params is None:
            params = self.learner.init_params(self.gen)
            self.logger.log({"event": "restore", "tier": 3})
        self.params_a = params
        self.init_params = params
        self.state = self.learner.init_state(self._seed(), params)

    def _seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self.gen))

    # -- full-state autosave / restore ---------------------------------------
    def autosave(self, wait: bool = False) -> str:
        """Full-state autosave: the whole train state (the sequence ring,
        env and hidden states, optimizer, counters), frozen A and the
        loop's generator. With ``cfg.async_autosave`` (the default) a
        worker thread writes a snapshot; ``wait=True`` blocks until the
        file is on disk. Under a mesh every rank gathers the whole state
        here and rank 0 alone saves it."""
        with trace.span("loop::autosave"):
            target = self.ckpt_dir / self.cfg.latest_checkpoint_filename
            state = self.learner.gather_state(self.state)   # collective
            if not self.coordinator:
                return str(target.resolve())
            meta = {"generation": self.current_generation,
                    "done_generations": self.done_generations,
                    "model_kind": "qnet_rnn"}
            flat_a = qnet_rnn_to_flat(self.params_a)
            if self.cfg.async_autosave:
                path = self._autosaver.save(
                    target, full_state_tree(state, flat_a, self.gen), meta)
                if wait:
                    self._autosaver.wait()
            else:
                path = autosave_full_state(target, state, flat_a, self.gen,
                                           meta)
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
        state, flat_a, gen, _, meta = restore_full_state(
            path, self.learner.init_global_state(0, like),
            qnet_rnn_to_flat(like), self.gen, device=self.device)
        self.state = self.learner.shard_state(state)
        self.params_a = qnet_rnn_from_flat(flat_a, like)
        self.init_params = self.params_a
        self.gen = gen
        self.current_generation = int(meta.get("generation", 0))
        self.done_generations = int(meta.get("done_generations", 0))
        # an autosave taken mid-generation: run() continues that
        # generation with the restored B instead of starting the next one
        # (whose new_generation would overwrite B)
        self._resumed_mid_generation = (
            self.current_generation > self.done_generations)

    # -- eval ---------------------------------------------------------------
    def _eval_vs(self, opponents: List[QNetRNN], n_games: int) -> float:
        """B vs opponents, the quota split evenly over them; an empty pool
        counts as win rate 1. Through the fused recurrent gates for
        ``use_pallas_eval`` and a net of kernel 3's architecture, else the
        match runner (``pingpong_tpu/selfplay/loop_rnn.py:196``)."""
        if not opponents:
            return 1.0
        cfg = self.cfg
        params_b = self.learner.params_b(self.state)
        if not (cfg.use_pallas_eval and kernel_architecture(cfg)):
            return self._match_eval_vs(opponents, params_b, n_games)
        kw = dict(n_envs=min(cfg.num_envs, 4096),
                  tile_rows=min(cfg.pallas_tile_rows, cfg.num_envs, 4096),
                  max_episode_steps=cfg.max_episode_steps,
                  device=self.device)
        per = max(2, n_games // len(opponents))
        wins = w_b = w_a = 0.0
        total = 0
        for opp in opponents:
            with trace.span("gate::opponent"):
                if cfg.selfplay.swap_sides_eval:
                    wr, as_b, as_a, eps = rnn_win_rate_balanced(
                        self.env_params, opp, params_b, self.gen,
                        min_episodes=per, **kw)
                    w_b += as_b * eps
                    w_a += as_a * eps
                else:
                    wr, eps = rnn_win_rate(self.env_params, opp, params_b,
                                           self.gen, min_episodes=per, **kw)
            wins += wr * eps
            total += eps
        if cfg.selfplay.swap_sides_eval:
            self.logger.log({"event": "eval_seats",
                             "win_as_b": w_b / max(total, 1),
                             "win_as_a": w_a / max(total, 1)})
        return wins / max(total, 1)

    def _match_eval_vs(self, opponents: List[QNetRNN], params_b: QNetRNN,
                       n_games: int) -> float:
        """The match-runner gate: ``n_games // len(opponents)`` games per
        member (member-major; interleaved for the side-balanced split, so
        each seating still covers every member evenly)."""
        n_opp = len(opponents)
        per = max(1, n_games // n_opp)
        total = per * n_opp
        members = torch.arange(n_opp, dtype=torch.int32)
        idx_b = torch.zeros((total,), dtype=torch.int32)
        if self.cfg.selfplay.swap_sides_eval:
            with trace.span("gate::opponent"):
                rate, as_b, as_a = eval_win_rate_balanced(
                    self.match_fn, list(opponents), [params_b],
                    members.repeat(per), idx_b, self.gen, total)
            self.logger.log({"event": "eval_seats", "win_as_b": as_b,
                             "win_as_a": as_a})
            return rate
        with trace.span("gate::opponent"):
            result = self.match_fn(list(opponents), [params_b],
                                   members.repeat_interleave(per), idx_b,
                                   generator=self.gen)
            return trace.readback(result.win_b.to(torch.float32).mean(),
                                  float)

    def _save(self, name: str, generation: int) -> str:
        with trace.span("loop::checkpoint"):
            if not self.coordinator:   # rank 0 owns the checkpoint writes
                return str(self.ckpt_dir / name)
            st = self.state
            payload = {
                "params_b": qnet_rnn_to_dict(self.learner.params_b(st)),
                "params_a": qnet_rnn_to_dict(self.params_a),
                "epsilon": float(st.epsilon),
                "episode": int(st.episodes),
                "generation": generation,
                "train_steps": int(st.train_steps),
                "model_kind": "qnet_rnn",
            }
            path = save_checkpoint(self.ckpt_dir / name, payload)
            cfg = self.cfg
            if cfg.keep_checkpoints > 0 or cfg.keep_fault_checkpoints > 0:
                deleted = apply_retention(
                    self.ckpt_dir, keep_promoted=cfg.keep_checkpoints,
                    keep_faults=cfg.keep_fault_checkpoints,
                    protect=[Path(cfg.init_model_path_rnn).name]
                    if cfg.init_model_path_rnn else None)
                if deleted:
                    self.logger.log({"event": "retention", "deleted": deleted})
            return str(path)

    # -- training block ------------------------------------------------------
    def _train_block(self, episodes_target: int) -> None:
        sp = self.cfg.selfplay
        interval = self.cfg.save_latest_checkpoint_interval_steps
        goal = self.state.episodes + episodes_target
        watch = Stopwatch()
        # packed once a block from the current A and pool (kernel 3's
        # flat copy of the stack included)
        with trace.span("loop::opponents"):
            stack, pool_size = stack_rnn_opponents(self.params_a, self.pool)
            opp = self.learner.prepare_opponents(stack)
        env_steps = 0
        last_log_eps = self.state.episodes
        with trace.span("loop::train_block"):
            while self.state.episodes < goal:
                steps_before = self.state.train_steps
                self.state, m = self.learner.train_iteration(
                    self.state, opp, pool_size)
                env_steps += m.env_steps
                self.win_a_window.add(m.games_vs_a, m.wins_vs_a)
                self.win_pool_window.add(m.games_vs_pool, m.wins_vs_pool)
                if m.episodes > 0:
                    self.reward_history.append(
                        m.episode_return_sum / m.episodes)
                self._since_autosave += (self.state.train_steps
                                         - steps_before)
                if interval > 0 and self._since_autosave >= interval:
                    self._since_autosave = 0
                    self.autosave()
                eps_now = self.state.episodes
                if eps_now - last_log_eps >= sp.win_rate_interval:
                    dt = watch.lap()
                    self.logger.log({
                        "event": "interval",
                        "episode": eps_now,
                        "win_vs_A": self.win_a_window.rate(),
                        "win_vs_pool": self.win_pool_window.rate(),
                        "epsilon": m.epsilon,
                        "loss": m.mean_loss,
                        "env_steps_per_s": env_steps / max(dt, 1e-9),
                        "buffer_episodes": m.buffer_episodes,
                    })
                    env_steps = 0
                    last_log_eps = eps_now

    # -- main loop -----------------------------------------------------------
    def _try(self, gen: int, tries: int) -> bool:
        """One try of generation ``gen``: its train block, its gate and
        the decision. Returns True when the generation is done (promoted,
        or a fault after the last try)."""
        sp = self.cfg.selfplay
        self.logger.log({"event": "try", "generation": gen, "try": tries})
        self._train_block(sp.episodes_per_generation)
        with trace.timed_span("loop::gate") as gate:
            w_a = self._eval_vs([self.params_a], sp.eval_episodes)
            w_pool = self._eval_vs(self.pool, sp.eval_episodes)
            w_a, w_pool = broadcast_values([w_a, w_pool], self.mesh,
                                           self.device)
        self.logger.log({"event": "eval", "generation": gen,
                         "win_vs_A": w_a, "win_vs_pool": w_pool,
                         "eval_s": gate.seconds})
        if (w_a >= sp.curr_win_threshold
                and w_pool >= sp.pool_win_threshold):
            self.params_a = self.learner.params_b(self.state).cpu()
            path = self._save(f"{self.cfg.model_id_prefix}{gen}", gen)
            if len(self.pool) < self.cfg.pool_max:
                self.pool.append(qnet_rnn_copy(self.params_a))
            self.records.append(GenerationRecord(
                gen, True, tries, w_a, w_pool, self.state.episodes, path))
            self.logger.log({"event": "promoted", "generation": gen,
                             "checkpoint": path})
            self.done_generations += 1
            return True
        if tries >= sp.max_retries_for_generation:
            path = self._save(f"{self.cfg.model_id_prefix}{gen}_fault", gen)
            self.records.append(GenerationRecord(
                gen, False, tries, w_a, w_pool, self.state.episodes, path))
            self.logger.log({"event": "fault", "generation": gen,
                             "checkpoint": path})
            # fresh B from A, ring kept
            with trace.span("loop::reset"):
                self.state = self.learner.reset_learner(self.state,
                                                        self.params_a)
            self.done_generations += 1
            return True
        return False

    def run(self) -> List[GenerationRecord]:
        sp = self.cfg.selfplay
        while self.done_generations < sp.max_generations:
            if self._resumed_mid_generation:
                # a tier-1 restore landed mid-generation: keep its label
                # and the restored B, optimizer and epsilon
                self._resumed_mid_generation = False
            else:
                self.current_generation += 1
                if self.current_generation > 1:
                    self.state = self.learner.new_generation(self.state,
                                                             self.params_a)
            gen = self.current_generation
            tries = 0
            done = False
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
