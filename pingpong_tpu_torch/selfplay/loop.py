"""Iterative self-play with win-rate-gated generation promotion (QNet);
port of ``pingpong_tpu/selfplay/loop.py``.

* learner B trains against frozen A (or a pool member) for
  ``episodes_per_generation`` episodes;
* B is evaluated greedily vs A over ``eval_episodes`` games and vs the
  pool (split evenly over members; an empty pool counts as win rate 1.0);
* both win rates >= thresholds: promotion, A <- B, checkpoint
  ``model{id}-{gen}``; otherwise retry, and after
  ``max_retries_for_generation`` tries checkpoint ``..._fault``, reset B to
  the initial weights with a fresh buffer, optimizer and epsilon, and count
  the generation done anyway;
* the pool is loaded once at start-up from every checkpoint in the
  checkpoint directory, fault checkpoints included;
* full-train-state autosave (PER buffer, env states, optimizer, counters,
  frozen A, the loop's generator and the frozen-A noise draw) every
  ``save_latest_checkpoint_interval_steps`` train steps
  (``checkpoint/full_state.py``), restored as tier 0 at start-up: an
  interrupted generation continues with the same label and a bit-equal
  state;
* data parallel (``mesh_cfg``, one process a card under torch.distributed):
  a mesh over the process group when it has more than one rank (a ``mesh``
  event); every rank runs the same seeded gates, and rank 0's win rates are
  broadcast, so the promotions and faults are the same on every rank; the
  autosave gathers the whole state (a collective every rank reaches at the
  same train step) and only rank 0 writes it, the model checkpoints, the
  retention and (through the CLI) the logs and plots;
* checkpoint retention after every save (``keep_checkpoints``,
  ``keep_fault_checkpoints``);
* gates through the fused kernels (``use_pallas_eval``) or the batched
  match runner (``evaluation/match.py``);
* spans of the program's tracer (``utils/trace.py``) around a try
  (``loop::try``, marked with ``(generation, try)``), its opponents
  (``loop::opponents``), its train block (``loop::train_block``, with the
  autosave stall ``loop::autosave``), its gate (``loop::gate``, one
  ``gate::opponent`` each; ``eval_s`` is that span's length; counters
  ``gate::packs`` and ``gate::pack_hits``: B is gathered from its flat
  parameters once a gate, A and the pool packed once a lifetime), the
  checkpoint (``loop::checkpoint``) and the reset after a fault
  (``loop::reset``); with ``log_spans`` each try ends in a ``spans`` event
  that drains the tracer (``cli train --trace``).
"""

from __future__ import annotations

import dataclasses
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
    opt_state_to_leaves,
    qnet_to_dict,
)
from pingpong_tpu_torch.checkpoint.store import load_checkpoint, save_checkpoint
from pingpong_tpu_torch.config.schema import DQNConfig, EnvConfig, MeshConfig
from pingpong_tpu_torch.evaluation.fast_eval import (
    FrozenPacks,
    GateNet,
    fused_win_rate,
    fused_win_rate_balanced,
    gate_net,
)
from pingpong_tpu_torch.evaluation.match import (
    QNET,
    PolicySpec,
    eval_win_rate_balanced,
    make_match_fn,
)
from pingpong_tpu_torch.models.qnet import (
    QNet,
    qnet_copy,
    qnet_fold_noise,
    qnet_from_flat,
    qnet_init,
    qnet_sample_noise,
    qnet_to_flat,
)
from pingpong_tpu_torch.parallel.mesh import (
    broadcast_values,
    is_coordinator,
    mesh_for_world,
)
from pingpong_tpu_torch.selfplay.pool import load_params_any, load_pool
from pingpong_tpu_torch.train.dqn import DQNLearner, stack_opponents
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


class QNetSelfPlay:
    """The generation loop of one run; ``run()`` executes it."""

    def __init__(self, env_cfg: EnvConfig, cfg: DQNConfig,
                 workdir: str = ".", seed: int = 0,
                 logger: Optional[MetricsLogger] = None, device="cuda",
                 mesh_cfg: Optional[MeshConfig] = None,
                 log_spans: bool = False):
        self.env_cfg = env_cfg
        self.log_spans = log_spans
        self.cfg = cfg
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / cfg.ckpt_dir
        self.logger = logger or MetricsLogger()
        # data-parallel when the process group has more than one rank
        self.mesh = mesh_for_world(mesh_cfg)
        if self.mesh is not None:
            self.logger.log({"event": "mesh",
                             "devices": torch.distributed.get_world_size(),
                             "shape": dict(self.mesh.shape)})
        self.coordinator = is_coordinator()
        self.learner = DQNLearner(env_cfg, cfg, device=device, mesh=self.mesh)
        self.device = self.learner.device
        self.gen = torch.Generator().manual_seed(int(seed))

        # ---- initial weights: warm start or random
        epsilon0, episodes0 = 1.0, 0
        if cfg.init_model_path:
            path = self.workdir / cfg.init_model_path
            self.init_params = load_params_any(path)
            payload = load_checkpoint(path)
            epsilon0 = float(payload.get("epsilon", cfg.min_epsilon))
            episodes0 = int(payload.get("episode", 0))
        else:
            self.init_params = qnet_init(self.gen)

        self.params_a = qnet_copy(self.init_params)
        self._refresh_a_play()
        self.state = self.learner.init_state(
            self._seed(), self.init_params, epsilon=epsilon0,
            episodes=episodes0)

        # ---- opponent pool, loaded once (fault checkpoints included)
        self.pool: List[QNet] = load_pool(self.ckpt_dir, kind="qnet",
                                          limit=cfg.pool_max)
        self._pool_packs = FrozenPacks(self.device)
        self.env_params = self.learner.env_params
        self.match_fn = make_match_fn(self.env_params, PolicySpec(QNET, None),
                                      PolicySpec(QNET, None),
                                      device=self.device)
        self._autosaver = AsyncAutosaver()
        self.win_a_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.win_pool_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.records: List[GenerationRecord] = []
        self.reward_history: List[float] = []

        # ---- tier-0 restore: the full-state autosave, buffer included
        self.done_generations = 0
        self.current_generation = 0
        self._since_autosave = 0
        self._resumed_mid_generation = False
        latest = self.ckpt_dir / cfg.latest_checkpoint_filename
        if is_train_state_checkpoint(latest):
            try:
                self._restore_full_state(latest)
                self.logger.log({"event": "restore", "tier": 0,
                                 "path": str(latest)})
            except Exception as e:
                self.logger.log({"event": "restore_failed", "tier": 0,
                                 "error": str(e)})

    def _seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self.gen))

    # -- full-state autosave / restore --------------------------------------
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
                    "model_kind": "qnet"}
            flat_a = qnet_to_flat(self.params_a)
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
        noise = (qnet_sample_noise(torch.Generator(), like)
                 if self.cfg.selfplay.frozen_a_stale_noise else None)
        state, flat_a, gen, noise, meta = restore_full_state(
            path, self.learner.init_global_state(0, like), qnet_to_flat(like),
            self.gen, noise, device=self.device)
        self.state = self.learner.shard_state(state)
        self.params_a = qnet_from_flat(flat_a, like)
        self.gen = gen
        self.current_generation = int(meta.get("generation", 0))
        self.done_generations = int(meta.get("done_generations", 0))
        self._refresh_a_play(noise)
        # continue the interrupted generation with the restored B (run()
        # must not start a fresh one)
        self._resumed_mid_generation = (
            self.current_generation > self.done_generations)

    # -- helpers -----------------------------------------------------------
    def _refresh_a_play(self, noise=None) -> None:
        """The A that actually plays: with ``frozen_a_stale_noise``, one
        noise draw per A lifetime folded into its heads (the reference
        leaves A in train mode); else mu-greedy A. The draw is kept (and
        saved with the autosave) so a resumed run folds the same noise and
        an interrupted generation continues against a bit-identical A.
        A's gate packs go with the A they were made from."""
        self._a_packs = FrozenPacks(self.device)
        if self.cfg.selfplay.frozen_a_stale_noise:
            if noise is None:
                noise = qnet_sample_noise(self.gen, self.params_a)
            self._a_fold_noise = noise
            self.params_a_play = qnet_fold_noise(self.params_a, noise)
        else:
            self._a_fold_noise = None
            self.params_a_play = self.params_a

    def _learner_gate_net(self) -> Optional[GateNet]:
        """B's gate packs, gathered from the learner's flat parameters (the
        mirror only for the side-balanced gate); None on the match
        runner."""
        if not self.cfg.use_pallas_eval:
            return None
        return gate_net(self.state.params, self.learner.template,
                        mirror=self.cfg.selfplay.swap_sides_eval)

    def _eval_vs(self, opponents: List[QNet], n_games: int,
                 frozen: FrozenPacks, b: Optional[GateNet]) -> float:
        """B (the current learner; ``b`` its gate packs) vs a set of
        opponents: through the fused kernel, the quota split evenly over
        them, each packed once for as long as ``frozen`` holds it, or
        (``use_pallas_eval=false``) through the match runner, each game
        against a uniformly drawn member."""
        if not opponents:
            return 1.0
        cfg = self.cfg
        if cfg.use_pallas_eval:
            return self._fused_eval_vs(opponents, frozen, b, n_games)
        params_b = self.learner.params_b(self.state)
        n_opp = len(opponents)
        idx_opp = torch.randint(0, n_opp, (n_games,), generator=self.gen,
                                dtype=torch.int32)
        idx_b = torch.zeros((n_games,), dtype=torch.int32)
        if cfg.selfplay.swap_sides_eval:
            with trace.span("gate::opponent"):
                total, as_b, as_a = eval_win_rate_balanced(
                    self.match_fn, list(opponents), [params_b], idx_opp,
                    idx_b, self.gen, n_games)
            self.logger.log({"event": "eval_seats", "win_as_b": as_b,
                             "win_as_a": as_a})
            return total
        with trace.span("gate::opponent"):
            result = self.match_fn(list(opponents), [params_b], idx_opp,
                                   idx_b, generator=self.gen)
            return trace.readback(result.win_b.to(torch.float32).mean(),
                                  float)

    def _fused_eval_vs(self, opponents: List[QNet], frozen: FrozenPacks,
                       b: GateNet, n_games: int) -> float:
        cfg = self.cfg
        kw = dict(n_envs=min(cfg.num_envs, 8192),
                  tile_rows=min(cfg.pallas_tile_rows, cfg.num_envs, 8192),
                  device=self.device)
        if cfg.selfplay.swap_sides_eval:
            per = max(2, n_games // len(opponents))
            wins = w_b = w_a = 0.0
            total = 0
            for opp in opponents:
                with trace.span("gate::opponent"):
                    wr, as_b, as_a, eps = fused_win_rate_balanced(
                        self.env_params, frozen(opp), b, self.gen,
                        min_episodes=per, **kw)
                wins += wr * eps
                w_b += as_b * eps
                w_a += as_a * eps
                total += eps
            self.logger.log({"event": "eval_seats",
                             "win_as_b": w_b / max(total, 1),
                             "win_as_a": w_a / max(total, 1)})
            return wins / max(total, 1)
        per = max(1, n_games // len(opponents))
        wins = 0.0
        total = 0
        for opp in opponents:
            with trace.span("gate::opponent"):
                wr, eps = fused_win_rate(self.env_params, frozen(opp), b,
                                         self.gen, min_episodes=per, **kw)
            wins += wr * eps
            total += eps
        return wins / max(total, 1)

    def _save(self, name: str, generation: int) -> str:
        with trace.span("loop::checkpoint"):
            if not self.coordinator:   # rank 0 owns the checkpoint writes
                return str(self.ckpt_dir / name)
            st = self.state
            payload = {
                "params_b": qnet_to_dict(self.learner.params_b(st)),
                "params_a": qnet_to_dict(self.params_a),
                "opt_state": opt_state_to_leaves(st.opt_count, st.opt_mu,
                                                 st.opt_nu),
                "epsilon": float(st.epsilon),
                "episode": int(st.episodes),
                "generation": generation,
                "train_steps": int(st.train_steps),
                "model_kind": "qnet",
            }
            path = save_checkpoint(self.ckpt_dir / name, payload)
            cfg = self.cfg
            if cfg.keep_checkpoints > 0 or cfg.keep_fault_checkpoints > 0:
                deleted = apply_retention(
                    self.ckpt_dir, keep_promoted=cfg.keep_checkpoints,
                    keep_faults=cfg.keep_fault_checkpoints,
                    protect=[Path(cfg.init_model_path).name]
                    if cfg.init_model_path else None)
                if deleted:
                    self.logger.log({"event": "retention", "deleted": deleted})
            return str(path)

    def _train_block(self, episodes_target: int) -> None:
        """Train iterations until ``episodes_target`` more episodes
        complete, autosaving every ``save_latest_checkpoint_interval_steps``
        train steps."""
        sp = self.cfg.selfplay
        interval = self.cfg.save_latest_checkpoint_interval_steps
        goal = self.state.episodes + episodes_target
        watch = Stopwatch()
        with trace.span("loop::opponents"):
            stack, pool_size = stack_opponents(self.params_a_play, self.pool,
                                               len(self.pool))
            opp = self.learner.prepare_opponents(stack)
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
                        "event": "interval",
                        "episode": eps_now,
                        "win_vs_A": self.win_a_window.rate(),
                        "win_vs_pool": self.win_pool_window.rate(),
                        "epsilon": m.epsilon,
                        "loss": m.mean_loss,
                        "env_steps_per_s": env_steps / max(dt, 1e-9),
                        "buffer": m.buffer_size,
                    })
                    env_steps = 0
                    last_log_eps = eps_now

    def _try(self, gen: int, tries: int) -> bool:
        """One try of generation ``gen``: its train block, its gate and
        the decision. Returns True when the generation is done (promoted,
        or a fault after the last try)."""
        sp = self.cfg.selfplay
        self.logger.log({"event": "try", "generation": gen, "try": tries})
        self._train_block(sp.episodes_per_generation)
        with trace.timed_span("loop::gate") as gate:
            b = self._learner_gate_net()
            w_a = self._eval_vs([self.params_a_play], sp.eval_episodes,
                                self._a_packs, b)
            w_pool = self._eval_vs(self.pool, sp.eval_episodes,
                                   self._pool_packs, b)
            w_a, w_pool = broadcast_values([w_a, w_pool], self.mesh,
                                           self.device)
        self.logger.log({"event": "eval", "generation": gen,
                         "win_vs_A": w_a, "win_vs_pool": w_pool,
                         "epsilon": self.state.epsilon,
                         "eval_s": gate.seconds})
        if (w_a >= sp.curr_win_threshold
                and w_pool >= sp.pool_win_threshold):
            self.params_a = self.learner.params_b(self.state)
            self._refresh_a_play()
            name = f"model{self.cfg.model_id}-{gen}"
            path = self._save(name, gen)
            self.records.append(GenerationRecord(
                gen, True, tries, w_a, w_pool, self.state.episodes, path))
            self.logger.log({"event": "promoted", "generation": gen,
                             "checkpoint": path})
            self.done_generations += 1
            return True
        if tries >= sp.max_retries_for_generation:
            name = f"model{self.cfg.model_id}-{gen}_fault"
            path = self._save(name, gen)
            self.records.append(GenerationRecord(
                gen, False, tries, w_a, w_pool, self.state.episodes, path))
            self.logger.log({"event": "fault", "generation": gen,
                             "checkpoint": path})
            with trace.span("loop::reset"):
                self.state = self.learner.reset_learner(
                    self.state, self.init_params)
            self.done_generations += 1
            return True
        return False

    def run(self) -> List[GenerationRecord]:
        sp = self.cfg.selfplay
        while self.done_generations < sp.max_generations:
            if self._resumed_mid_generation:
                # continue the restored generation's label; B's state
                # (buffer, optimizer, epsilon) came from the autosave
                self._resumed_mid_generation = False
            else:
                self.current_generation += 1
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
