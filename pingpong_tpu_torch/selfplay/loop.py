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
  checkpoint directory, fault checkpoints included.

Not ported yet (ROADMAP.md): the full-train-state autosave and its
tier-0 resume, checkpoint retention, and the match-runner gates
(``use_pallas_eval=false``). Configurations that ask for them raise.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import torch

from pingpong_tpu_torch.checkpoint.serialize import (
    opt_state_to_leaves,
    qnet_to_dict,
)
from pingpong_tpu_torch.checkpoint.store import load_checkpoint, save_checkpoint
from pingpong_tpu_torch.config.schema import DQNConfig, EnvConfig
from pingpong_tpu_torch.evaluation.fast_eval import (
    fused_win_rate,
    fused_win_rate_balanced,
)
from pingpong_tpu_torch.models.qnet import (
    QNet,
    qnet_copy,
    qnet_fold_noise,
    qnet_init,
    qnet_sample_noise,
)
from pingpong_tpu_torch.selfplay.pool import load_params_any, load_pool
from pingpong_tpu_torch.train.dqn import DQNLearner, stack_opponents
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


def check_supported(cfg: DQNConfig) -> None:
    """Raise for options of the JAX trainer this port does not run yet."""
    if cfg.save_latest_checkpoint_interval_steps > 0:
        raise ValueError(
            "full-state autosave is not ported to PyTorch yet; run with "
            "dqn.save_latest_checkpoint_interval_steps=0")
    if cfg.keep_checkpoints > 0 or cfg.keep_fault_checkpoints > 0:
        raise ValueError(
            "checkpoint retention is not ported to PyTorch yet; run with "
            "dqn.keep_checkpoints=0 dqn.keep_fault_checkpoints=0")
    if not cfg.use_pallas_eval:
        raise ValueError(
            "the match-runner gates are not ported to PyTorch yet; run "
            "with dqn.use_pallas_eval=true")


class QNetSelfPlay:
    """The generation loop of one run; ``run()`` executes it."""

    def __init__(self, env_cfg: EnvConfig, cfg: DQNConfig,
                 workdir: str = ".", seed: int = 0,
                 logger: Optional[MetricsLogger] = None, device="cuda"):
        check_supported(cfg)
        self.env_cfg = env_cfg
        self.cfg = cfg
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / cfg.ckpt_dir
        self.logger = logger or MetricsLogger()
        self.learner = DQNLearner(env_cfg, cfg, device=device)
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
        self.env_params = self.learner.env_params
        self.win_a_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.win_pool_window = WinRateWindow(cfg.selfplay.win_rate_interval)
        self.records: List[GenerationRecord] = []
        self.reward_history: List[float] = []
        self.done_generations = 0
        self.current_generation = 0

    def _seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self.gen))

    def _refresh_a_play(self) -> None:
        """The A that actually plays: with ``frozen_a_stale_noise``, one
        noise draw per A lifetime folded into its heads (the reference
        leaves A in train mode); else mu-greedy A."""
        if self.cfg.selfplay.frozen_a_stale_noise:
            self.params_a_play = qnet_fold_noise(
                self.params_a, qnet_sample_noise(self.gen, self.params_a))
        else:
            self.params_a_play = self.params_a

    def _eval_vs(self, opponents: List[QNet], n_games: int) -> float:
        """B (the current learner) vs a set of opponents, the quota split
        evenly over them."""
        if not opponents:
            return 1.0
        cfg = self.cfg
        kw = dict(n_envs=min(cfg.num_envs, 8192),
                  tile_rows=min(cfg.pallas_tile_rows, cfg.num_envs, 8192),
                  device=self.device)
        params_b = self.learner.params_b(self.state)
        if cfg.selfplay.swap_sides_eval:
            per = max(2, n_games // len(opponents))
            wins = w_b = w_a = 0.0
            total = 0
            for opp in opponents:
                wr, as_b, as_a, eps = fused_win_rate_balanced(
                    self.env_params, opp, params_b, self.gen,
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
            wr, eps = fused_win_rate(self.env_params, opp, params_b,
                                     self.gen, min_episodes=per, **kw)
            wins += wr * eps
            total += eps
        return wins / max(total, 1)

    def _save(self, name: str, generation: int) -> str:
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
        return str(save_checkpoint(self.ckpt_dir / name, payload))

    def _train_block(self, episodes_target: int) -> None:
        """Train iterations until ``episodes_target`` more episodes
        complete."""
        sp = self.cfg.selfplay
        goal = self.state.episodes + episodes_target
        watch = Stopwatch()
        stack, pool_size = stack_opponents(self.params_a_play, self.pool,
                                           len(self.pool))
        opp = self.learner.prepare_opponents(stack)
        env_steps = 0
        last_log_eps = self.state.episodes
        while self.state.episodes < goal:
            self.state, m = self.learner.train_iteration(self.state, opp,
                                                         pool_size)
            env_steps += m.env_steps
            self.win_a_window.add(m.games_vs_a, m.wins_vs_a)
            self.win_pool_window.add(m.games_vs_pool, m.wins_vs_pool)
            if m.episodes > 0:
                self.reward_history.append(m.episode_return_sum / m.episodes)
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

    def run(self) -> List[GenerationRecord]:
        sp = self.cfg.selfplay
        while self.done_generations < sp.max_generations:
            self.current_generation += 1
            gen = self.current_generation
            tries = 0
            while True:
                tries += 1
                self.logger.log({"event": "try", "generation": gen,
                                 "try": tries})
                self._train_block(sp.episodes_per_generation)
                w_a = self._eval_vs([self.params_a_play], sp.eval_episodes)
                w_pool = self._eval_vs(self.pool, sp.eval_episodes)
                self.logger.log({"event": "eval", "generation": gen,
                                 "win_vs_A": w_a, "win_vs_pool": w_pool,
                                 "epsilon": self.state.epsilon})
                if (w_a >= sp.curr_win_threshold
                        and w_pool >= sp.pool_win_threshold):
                    self.params_a = self.learner.params_b(self.state)
                    self._refresh_a_play()
                    name = f"model{self.cfg.model_id}-{gen}"
                    path = self._save(name, gen)
                    self.records.append(GenerationRecord(
                        gen, True, tries, w_a, w_pool, self.state.episodes,
                        path))
                    self.logger.log({"event": "promoted", "generation": gen,
                                     "checkpoint": path})
                    self.done_generations += 1
                    break
                if tries >= sp.max_retries_for_generation:
                    name = f"model{self.cfg.model_id}-{gen}_fault"
                    path = self._save(name, gen)
                    self.records.append(GenerationRecord(
                        gen, False, tries, w_a, w_pool, self.state.episodes,
                        path))
                    self.logger.log({"event": "fault", "generation": gen,
                                     "checkpoint": path})
                    self.state = self.learner.reset_learner(
                        self.state, self.init_params)
                    self.done_generations += 1
                    break
        return self.records
