"""Iterative self-play with generation promotion for the DRQN (LSTM) agent;
port of ``pingpong_tpu/selfplay/loop_rnn.py``, on
``selfplay/generations.py``. This family loads its pool without fault
checkpoints and APPENDS each promotion to it (up to ``pool_max``); restores
in three tiers: (1) the full-state autosave (the sequence ring, env and
hidden states, optimizer, counters, A, the loop's generator), (2) else the
warm start ``init_model_path_rnn`` (key chain params_a -> params_b ->
params), (3) else random init; starts each new generation's B from A with
a fresh optimizer, target and per-generation epsilon, and resets B from A
after a fault (ring kept). Its gates run kernel 3 (``use_pallas_eval`` and
a net of its architecture; both nets packed at every seat) or the match
runner, as the JAX loop decides. The learner picks its route from the
config (``train/drqn.py``); every DRQN option of the JAX trainer runs on
one device or on a mesh.
"""

from __future__ import annotations

import torch

from pingpong_tpu_torch.checkpoint.serialize import (
    params_from_dict,
    qnet_rnn_to_dict,
)
from pingpong_tpu_torch.checkpoint.store import is_checkpoint, load_checkpoint
from pingpong_tpu_torch.evaluation.fast_eval import (
    rnn_win_rate,
    rnn_win_rate_balanced,
)
from pingpong_tpu_torch.evaluation.match import RNN
from pingpong_tpu_torch.models.qnet_rnn import (
    QNetRNN,
    qnet_rnn_copy,
    qnet_rnn_from_flat,
    qnet_rnn_to_flat,
)
from pingpong_tpu_torch.selfplay.generations import Family, SelfPlayLoop
from pingpong_tpu_torch.selfplay.pool import load_pool
from pingpong_tpu_torch.train.drqn import DRQNLearner, kernel_architecture


class DRQNSelfPlay(SelfPlayLoop):
    """The generation loop of one DRQN run; ``run()`` executes it."""

    family = Family("qnet_rnn", DRQNLearner, RNN, qnet_rnn_to_flat,
                    qnet_rnn_from_flat, qnet_rnn_to_dict,
                    (rnn_win_rate, rnn_win_rate_balanced),
                    "{cfg.model_id_prefix}{gen}", "ckpt_dir_rnn",
                    "init_model_path_rnn")

    @property
    def params_a_play(self) -> QNetRNN:     # the A that plays: A itself
        return self.params_a

    def _start(self) -> None:
        cfg = self.cfg
        self.pool = load_pool(self.ckpt_dir, kind="qnet_rnn",
                              skip_fault=True, limit=cfg.pool_max)
        if self._resume(tier=1):
            return
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
        self.params_a = self.init_params = params
        self.state = self.learner.init_state(self._seed(), params)

    def _noise_like(self, like):
        return None

    def _restored(self, params_a, noise) -> None:
        self.params_a = self.init_params = params_a

    def _promote(self) -> None:
        self.params_a = self.learner.params_b(self.state).cpu()
        if len(self.pool) < self.cfg.pool_max:
            self.pool.append(qnet_rnn_copy(self.params_a))

    def _fault_params(self) -> QNetRNN:
        return self.params_a            # fresh B from A, ring kept

    def _new_generation(self) -> None:
        if self.current_generation > 1:
            self.state = self.learner.new_generation(self.state,
                                                     self.params_a)

    def _fields(self, record: str, metrics=None) -> dict:
        if record == "interval":
            return {"buffer_episodes": metrics.buffer_episodes}
        return {}

    def _fused_gate(self):
        """The match runner for a net kernel 3 does not take
        (``pingpong_tpu/selfplay/loop_rnn.py:196``)."""
        cfg = self.cfg
        if not (cfg.use_pallas_eval and kernel_architecture(cfg)):
            return None
        n = min(cfg.num_envs, 4096)
        return self.learner.params_b(self.state), dict(
            n_envs=n, tile_rows=min(cfg.pallas_tile_rows, n),
            max_episode_steps=cfg.max_episode_steps, device=self.device)

    def _gate_quota(self, n_games: int, n_opponents: int) -> int:
        return max(2, n_games // n_opponents)

    def _match_opponents(self, n_opponents: int,
                         n_games: int) -> torch.Tensor:
        per = max(1, n_games // n_opponents)
        members = torch.arange(n_opponents, dtype=torch.int32)
        return (members.repeat(per) if self.cfg.selfplay.swap_sides_eval
                else members.repeat_interleave(per))
