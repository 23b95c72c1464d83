"""Iterative self-play with win-rate-gated generation promotion (QNet);
port of ``pingpong_tpu/selfplay/loop.py``, on ``selfplay/generations.py``.
This family starts from warm (``init_model_path``) or random weights and
restores the autosave as tier 0; loads its pool once, fault checkpoints
included; with ``frozen_a_stale_noise`` folds one noise draw into A for
A's lifetime (autosaved, so a resumed run plays the same A); keeps the
optimizer's state in its checkpoints; trains B on across generations and
restarts it from the initial weights after a fault. Its gates run kernel 1
(B gathered from its flat parameters once a gate, A and the pool packed
once a lifetime: ``gate::packs``, ``gate::pack_hits``) or the match runner,
each game against a member drawn from the loop's generator.
"""

from __future__ import annotations

import torch

from pingpong_tpu_torch.checkpoint.serialize import (
    opt_state_to_leaves,
    qnet_to_dict,
)
from pingpong_tpu_torch.checkpoint.store import load_checkpoint
from pingpong_tpu_torch.evaluation.fast_eval import (
    FrozenPacks,
    fused_win_rate,
    fused_win_rate_balanced,
    gate_net,
)
from pingpong_tpu_torch.evaluation.match import QNET
from pingpong_tpu_torch.models.qnet import (
    qnet_copy,
    qnet_fold_noise,
    qnet_from_flat,
    qnet_init,
    qnet_sample_noise,
    qnet_to_flat,
)
from pingpong_tpu_torch.selfplay.generations import (  # noqa: F401
    Family,
    GenerationRecord,                   # re-exported
    SelfPlayLoop,
)
from pingpong_tpu_torch.selfplay.pool import load_params_any, load_pool
from pingpong_tpu_torch.train.dqn import DQNLearner


class QNetSelfPlay(SelfPlayLoop):
    """The generation loop of one QNet run; ``run()`` executes it."""

    family = Family("qnet", DQNLearner, QNET, qnet_to_flat, qnet_from_flat,
                    qnet_to_dict, (fused_win_rate, fused_win_rate_balanced),
                    "model{cfg.model_id}-{gen}", "ckpt_dir", "init_model_path")

    def _start(self) -> None:
        cfg = self.cfg
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
        self.pool = load_pool(self.ckpt_dir, kind="qnet", limit=cfg.pool_max)
        self._pool_packs = FrozenPacks(self.device)
        self._resume(tier=0)

    def _refresh_a_play(self, noise=None) -> None:
        """The A that plays: with ``frozen_a_stale_noise`` one noise draw
        per A lifetime folded into its heads (the reference leaves A in
        train mode), kept for the autosave; else mu-greedy A. A's gate
        packs go with the A they were made from."""
        self._a_packs = FrozenPacks(self.device)
        if self.cfg.selfplay.frozen_a_stale_noise:
            if noise is None:
                noise = qnet_sample_noise(self.gen, self.params_a)
            self._a_fold_noise = noise
            self.params_a_play = qnet_fold_noise(self.params_a, noise)
        else:
            self._a_fold_noise = None
            self.params_a_play = self.params_a

    def _noise_like(self, like):
        stale = self.cfg.selfplay.frozen_a_stale_noise
        return qnet_sample_noise(torch.Generator(), like) if stale else None

    def _restored(self, params_a, noise) -> None:
        self.params_a = params_a
        self._refresh_a_play(noise)

    def _promote(self) -> None:
        self.params_a = self.learner.params_b(self.state)
        self._refresh_a_play()

    def _fault_params(self):
        return self.init_params

    def _new_generation(self) -> None:
        pass                            # B trains on across generations

    def _fields(self, record: str, metrics=None) -> dict:
        st = self.state
        if record == "checkpoint":
            return {"opt_state": opt_state_to_leaves(st.opt_count, st.opt_mu,
                                                     st.opt_nu)}
        if record == "eval":
            return {"epsilon": st.epsilon}
        return {"buffer": metrics.buffer_size}

    def _fused_gate(self):
        """B gathered from the learner's flat parameters."""
        cfg = self.cfg
        if not cfg.use_pallas_eval:
            return None
        b = gate_net(self.state.params, self.learner.template,
                     mirror=cfg.selfplay.swap_sides_eval)
        n = min(cfg.num_envs, 8192)
        return b, dict(n_envs=n, tile_rows=min(cfg.pallas_tile_rows, n),
                       device=self.device)

    def _gate_quota(self, n_games: int, n_opponents: int) -> int:
        return max(2 if self.cfg.selfplay.swap_sides_eval else 1,
                   n_games // n_opponents)

    def _match_opponents(self, n_opponents: int,
                         n_games: int) -> torch.Tensor:
        return torch.randint(0, n_opponents, (n_games,), generator=self.gen,
                             dtype=torch.int32)
