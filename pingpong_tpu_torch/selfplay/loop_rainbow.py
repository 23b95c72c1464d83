"""Iterative self-play of Rainbow's agent (``dqn.agent: rainbow``), on
``selfplay/generations.py``: the QNet loop's ladder with Rainbow's net and
learner (``train/rainbow.py``). It starts from warm (``init_model_path``, a
Rainbow checkpoint) or random weights, restores the autosave as tier 0,
loads its pool of Rainbow checkpoints once, fault checkpoints included,
keeps the optimizer's state in its checkpoints, trains B on across
generations and restarts it from the initial weights after a fault. A
plays mu-greedy. Its gates run the match runner (kernel 1 computes only the
QNet), each game against a member drawn from the loop's generator.
"""

from __future__ import annotations

import torch

from pingpong_tpu_torch.checkpoint.serialize import (
    opt_state_to_leaves,
    rainbow_to_dict,
)
from pingpong_tpu_torch.evaluation.match import RAINBOW
from pingpong_tpu_torch.models.rainbow import (
    rainbow_copy,
    rainbow_from_config,
    rainbow_from_flat,
    rainbow_to_flat,
)
from pingpong_tpu_torch.selfplay.generations import Family, SelfPlayLoop
from pingpong_tpu_torch.selfplay.pool import load_params_any, load_pool
from pingpong_tpu_torch.train.rainbow import RainbowLearner


class RainbowSelfPlay(SelfPlayLoop):
    """The generation loop of one Rainbow run; ``run()`` executes it."""

    family = Family("rainbow", RainbowLearner, RAINBOW, rainbow_to_flat,
                    rainbow_from_flat, rainbow_to_dict, (None, None),
                    "rainbow{cfg.model_id}-{gen}", "ckpt_dir",
                    "init_model_path")

    def _start(self) -> None:
        cfg = self.cfg
        if cfg.init_model_path:
            self.init_params = load_params_any(
                self.workdir / cfg.init_model_path)
        else:
            self.init_params = rainbow_from_config(self.gen, cfg)
        self.params_a = rainbow_copy(self.init_params)
        self.params_a_play = self.params_a
        self.state = self.learner.init_state(self._seed(), self.init_params)
        self.pool = load_pool(self.ckpt_dir, kind="rainbow",
                              limit=cfg.pool_max)
        self._resume(tier=0)

    def _noise_like(self, like):
        return None

    def _restored(self, params_a, noise) -> None:
        self.params_a = self.params_a_play = params_a

    def _promote(self) -> None:
        self.params_a = self.params_a_play = self.learner.params_b(self.state)

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
        return None                     # the match runner

    def _gate_quota(self, n_games: int, n_opponents: int) -> int:
        return max(1, n_games // n_opponents)

    def _match_opponents(self, n_opponents: int,
                         n_games: int) -> torch.Tensor:
        return torch.randint(0, n_opponents, (n_games,), generator=self.gen,
                             dtype=torch.int32)
