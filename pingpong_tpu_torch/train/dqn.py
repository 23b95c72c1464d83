"""DQN actor-learner: fused rollout chunk + PER push + fused update block.

Port of the single-device fused path of ``pingpong_tpu/train/dqn.py``
(``_rollout_pallas``, ``_update_pallas``, ``_train_iteration``). One
``train_iteration``:

1. re-binds opponents of the envs whose episode ended in the last chunk
   (``opponent_binding``: "bucketed" fixed contiguous buckets, or
   "sorted" iid draws with envs sorted by slot), then runs the whole
   rollout chunk in one kernel (``ops/actor_rollout.py``); epsilon decays
   once per chunk by ``decay ** episodes_done``;
2. pushes the time-major flattened chunk into PER (``replay/per.py``);
3. runs the K Double-DQN updates in one kernel (``ops/dqn_update.py``)
   when the buffer holds at least a batch, then replays the emitted
   ``(idx, new_p)`` stream into the raw priorities, last writer wins.

The train state is a mutable object updated in place. Parameters, target
and the Adam moments are flat vectors in ``ravel_pytree`` order; the
optimizer state ``[count, mu, nu]`` is exactly the JAX learner's flat
``optax.adam`` state. Host-side randomness (rollout seeds, update
uniforms and noise, opponent draws, env resets) comes from the state's
CPU ``torch.Generator``, so a CPU run and a card run of the same seed draw
the same numbers.

Not ported yet (ROADMAP.md): the XLA-scan rollout (``use_pallas_rollout=
False``), the row-layout update path, and the multi-chip learners.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pingpong_tpu_torch.config.schema import DQNConfig, EnvConfig
from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    env_params_from_config,
    reset,
)
from pingpong_tpu_torch.models.qnet import (
    QNet,
    qnet_copy,
    qnet_from_flat,
    qnet_init,
    qnet_sample_noise,
    qnet_to_flat,
)
from pingpong_tpu_torch.ops.actor_rollout import (
    PackedQNet,
    actor_rollout,
    pack_qnet,
)
from pingpong_tpu_torch.ops.dqn_update import (
    dqn_update_block,
    pack_dqn_noise,
    supports_fused_update,
)
from pingpong_tpu_torch.replay.per import (
    PERBuffer,
    Transition,
    last_writer_wins,
    per_init,
    per_push,
)
from pingpong_tpu_torch.utils.device import resolve_device

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class DQNTrainState:
    generator: torch.Generator   # host RNG stream (the JAX state's key)
    params: torch.Tensor         # (P,) learner B, raveled
    target: torch.Tensor         # (P,)
    opt_count: int               # Adam step count
    opt_mu: torch.Tensor         # (P,)
    opt_nu: torch.Tensor         # (P,)
    buffer: PERBuffer
    env_state: EnvState          # batched (num_envs,)
    opp_idx: torch.Tensor        # (num_envs,) i32; 0 = frozen A, k>0 = pool
    ep_return: torch.Tensor      # (num_envs,) f32 running return of B
    ended: torch.Tensor          # (num_envs,) bool: episode ended last chunk
    epsilon: float               # float32-valued
    train_steps: int
    frame_idx: int               # PER beta-anneal clock
    episodes: int


class DQNMetrics(NamedTuple):
    episodes: int
    games_vs_a: int
    wins_vs_a: int
    games_vs_pool: int
    wins_vs_pool: int
    episode_return_sum: float
    mean_loss: float
    updates_run: int
    epsilon: float
    train_steps: int
    buffer_size: int
    env_steps: int


class PreparedOpponents(NamedTuple):
    """An opponent stack packed once per generation block (mirror-folded
    for player A's seat). ``shared_trunk``: every slot carries slot 0's
    feature trunk bit for bit (heads-only lineages), checked on the
    host."""

    packed: PackedQNet
    n_slots: int
    shared_trunk: bool


def bucket_opp_idx(num_envs: int, ratio: float, pool_size: int,
                   phase: Optional[int] = None, device="cpu") -> torch.Tensor:
    """Contiguous bucket binding (``opponent_binding="bucketed"``): the
    first ``round((1-ratio)*B)`` envs bind to A (slot 0), the rest split
    evenly over the ``pool_size`` members. When the pool span has fewer
    envs than members, the member offset rotates by a uint32 hash of
    ``phase`` so every member is reached over successive chunks."""
    idx = torch.arange(num_envs, dtype=torch.int64, device=device)
    boundary = int(round((1.0 - ratio) * num_envs))
    span = max(num_envs - boundary, 1)
    m = ((idx - boundary) * pool_size) // span
    if phase is not None and span < pool_size:
        ps = max(pool_size, 1)
        h = phase & _M32
        h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
        h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
        h = (h ^ (h >> 16)) & 0x7FFFFFFF
        m = (m + h % ps) % ps
    out = torch.where((idx < boundary) | (pool_size == 0),
                      torch.zeros_like(m), m + 1)
    return out.to(torch.int32)


def stack_opponents(params_a: QNet, pool: Sequence[QNet],
                    pool_max: int) -> Tuple[List[QNet], int]:
    """``[A, pool..., A padding]`` of length ``1 + pool_max``; returns
    (stack, pool_size)."""
    if len(pool) > pool_max:
        raise ValueError(f"pool of {len(pool)} exceeds pool_max={pool_max}")
    members = [params_a] + list(pool) + [params_a] * (pool_max - len(pool))
    return members, len(pool)


class DQNLearner:
    """Binds (EnvConfig, DQNConfig) to one device and runs train
    iterations on a :class:`DQNTrainState`."""

    def __init__(self, env_cfg: EnvConfig, cfg: DQNConfig, device="cuda"):
        if cfg.rollout_length * cfg.num_envs > cfg.memory_size:
            raise ValueError(
                "one rollout chunk may not exceed replay capacity: "
                f"{cfg.rollout_length}*{cfg.num_envs} > {cfg.memory_size}")
        if not (cfg.use_pallas_rollout and cfg.use_pallas_update):
            raise ValueError(
                "the PyTorch port runs only the fused rollout and update "
                "kernels: dqn.use_pallas_rollout and dqn.use_pallas_update "
                "must be true")
        if not supports_fused_update(cfg):
            raise ValueError(
                "the update kernel needs batch_size % 128 == 0 and <= 512, "
                "memory_size a multiple of 128^2 and <= 2^20, and one "
                "rollout chunk (num_envs*rollout_length, a multiple of "
                "128) dividing memory_size; the row-layout update path is "
                "not ported yet")
        if cfg.opponent_binding not in ("bucketed", "sorted"):
            raise ValueError(
                f"unknown opponent_binding={cfg.opponent_binding!r}")
        if cfg.learner_sharding not in ("auto", "replicated", "sharded"):
            raise ValueError(
                f"unknown learner_sharding={cfg.learner_sharding!r}")
        self.env_cfg = env_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.env_params: EnvParams = env_params_from_config(env_cfg)
        # shapes (and device) of the learner's QNet; values unused
        self.template = qnet_init(torch.Generator().manual_seed(0),
                                  device=self.device)

    # -- parameters --------------------------------------------------------
    def params_b(self, state: DQNTrainState) -> QNet:
        """Learner B as a QNet (a copy of the flat vector)."""
        return qnet_from_flat(state.params, self.template)

    def _flat(self, params: QNet) -> torch.Tensor:
        return qnet_to_flat(params).to(self.device, torch.float32).clone()

    # -- state init --------------------------------------------------------
    def init_state(self, seed: int, params_b: Optional[QNet] = None,
                   epsilon: float = 1.0, episodes: int = 0) -> DQNTrainState:
        gen = torch.Generator().manual_seed(int(seed))
        if params_b is None:
            params_b = qnet_init(gen)
        flat = self._flat(params_b)
        n = self.cfg.num_envs
        dev = self.device
        return DQNTrainState(
            generator=gen,
            params=flat,
            target=flat.clone(),
            opt_count=0,
            opt_mu=torch.zeros_like(flat),
            opt_nu=torch.zeros_like(flat),
            buffer=per_init(self.cfg.memory_size, device=dev),
            env_state=reset(self.env_params, n, gen, dev),
            opp_idx=torch.zeros((n,), dtype=torch.int32, device=dev),
            ep_return=torch.zeros((n,), dtype=torch.float32, device=dev),
            ended=torch.zeros((n,), dtype=torch.bool, device=dev),
            epsilon=float(np.float32(epsilon)),
            train_steps=0,
            frame_idx=0,
            episodes=int(episodes),
        )

    def reset_learner(self, state: DQNTrainState,
                      params_b: QNet) -> DQNTrainState:
        """The reference's ``reset_B()``: fresh learner weights, target,
        optimizer and buffer; epsilon back to 1."""
        flat = self._flat(params_b)
        state.params = flat
        state.target = flat.clone()
        state.opt_count = 0
        state.opt_mu = torch.zeros_like(flat)
        state.opt_nu = torch.zeros_like(flat)
        state.buffer = per_init(self.cfg.memory_size, device=self.device)
        state.epsilon = 1.0
        state.train_steps = 0
        state.frame_idx = 0
        return state

    def prepare_opponents(self, opp_stack: Sequence[QNet]) -> PreparedOpponents:
        """Pack an opponent stack once per generation block and detect the
        shared-trunk invariant (exact equality of every slot's feature
        weights with slot 0's)."""
        members = [qnet_copy(p).to(self.device) for p in opp_stack]
        shared = len(members) > 1 and all(
            torch.equal(getattr(p, layer).get_parameter(f),
                        getattr(members[0], layer).get_parameter(f))
            for p in members[1:] for layer in ("feat1", "feat2")
            for f in ("w", "b"))
        return PreparedOpponents(packed=pack_qnet(members, mirror=True),
                                 n_slots=len(members), shared_trunk=shared)

    # -- rollout -------------------------------------------------------------
    def _rollout(self, state: DQNTrainState, opp: PreparedOpponents,
                 pool_size: int, seed: Optional[int] = None):
        """One fused rollout chunk and its PER push (in place on
        ``state``). Returns ``(stat_counts (5,) ints, ret_sum)``."""
        cfg = self.cfg
        n = cfg.num_envs
        dev = self.device
        gen = state.generator
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        env_state, ep_return = state.env_state, state.ep_return
        ratio = cfg.selfplay.opponent_pool_ratio
        if opp.n_slots == 1:
            opp_idx = state.opp_idx
        elif cfg.opponent_binding == "bucketed":
            target = bucket_opp_idx(n, ratio, pool_size,
                                    phase=state.episodes, device=dev)
            opp_idx = torch.where(state.ended, target, state.opp_idx)
        else:
            use_pool = (torch.rand((n,), generator=gen) < ratio) & (
                pool_size > 0)
            pick = torch.randint(0, max(pool_size, 1), (n,), generator=gen,
                                 dtype=torch.int32)
            draw = torch.where(use_pool, pick + 1, 0).to(dev, torch.int32)
            opp_idx = torch.where(state.ended, draw, state.opp_idx)
            perm = torch.sort(opp_idx, stable=True).indices
            opp_idx = opp_idx[perm]
            env_state = EnvState(*(x[perm] for x in env_state))
            ep_return = ep_return[perm]

        tile = min(cfg.pallas_tile_rows, n)
        lw = pack_qnet(qnet_from_flat(state.params, self.template))
        (new_env, new_opp, new_ret, tr, counts, ret_sum,
         ended) = actor_rollout(
            self.env_params, env_state, opp_idx, ep_return, lw, opp.packed,
            seed=seed, epsilon=state.epsilon, steps=cfg.rollout_length,
            max_episode_steps=self.env_cfg.max_episode_steps,
            tile_rows=tile, member_shared_trunk=opp.shared_trunk)
        counts = [int(c) for c in counts.tolist()]
        n_done = counts[0] + counts[2]
        state.epsilon = float(max(
            np.float32(cfg.min_epsilon),
            np.float32(state.epsilon)
            * np.float32(cfg.epsilon_decay) ** np.float32(n_done)))
        state.env_state = new_env
        state.opp_idx = new_opp
        state.ep_return = new_ret
        state.ended = ended
        state.episodes += n_done
        flat = Transition(
            obs=tr["obs"].reshape(-1, 7), action=tr["action"].reshape(-1),
            reward=tr["reward"].reshape(-1),
            next_obs=tr["next_obs"].reshape(-1, 7),
            done=tr["done"].reshape(-1))
        per_push(state.buffer, flat, cfg.per_alpha)
        return counts, float(ret_sum)

    # -- update --------------------------------------------------------------
    def _update(self, state: DQNTrainState, u01=None, noise=None):
        """K fused updates (in place on ``state``) when the buffer holds at
        least a batch. ``u01 (K, bs)`` and ``noise (K, 260)`` are drawn
        from the state's generator unless given. Returns ``(mean_loss,
        updates_run)``."""
        cfg = self.cfg
        bs, K = cfg.batch_size, cfg.updates_per_iteration
        gen = state.generator
        if noise is None:
            noise = pack_dqn_noise(
                qnet_sample_noise(gen, self.template, batch=(K,)))
        if u01 is None:
            u01 = torch.rand((K, bs), generator=gen)
        buf = state.buffer
        if buf.size < bs:
            return 0.0, 0
        newp, idx, losses = dqn_update_block(
            train_steps=state.train_steps, adam_count=state.opt_count,
            frame_idx=state.frame_idx, size=buf.size,
            u01=u01.to(self.device).contiguous(),
            noise=noise.to(self.device).contiguous(),
            p_alpha=buf.p_alpha, chunk_sums=buf.chunk_sums,
            params=state.params, target=state.target, m=state.opt_mu,
            v=state.opt_nu, data=buf.data, K=K, bs=bs, lr=cfg.lr,
            gamma=cfg.gamma, interval=cfg.target_update_interval,
            tau=cfg.target_tau, alpha=cfg.per_alpha, per_eps=cfg.per_eps,
            beta_start=cfg.per_beta_start, beta_frames=cfg.per_beta_frames,
            heads_only=cfg.train_heads_only)
        slots, vals = last_writer_wins(idx.reshape(-1).long(),
                                       newp.reshape(-1))
        buf.prios[slots] = vals
        state.train_steps += K
        state.opt_count += K
        state.frame_idx += K
        return float(losses.sum()) / K, K

    # -- one full iteration ------------------------------------------------
    def train_iteration(self, state: DQNTrainState, opp: PreparedOpponents,
                        pool_size: int, *, seed: Optional[int] = None,
                        u01=None, noise=None):
        """One rollout chunk, its push and one update block. ``seed``,
        ``u01`` and ``noise`` replace the state generator's draws (the
        tests inject the JAX side's)."""
        ep_before = state.episodes
        counts, ret_sum = self._rollout(state, opp, pool_size, seed=seed)
        mean_loss, n_ran = self._update(state, u01=u01, noise=noise)
        metrics = DQNMetrics(
            episodes=state.episodes - ep_before,
            games_vs_a=counts[0], wins_vs_a=counts[1],
            games_vs_pool=counts[2], wins_vs_pool=counts[3],
            episode_return_sum=ret_sum, mean_loss=mean_loss,
            updates_run=n_ran, epsilon=state.epsilon,
            train_steps=state.train_steps, buffer_size=state.buffer.size,
            env_steps=self.cfg.rollout_length * self.cfg.num_envs,
        )
        return state, metrics
