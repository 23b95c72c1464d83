"""DRQN (recurrent DQN) actor-learner: fused recurrent rollout chunk +
sequence-ring push + fused update block.

Port of the single-device fused path of ``pingpong_tpu/train/drqn.py``
(``_rollout_pallas``, ``_update_pallas``, ``_train_iteration``). One
``train_iteration``:

1. re-binds the opponents of the envs whose episode ended in the last
   chunk to their contiguous bucket (``opponent_binding="bucketed"``) and
   zeroes the opponent LSTM stream of every env that ended (a freshly
   bound member starts from fresh memory), then runs the whole rollout
   chunk in one kernel (``ops/recurrent_rollout.py``); epsilon decays once
   per chunk by ``decay ** episodes_done``;
2. pushes the chunk into the per-env sequence ring
   (``replay/sequence.py``);
3. runs the K DRQN updates in one kernel (``ops/drqn_update.py``) once
   the ring has admitted more than ``batch_size *
   min_episodes_for_training_start`` episodes (strictly greater, the
   reference's gate).

The train state is a mutable object updated in place. Parameters, target
and the Adam moments are flat vectors in ``ravel_pytree`` order; the
optimizer state ``[count, mu, nu]`` is the JAX learner's optax
``chain(clip_by_global_norm, adam)`` state on the raveled vector. Both
LSTM streams travel as one ``(4H, num_envs)`` block ``[h_b; c_b; h_opp;
c_opp]``. Host-side randomness (rollout seeds, update noise, window
candidates, env resets) comes from the state's CPU ``torch.Generator``, so
a CPU run and a card run of the same seed draw the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pingpong_tpu_torch.config.schema import DRQNConfig, EnvConfig
from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    env_params_from_config,
    reset,
)
from pingpong_tpu_torch.models.qnet_rnn import (
    QNetRNN,
    qnet_rnn_copy,
    qnet_rnn_from_flat,
    qnet_rnn_init,
    qnet_rnn_sample_noise,
    qnet_rnn_to_flat,
)
from pingpong_tpu_torch.ops.drqn_update import (
    BATCH_MULTIPLE,
    drqn_update_block,
    flat_noise,
)
from pingpong_tpu_torch.ops.recurrent_rollout import (
    PackedQNetRNN,
    pack_qnet_rnn,
    pack_rnn_sigma,
    recurrent_rollout,
    rnn_kernel_flat,
)
from pingpong_tpu_torch.replay.sequence import (
    SeqReplay,
    draw_candidates,
    seq_init,
    seq_push_rollout,
    seq_sample,
)
from pingpong_tpu_torch.train.dqn import bucket_opp_idx
from pingpong_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DRQNTrainState:
    generator: torch.Generator   # host RNG stream (the JAX state's key)
    params: torch.Tensor         # (P,) learner B, raveled
    target: torch.Tensor         # (P,)
    opt_count: int               # Adam step count
    opt_mu: torch.Tensor         # (P,)
    opt_nu: torch.Tensor         # (P,)
    buffer: SeqReplay
    env_state: EnvState          # batched (num_envs,)
    hid: torch.Tensor            # (4H, num_envs) [h_b; c_b; h_opp; c_opp]
    opp_idx: torch.Tensor        # (num_envs,) i32; 0 = frozen A, k>0 = pool
    ep_return: torch.Tensor      # (num_envs,) f32 running return of B
    ended: torch.Tensor          # (num_envs,) bool: episode ended last chunk
    epsilon: float               # float32-valued
    train_steps: int
    episodes: int


class DRQNMetrics(NamedTuple):
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
    buffer_episodes: int
    env_steps: int


class PreparedRNNOpponents(NamedTuple):
    """An opponent stack packed once per generation block
    (mirror-folded for player A's seat), with the CUDA kernel's flat copy
    of it on the card (None on the CPU)."""

    packed: PackedQNetRNN
    n_slots: int
    flat: Optional[torch.Tensor]


def stack_rnn_opponents(params_a: QNetRNN, pool: Sequence[QNetRNN]
                        ) -> Tuple[list, int]:
    """``[A, pool...]``, exactly sized (opponent work scales with the slots
    present). Returns (stack, pool_size)."""
    return [params_a] + list(pool), len(pool)


def check_kernel_batch(cfg: DRQNConfig, device: torch.device) -> None:
    """Raise, naming the setting, for a batch the update kernel does not
    take on the card; the CPU's plain version takes any batch, as the JAX
    learner's XLA update does."""
    if device.type == "cuda" and cfg.batch_size % BATCH_MULTIPLE:
        raise ValueError(
            f"the DRQN update kernel takes a batch that is a multiple of "
            f"{BATCH_MULTIPLE} on the card; set drqn.batch_size to a "
            f"multiple of {BATCH_MULTIPLE} (got {cfg.batch_size})")


class DRQNLearner:
    """Binds (EnvConfig, DRQNConfig) to one device and runs train
    iterations on a :class:`DRQNTrainState`."""

    def __init__(self, env_cfg: EnvConfig, cfg: DRQNConfig, device="cuda"):
        self.env_cfg = env_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        check_kernel_batch(cfg, self.device)
        self.env_params: EnvParams = env_params_from_config(env_cfg)
        self.dims = (cfg.feature_dim // 2, cfg.feature_dim,
                     cfg.lstm_hidden_dim, cfg.head_hidden_dim)
        # shapes (and device) of the learner's QNetRNN; values unused
        self.template = self.init_params(torch.Generator().manual_seed(0))
        self.template = self.template.to(self.device)

    # -- parameters --------------------------------------------------------
    def init_params(self, generator) -> QNetRNN:
        c = self.cfg
        return qnet_rnn_init(generator, feature_dim=c.feature_dim,
                             lstm_hidden_dim=c.lstm_hidden_dim,
                             lstm_layers=c.lstm_layers,
                             head_hidden_dim=c.head_hidden_dim)

    def params_b(self, state: DRQNTrainState) -> QNetRNN:
        """Learner B as a QNetRNN (a copy of the flat vector)."""
        return qnet_rnn_from_flat(state.params, self.template)

    def _flat(self, params: QNetRNN) -> torch.Tensor:
        return qnet_rnn_to_flat(params).to(self.device, torch.float32).clone()

    def _fresh_learner(self, state: DRQNTrainState, params_b: QNetRNN,
                       epsilon: float) -> DRQNTrainState:
        flat = self._flat(params_b)
        state.params = flat
        state.target = flat.clone()
        state.opt_count = 0
        state.opt_mu = torch.zeros_like(flat)
        state.opt_nu = torch.zeros_like(flat)
        state.epsilon = float(np.float32(epsilon))
        return state

    # -- state init --------------------------------------------------------
    def init_state(self, seed: int, params_b: Optional[QNetRNN] = None,
                   epsilon: Optional[float] = None,
                   episodes: int = 0) -> DRQNTrainState:
        c = self.cfg
        gen = torch.Generator().manual_seed(int(seed))
        if params_b is None:
            params_b = self.init_params(gen)
        if epsilon is None:
            epsilon = c.initial_epsilon_per_generation
        n, dev = c.num_envs, self.device
        flat = self._flat(params_b)
        return DRQNTrainState(
            generator=gen, params=flat, target=flat.clone(), opt_count=0,
            opt_mu=torch.zeros_like(flat), opt_nu=torch.zeros_like(flat),
            buffer=seq_init(n, c.ring_len, device=dev),
            env_state=reset(self.env_params, n, gen, dev),
            hid=torch.zeros((4 * c.lstm_hidden_dim, n), dtype=torch.float32,
                            device=dev),
            opp_idx=torch.zeros((n,), dtype=torch.int32, device=dev),
            ep_return=torch.zeros((n,), dtype=torch.float32, device=dev),
            ended=torch.zeros((n,), dtype=torch.bool, device=dev),
            epsilon=float(np.float32(epsilon)), train_steps=0,
            episodes=int(episodes),
        )

    def new_generation(self, state: DRQNTrainState,
                       params_a: QNetRNN) -> DRQNTrainState:
        """Generation rollover: B <- A, fresh optimizer and target, epsilon
        back to ``initial_epsilon_per_generation``; the ring is kept."""
        return self._fresh_learner(state, params_a,
                                   self.cfg.initial_epsilon_per_generation)

    def reset_learner(self, state: DRQNTrainState,
                      params_b: QNetRNN) -> DRQNTrainState:
        """Failed-generation reset: new B weights, fresh optimizer and
        target, epsilon 1; the ring is kept."""
        return self._fresh_learner(state, params_b, 1.0)

    def prepare_opponents(self, opp_stack: Sequence[QNetRNN]
                          ) -> PreparedRNNOpponents:
        """Pack an opponent stack once per generation block."""
        members = [qnet_rnn_copy(p).to(self.device) for p in opp_stack]
        packed = pack_qnet_rnn(members, mirror=True)
        flat = rnn_kernel_flat(packed) if packed.w1t.is_cuda else None
        return PreparedRNNOpponents(packed=packed, n_slots=len(members),
                                    flat=flat)

    # -- rollout -------------------------------------------------------------
    def _rollout(self, state: DRQNTrainState, opp: PreparedRNNOpponents,
                 pool_size: int, seed: Optional[int] = None):
        """One fused rollout chunk and its ring push (in place on
        ``state``). Returns ``(stat_counts (5,) ints, ret_sum)``."""
        cfg = self.cfg
        n = cfg.num_envs
        H = cfg.lstm_hidden_dim
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,),
                                     generator=state.generator))
        if opp.n_slots == 1:
            opp_idx = state.opp_idx
        else:
            target = bucket_opp_idx(n, cfg.selfplay.opponent_pool_ratio,
                                    pool_size, phase=state.episodes,
                                    device=self.device)
            opp_idx = torch.where(state.ended, target, state.opp_idx)
        # envs that ended last chunk start the opponent stream from zero
        hid = state.hid.clone()
        hid[2 * H:] *= (~state.ended).to(torch.float32)[None, :]

        tile = min(cfg.pallas_tile_rows, n)
        learner = self.params_b(state)
        (new_env, new_opp, new_ret, hid_out, tr, counts, ret_sum,
         ended) = recurrent_rollout(
            self.env_params, state.env_state, opp_idx, state.ep_return, hid,
            pack_qnet_rnn(learner), pack_rnn_sigma(learner), opp.packed,
            seed=seed, epsilon=state.epsilon, steps=cfg.rollout_length,
            max_episode_steps=cfg.max_episode_steps, tile_rows=tile,
            opponents_flat=opp.flat)
        counts = [int(c) for c in counts.tolist()]
        n_done = counts[0] + counts[2]
        state.epsilon = float(max(
            np.float32(cfg.min_epsilon),
            np.float32(state.epsilon)
            * np.float32(cfg.epsilon_decay) ** np.float32(n_done)))
        state.env_state = new_env
        state.opp_idx = new_opp
        state.ep_return = new_ret
        state.hid = hid_out
        state.ended = ended
        state.episodes += n_done
        seq_push_rollout(state.buffer, tr["obs"], tr["action"], tr["reward"],
                         tr["done"], cfg.trace_length)
        return counts, float(ret_sum)

    # -- update --------------------------------------------------------------
    def _update(self, state: DRQNTrainState, noise=None, candidates=None):
        """K fused updates (in place on ``state``) once the ring has
        admitted more than ``batch_size * min_episodes_for_training_start``
        episodes. ``noise (K, NN)`` and the window ``candidates (env, t0)``
        are drawn from the state's generator unless given. Returns
        ``(mean_loss, updates_run)``."""
        cfg = self.cfg
        bs, K = cfg.batch_size, cfg.updates_per_iteration
        gen = state.generator
        if noise is None:
            noise = flat_noise(qnet_rnn_sample_noise(gen, self.template,
                                                     batch=(K,)))
        if candidates is None:
            candidates = draw_candidates(state.buffer, gen, K * bs,
                                         cfg.trace_length)
        if not state.buffer.ep_count > bs * cfg.min_episodes_for_training_start:
            return 0.0, 0
        smp = seq_sample(state.buffer, K * bs, cfg.trace_length, *candidates)
        shape = lambda x: x.reshape((K, bs) + x.shape[1:])
        losses = drqn_update_block(
            train_steps=state.train_steps, adam_count=state.opt_count,
            obs=shape(smp.obs), next_obs=shape(smp.next_obs),
            action=shape(smp.action[:, -1]), reward=shape(smp.reward[:, -1]),
            done=shape(smp.done[:, -1]), valid=shape(smp.valid),
            noise=noise.to(self.device), params=state.params,
            target=state.target, m=state.opt_mu, v=state.opt_nu,
            dims=self.dims, lr=cfg.lr, clip=cfg.grad_clip_norm,
            gamma=cfg.gamma, interval=cfg.target_update_interval,
            tau=cfg.target_tau)
        state.train_steps += K
        state.opt_count += K
        return float(losses.sum()) / K, K

    # -- one full iteration ------------------------------------------------
    def train_iteration(self, state: DRQNTrainState,
                        opp: PreparedRNNOpponents, pool_size: int, *,
                        seed: Optional[int] = None, noise=None,
                        candidates=None):
        """One rollout chunk, its push and one update block. ``seed``,
        ``noise`` and ``candidates`` replace the state generator's draws
        (the tests inject the JAX side's)."""
        ep_before = state.episodes
        counts, ret_sum = self._rollout(state, opp, pool_size, seed=seed)
        mean_loss, n_ran = self._update(state, noise=noise,
                                        candidates=candidates)
        metrics = DRQNMetrics(
            episodes=state.episodes - ep_before,
            games_vs_a=counts[0], wins_vs_a=counts[1],
            games_vs_pool=counts[2], wins_vs_pool=counts[3],
            episode_return_sum=ret_sum, mean_loss=mean_loss,
            updates_run=n_ran, epsilon=state.epsilon,
            train_steps=state.train_steps,
            buffer_episodes=state.buffer.ep_count,
            env_steps=self.cfg.rollout_length * self.cfg.num_envs,
        )
        return state, metrics
