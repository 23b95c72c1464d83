"""DRQN (recurrent DQN) actor-learner: rollout chunk + sequence-ring push
+ K DRQN updates.

Port of the single-device learner of ``pingpong_tpu/train/drqn.py``. The
route is decided once, at construction, from the config and the device
(:func:`drqn_route`, the JAX learner's rule with the port's kernels):

* rollout: the fused kernel (``ops/recurrent_rollout.py``, kernel 3) when
  ``use_pallas_rollout`` and the net is kernel 3's (one LSTM layer, the
  shared noisy head, widths <= 128); else the scan rollout, a loop of
  PyTorch ops over the chunk's steps (``_rollout_scan``);
* update: the fused kernel (``ops/drqn_update.py``, kernel 4) when
  ``use_pallas_update``, the net is kernel 4's, ``burn_in_length == 0``
  and, on the card, the batch is a multiple of 4; else the autodiff
  update (``_update_autodiff``).

One ``train_iteration``:

1. the rollout chunk. Fused: opponents of the envs whose episode ended in
   the last chunk re-bind at the chunk boundary (``opponent_binding``:
   "bucketed" contiguous buckets, or "sorted" iid draws with the envs
   sorted by slot for the kernel and un-permuted after it), their
   opponent LSTM stream zeroed, and epsilon decays once per chunk by
   ``decay ** episodes_done``. Scan: the learner and every opponent slot
   advance in one batched LSTM step, epsilon decays per step, and each env
   re-binds iid the step its episode ends;
2. the chunk goes into the per-env sequence ring (``replay/sequence.py``),
   with the episode directory for ``episode_uniform_sampling``;
3. K DRQN updates once the ring has admitted more than ``batch_size *
   min_episodes_for_training_start`` episodes (strictly greater, the
   reference's gate): the fused block, or K autodiff steps (the masked
   Huber loss of the last step's Double-DQN residual with the optional
   burn-in, ``torch.autograd.grad``, global-norm clipping, Adam as optax
   computes it, the target sync).

The train state is a mutable object updated in place. Parameters, target
and the Adam moments are flat vectors in ``ravel_pytree`` order; the
optimizer state ``[count, mu, nu]`` is the JAX learner's optax
``chain(clip_by_global_norm, adam)`` state on the raveled vector. Both
LSTM streams travel as one ``(4 L H, num_envs)`` block ``[h_b; c_b; h_opp;
c_opp]``, each ``(L, H, num_envs)`` (for one layer, kernel 3's layout).
Host-side randomness (rollout seeds and draws, update noise, window
candidates, env resets) comes from the state's CPU ``torch.Generator``,
so a CPU run and a card run of the same seed draw the same numbers.

Data parallelism (``mesh``, ``parallel/mesh.py``), as in ``train/dqn.py``:
each rank rolls out its block of the env batch (kernel 3 with ``tile0``,
or the scan rollout on its columns of the global draws), and the layout
follows ``learner_sharding`` by the JAX learner's rule
(``pingpong_tpu/train/drqn.py:174-220``):

* replicated: the all-gathered chunk goes into the whole sequence ring on
  every rank and every rank runs the identical update (kernel 4 or the
  autodiff update) from the same draws;
* sharded (``_update_sharded``): each rank's ring holds its own envs'
  traces; the admitted-episode count is the global one (an all-reduce of
  the push's local admissions); each update samples ``batch_size / n``
  windows locally (exact: the window-uniform rule draws the env uniformly
  and the envs split evenly) and one all-reduce sums the gradient and the
  masked mean's numerator and denominator. Episode-uniform sampling (a
  global directory) or a batch that does not divide falls back to the
  replicated layout with the JAX learner's warning.
"""

from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pingpong_tpu_torch.config.schema import DRQNConfig, EnvConfig
from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    env_params_from_config,
    observe_a,
    observe_b,
    reset,
    step_autoreset_batch,
)
from pingpong_tpu_torch.models.noisy import NoisyNoise
from pingpong_tpu_torch.parallel.mesh import Mesh, RankBlocks, all_reduce_
from pingpong_tpu_torch.models.policy import epsilon_greedy
from pingpong_tpu_torch.models.qnet import argmax3, flat_views
from pingpong_tpu_torch.models.qnet_rnn import (
    Hidden,
    QNetRNN,
    QNetRNNNoise,
    _gates_to_hc,
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
    unflat_noise,
)
from pingpong_tpu_torch.ops.recurrent_rollout import (
    MAX_WIDTH,
    PackedQNetRNN,
    pack_qnet_rnn,
    pack_rnn_sigma,
    recurrent_rollout,
    rnn_kernel_flat,
)
from pingpong_tpu_torch.replay.sequence import (
    SeqReplay,
    SeqSample,
    draw_candidates,
    draw_episode_candidates,
    seq_init,
    seq_push_rollout,
    seq_sample,
)
from pingpong_tpu_torch.train.dqn import (
    EpisodeTally,
    bucket_opp_idx,
    resolve_layout,
    scan_step_draws,
    sorted_binding_draws,
)
from pingpong_tpu_torch.train.optim import adam_, clip_by_global_norm
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.device import resolve_device

BURN_IN_WARNING = (
    "burn_in_length > 0 is served by the autodiff update path, not the "
    "fused update kernel, and costs iteration time (PERF.md has its price "
    "on the card). Set burn_in_length=0 for the fast path.")


def fallback_warning(mode: str, ndata: int) -> str:
    return (f"learner_sharding={mode!r} wants the sharded learner on {ndata} "
            "shards but needs num_envs and batch_size divisible by the "
            "data-axis size and episode_uniform_sampling=False (the episode "
            "directory is global bookkeeping); falling back to 'replicated'")


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
    hid: torch.Tensor            # (4LH, num_envs) [h_b; c_b; h_opp; c_opp]
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
    """An opponent stack prepared once per generation block: on the fused
    route ``packed`` (mirror-folded for player A's seat) and, on the card,
    kernel 3's ``flat`` copy of it; on the scan route ``raw``, every
    parameter stacked on a leading slot axis."""

    packed: Optional[PackedQNetRNN]
    n_slots: int
    flat: Optional[torch.Tensor]
    raw: Optional[Dict[str, torch.Tensor]] = None


def stack_rnn_opponents(params_a: QNetRNN, pool: Sequence[QNetRNN]
                        ) -> Tuple[list, int]:
    """``[A, pool...]``, exactly sized (opponent work scales with the slots
    present). Returns (stack, pool_size)."""
    return [params_a] + list(pool), len(pool)


def kernel_architecture(cfg: DRQNConfig) -> bool:
    """The nets kernels 3 and 4 take: one LSTM layer, the shared noisy
    head, every width at most 128."""
    return (cfg.lstm_layers == 1 and cfg.head_hidden_dim > 0
            and max(cfg.feature_dim, cfg.lstm_hidden_dim,
                    cfg.head_hidden_dim) <= MAX_WIDTH)


class DRQNRoute(NamedTuple):
    rollout: str     # "kernel" (kernel 3) or "scan"
    update: str      # "kernel" (kernel 4) or "autodiff"


def drqn_route(cfg: DRQNConfig, device) -> DRQNRoute:
    """The JAX learner's routing (``pingpong_tpu/train/drqn.py:148-162``)
    with the port's kernels: the fused rollout for ``use_pallas_rollout``
    and a kernel-architecture net; the fused update for
    ``use_pallas_update``, a kernel-architecture net, no burn-in and, on
    the card, a batch that is a multiple of 4. A function of the config and
    the device alone: the CPU runs the kernels' plain versions on their
    route."""
    arch = kernel_architecture(cfg)
    on_card = torch.device(device).type == "cuda"
    update = (cfg.use_pallas_update and arch and cfg.burn_in_length == 0
              and not (on_card and cfg.batch_size % BATCH_MULTIPLE))
    return DRQNRoute(
        rollout="kernel" if cfg.use_pallas_rollout and arch else "scan",
        update="kernel" if update else "autodiff")


def stack_rnns(members: Sequence[QNetRNN]) -> Dict[str, torch.Tensor]:
    """Every parameter of ``members`` stacked on a leading slot axis."""
    return {name: torch.stack([m.get_parameter(name) for m in members])
            for name, _ in members[0].named_parameters()}


def _stacked_noisy(P, name, x, eps: Optional[NoisyNoise]):
    """A noisy layer of every slot: ``x (S, B, in)``; ``eps`` per slot
    (zero for the eval-mode slots) or None for all in eval mode."""
    if eps is None:
        return x @ P[f"{name}.w_mu"] + P[f"{name}.b_mu"][:, None]
    w = P[f"{name}.w_mu"] + P[f"{name}.w_sigma"] * eps.eps_w
    b = P[f"{name}.b_mu"] + P[f"{name}.b_sigma"] * eps.eps_b
    return x @ w + b[:, None]


def stacked_rnn_step(P: Dict[str, torch.Tensor], layers: int, x, h, c,
                     noise: Optional[QNetRNNNoise] = None):
    """``qnet_rnn_step`` of every slot of a :func:`stack_rnns` stack at
    once: ``x (S, B, 7)``, ``h``/``c (S, L, B, H)``, ``noise`` per slot
    (leading S axis). Returns ``(q (S, B, 3), h, c)``."""
    f = torch.relu(x @ P["feat1.w"] + P["feat1.b"][:, None])
    f = torch.relu(f @ P["feat2.w"] + P["feat2.b"][:, None])
    hs, cs = [], []
    for l in range(layers):
        pre = f"lstm.{l}."
        gates = (f @ P[pre + "w_ih"] + P[pre + "b_ih"][:, None]
                 + h[:, l] @ P[pre + "w_hh"] + P[pre + "b_hh"][:, None])
        hl, cl = _gates_to_hc(gates, c[:, l])
        hs.append(hl)
        cs.append(cl)
        f = hl
    if "shared.w_mu" in P:
        f = torch.relu(_stacked_noisy(P, "shared", f, noise and noise.shared))
    v = _stacked_noisy(P, "fc_v", f, noise and noise.v)
    a = _stacked_noisy(P, "fc_a", f, noise and noise.a)
    q = v + (a - a.mean(dim=-1, keepdim=True))
    return q, torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def split_hidden(hid: torch.Tensor, layers: int):
    """``(4LH, B)`` -> ``(4, L, B, H)``: ``[h_b, c_b, h_opp, c_opp]``."""
    B = hid.shape[1]
    return hid.view(4, layers, -1, B).transpose(2, 3)


def join_hidden(parts: torch.Tensor) -> torch.Tensor:
    """``(4, L, B, H)`` -> the state's ``(4LH, B)`` block."""
    return parts.transpose(2, 3).reshape(-1, parts.shape[2]).contiguous()


class DRQNLearner(RankBlocks):
    """Binds (EnvConfig, DRQNConfig) to one device, and with ``mesh`` to this
    rank's block of a data-parallel run, and runs train iterations on a
    :class:`DRQNTrainState`."""

    def __init__(self, env_cfg: EnvConfig, cfg: DRQNConfig, device="cuda",
                 mesh: Optional[Mesh] = None):
        if cfg.opponent_binding not in ("bucketed", "sorted"):
            raise ValueError(
                f"unknown opponent_binding={cfg.opponent_binding!r}")
        ndata = 1 if mesh is None else mesh.n_data
        if cfg.num_envs % ndata:
            raise ValueError(f"num_envs {cfg.num_envs} does not split over "
                             f"{ndata} data shards")
        self.sharded = resolve_layout(
            cfg, mesh, cfg.batch_size % ndata == 0
            and not cfg.episode_uniform_sampling, fallback_warning)
        self.mesh = mesh if ndata > 1 else None
        self.n_data = ndata
        self.env_cfg = env_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.route = drqn_route(cfg, self.device)
        if self.sharded:   # the sharded layout runs the autodiff update
            self.route = self.route._replace(update="autodiff")
        if (cfg.use_pallas_update and cfg.burn_in_length > 0
                and self.device.type == "cuda"):
            warnings.warn(BURN_IN_WARNING, stacklevel=2)
        self.env_params: EnvParams = env_params_from_config(env_cfg)
        self.dims = (cfg.feature_dim // 2, cfg.feature_dim,
                     cfg.lstm_hidden_dim, cfg.head_hidden_dim)
        # shapes (and device) of the learner's QNetRNN; values unused
        self.template = self.init_params(torch.Generator().manual_seed(0))
        self.template = self.template.to(self.device)
        layout = ""
        if self.mesh is not None:
            layout = (f", {'sharded' if self.sharded else 'replicated'} "
                      f"learner, rank {mesh.rank} of {ndata}")
        print(f"[route:drqn] rollout {self.route.rollout}, update "
              f"{self.route.update}, binding {cfg.opponent_binding}, "
              f"{'episode' if cfg.episode_uniform_sampling else 'window'}"
              f"-uniform sampling, burn-in {cfg.burn_in_length}, on "
              f"{self.device}{layout}", file=sys.stderr, flush=True)

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
        """A fresh state (this rank's block of it under a mesh)."""
        return self.shard_state(self.init_global_state(seed, params_b,
                                                       epsilon, episodes))

    def init_global_state(self, seed: int, params_b: Optional[QNetRNN] = None,
                          epsilon: Optional[float] = None,
                          episodes: int = 0) -> DRQNTrainState:
        """A fresh state of the whole batch and ring (the single-device
        state; the layout :meth:`gather_state` returns)."""
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
            buffer=seq_init(n, c.ring_len, device=dev, dir_cap=(
                c.episode_dir_capacity if c.episode_uniform_sampling
                else 0)),
            env_state=reset(self.env_params, n, gen, dev),
            hid=torch.zeros((4 * c.lstm_layers * c.lstm_hidden_dim, n),
                            dtype=torch.float32, device=dev),
            opp_idx=torch.zeros((n,), dtype=torch.int32, device=dev),
            ep_return=torch.zeros((n,), dtype=torch.float32, device=dev),
            ended=torch.zeros((n,), dtype=torch.bool, device=dev),
            epsilon=float(np.float32(epsilon)), train_steps=0,
            episodes=int(episodes),
        )

    # -- data-parallel layout ----------------------------------------------
    _RING_ROWS = ("data", "ep_id", "cur_ep_id", "cur_ep_len")

    def shard_state(self, state: DRQNTrainState) -> DRQNTrainState:
        """This rank's part of a whole state: its block of the per-env
        leaves (the hidden block's columns) and, in the sharded layout, its
        envs' rows of the ring (the cursor, the global admitted count and
        the dummy directory are kept). The identity without a mesh."""
        if self.mesh is None:
            return state
        buf = state.buffer
        if self.sharded:
            buf = dataclasses.replace(buf, **{
                f: self._blk(getattr(buf, f)) for f in self._RING_ROWS})
        return dataclasses.replace(
            state, env_state=EnvState(*(self._blk(x)
                                        for x in state.env_state)),
            hid=self._blk(state.hid, 1), opp_idx=self._blk(state.opp_idx),
            ep_return=self._blk(state.ep_return),
            ended=self._blk(state.ended), buffer=buf)

    def gather_state(self, state: DRQNTrainState) -> DRQNTrainState:
        """The whole state from every rank's part (collective: every rank
        calls it at the same point); the identity without a mesh."""
        if self.mesh is None:
            return state
        buf = state.buffer
        if self.sharded:
            buf = dataclasses.replace(buf, **{
                f: self._cat(getattr(buf, f)) for f in self._RING_ROWS})
        return dataclasses.replace(
            state, env_state=EnvState(*(self._cat(x)
                                        for x in state.env_state)),
            hid=self._cat(state.hid, 1), opp_idx=self._cat(state.opp_idx),
            ep_return=self._cat(state.ep_return),
            ended=self._cat(state.ended), buffer=buf)

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
        """Prepare an opponent stack once per generation block: packed for
        kernel 3 (``pack_qnet_rnn`` takes only its architecture), or
        stacked for the scan rollout."""
        members = [qnet_rnn_copy(p).to(self.device) for p in opp_stack]
        if self.route.rollout == "scan":
            return PreparedRNNOpponents(packed=None, n_slots=len(members),
                                        flat=None, raw=stack_rnns(members))
        packed = pack_qnet_rnn(members, mirror=True)
        flat = rnn_kernel_flat(packed) if packed.w1t.is_cuda else None
        return PreparedRNNOpponents(packed=packed, n_slots=len(members),
                                    flat=flat)

    # -- rollout -------------------------------------------------------------
    def _rollout(self, state: DRQNTrainState, opp: PreparedRNNOpponents,
                 pool_size: int, seed: Optional[int] = None):
        """One rollout chunk on the learner's route and its ring push (in
        place on ``state``). Returns ``(stat_counts, ret_sum)`` of the
        whole batch, the counts ``[games_vs_a, wins_vs_a, games_vs_pool,
        wins_vs_pool, ...]``. Under a mesh the replicated layout pushes the
        all-gathered chunk into the whole ring; the sharded one pushes this
        rank's chunk into its rows and all-reduces the admissions into the
        global admitted count."""
        with trace.span("learner::rollout"):
            if self.route.rollout == "kernel":
                counts, ret_sum, tr = self._rollout_kernel(state, opp,
                                                           pool_size, seed)
            else:
                counts, ret_sum, tr = self._rollout_scan(state, opp,
                                                         pool_size)
        buf = state.buffer
        with trace.span("replay::push"):
            if self.mesh is not None and not self.sharded:
                # one rank-order all-gather of the packed (T, B_local, 10)
                # chunk
                packed = self._cat(torch.cat([
                    tr["obs"], tr["action"].to(torch.float32)[..., None],
                    tr["reward"][..., None],
                    tr["done"].to(torch.float32)[..., None]], dim=-1), dim=1)
                tr = dict(obs=packed[..., :7],
                          action=packed[..., 7].to(torch.int32),
                          reward=packed[..., 8], done=packed[..., 9] > 0.5)
            before = buf.ep_count
            if self.sharded:
                buf.ep_count = 0
            seq_push_rollout(buf, tr["obs"], tr["action"], tr["reward"],
                             tr["done"], self.cfg.trace_length)
            if self.sharded:
                admitted = torch.tensor(buf.ep_count, dtype=torch.int64,
                                        device=self.device)
                buf.ep_count = before + trace.readback(
                    all_reduce_(admitted, self.mesh), int)
        return counts, ret_sum

    def _rollout_kernel(self, state: DRQNTrainState,
                        opp: PreparedRNNOpponents, pool_size: int,
                        seed: Optional[int]):
        """One fused rollout chunk (kernel 3), in place on ``state``.
        With sorted binding the envs go to the kernel sorted by slot and
        everything comes back in env order (the ring is per env); under a
        mesh the WHOLE batch is sorted, as the JAX learner does, so the
        ranks exchange their envs before the kernel and after it. A rank
        runs its block with ``tile0`` its first global tile, unless the
        block does not split into whole tiles (then every rank runs the
        whole batch and keeps its block). Returns ``(stat_counts (5,)
        ints, ret_sum, transitions)``."""
        cfg = self.cfg
        n = cfg.num_envs
        H = cfg.lstm_hidden_dim
        gen = state.generator
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        ratio = cfg.selfplay.opponent_pool_ratio
        perm = None
        if opp.n_slots == 1:
            opp_idx = state.opp_idx
        elif cfg.opponent_binding == "bucketed":
            target = self._blk(bucket_opp_idx(n, ratio, pool_size,
                                              phase=state.episodes,
                                              device=self.device))
            opp_idx = torch.where(state.ended, target, state.opp_idx)
        else:
            draw = sorted_binding_draws(gen, n, ratio, pool_size).to(
                self.device)
            opp_idx = torch.where(self._cat(state.ended), draw,
                                  self._cat(state.opp_idx))
            perm = torch.sort(opp_idx, stable=True).indices
        # envs that ended last chunk start the opponent stream from zero
        hid = state.hid.clone()
        hid[2 * H:] *= (~state.ended).to(torch.float32)[None, :]
        env_state, ep_return = state.env_state, state.ep_return
        if perm is not None:
            env_state = EnvState(*(self._blk(self._cat(x)[perm])
                                   for x in env_state))
            opp_idx = self._blk(opp_idx[perm])
            ep_return = self._blk(self._cat(ep_return)[perm])
            hid = self._blk(self._cat(hid, 1)[:, perm], 1)

        tile, tile0, whole = self._tiling(cfg.pallas_tile_rows, n,
                                          opp_idx.shape[0])
        if whole:
            env_state = EnvState(*(self._cat(x) for x in env_state))
            opp_idx, ep_return = self._cat(opp_idx), self._cat(ep_return)
            hid = self._cat(hid, 1)
        learner = self.params_b(state)
        (new_env, new_opp, new_ret, hid_out, tr, counts, ret_sum,
         ended) = recurrent_rollout(
            self.env_params, env_state, opp_idx, ep_return, hid,
            pack_qnet_rnn(learner), pack_rnn_sigma(learner), opp.packed,
            seed=seed, epsilon=state.epsilon, steps=cfg.rollout_length,
            max_episode_steps=cfg.max_episode_steps, tile_rows=tile,
            tile0=tile0, opponents_flat=opp.flat)
        if whole:
            counts = [int(c) for c in trace.readback(counts)]
            ret_sum = trace.readback(ret_sum, float)
        else:
            counts, ret_sum = self._sum_counts(counts, ret_sum)
        if perm is not None or whole:
            # the whole batch's outputs, in the kernel's env order
            g = (lambda x, dim=0: x) if whole else self._cat
            new_env = EnvState(*(g(x) for x in new_env))
            new_opp, new_ret, ended = g(new_opp), g(new_ret), g(ended)
            hid_out = g(hid_out, 1)
            tr = {k: g(v, 1) for k, v in tr.items()}
            if perm is not None:
                inv = torch.argsort(perm)
                new_env = EnvState(*(x[inv] for x in new_env))
                new_opp, new_ret, ended = new_opp[inv], new_ret[inv], \
                    ended[inv]
                hid_out = hid_out[:, inv]
                tr = {k: v[:, inv] for k, v in tr.items()}
            new_env = EnvState(*(self._blk(x) for x in new_env))
            new_opp, new_ret, ended = (self._blk(x) for x in (new_opp,
                                                                new_ret,
                                                                ended))
            hid_out = self._blk(hid_out, 1)
            tr = {k: self._blk(v, 1) for k, v in tr.items()}
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
        return counts, ret_sum, tr

    def _rollout_scan(self, state: DRQNTrainState, opp: PreparedRNNOpponents,
                      pool_size: int):
        """One scan rollout chunk (``pingpong_tpu/train/drqn.py:571-740``),
        in place on ``state``. Per step the opponent slots (mu weights, on
        player A's view) and the learner (this step's noise) advance in
        one batched LSTM step: every slot advances a candidate from the
        bound opponent stream and the bound slot's is kept. Then the
        learner's epsilon-greedy action, the env step with auto-reset, the
        statistics, both streams zeroed where the episode ended, epsilon
        decayed by ``decay ** done`` and iid re-binding of the ended envs.
        Under a mesh the rank takes its columns of the whole batch's draws
        and a step's done count is all-reduced. Returns ``(stat_counts (4,)
        ints, ret_sum, transitions)``."""
        cfg = self.cfg
        dev = self.device
        T, L = cfg.rollout_length, cfg.lstm_layers
        n = cfg.num_envs // self.n_data
        gen = state.generator
        noise = qnet_rnn_sample_noise(gen, self.template, batch=(T,))
        dr = scan_step_draws(gen, T, cfg.num_envs, pool_size, dev)
        dr = {k: self._blk(v, v.dim() - 1) for k, v in dr.items()}
        S = opp.n_slots
        learner = flat_views(state.params, self.template)
        P = {k: torch.cat([v, learner[k][None]]) for k, v in opp.raw.items()}
        tally = EpisodeTally(cfg, state.epsilon, pool_size, dev,
                             reduce=self._reducer())
        h_b, c_b, h_o, c_o = split_hidden(state.hid, L)
        env, opp_idx, ep_return = state.env_state, state.opp_idx, \
            state.ep_return
        ended = torch.zeros((n,), dtype=torch.bool, device=dev)
        tr = {k: [] for k in ("obs", "action", "reward", "done")}
        envs = torch.arange(n, device=dev)

        def slot_noise(layer, t):
            """This step's noise on the learner's slot, zero on the
            opponents'."""
            if layer is None:
                return None
            z = lambda x: torch.cat([torch.zeros((S,) + x.shape[1:],
                                                 device=dev), x[t][None]])
            return NoisyNoise(z(layer.eps_w), z(layer.eps_b))

        for t in range(T):
            obs_a, obs_b = observe_a(env), observe_b(env)
            x = torch.cat([obs_a[None].expand(S, n, 7), obs_b[None]])
            h = torch.cat([h_o[None].expand(S, L, n, -1), h_b[None]])
            c = torch.cat([c_o[None].expand(S, L, n, -1), c_b[None]])
            nz = QNetRNNNoise(*(slot_noise(layer, t) for layer in noise))
            q, h2, c2 = stacked_rnn_step(P, L, x, h, c, nz)
            act_a = argmax3(q[:S]).gather(0, opp_idx.long()[None])[0]
            act_b = epsilon_greedy(None, q[S], tally.eps, draws=(
                dr["explore"][t], dr["random_a"][t]))
            env, out = step_autoreset_batch(
                self.env_params, env, None, act_a, act_b,
                cfg.max_episode_steps, u=dr["serve"][t])
            done = out.done
            for k, v in zip(tr, (obs_b, act_b, out.reward_b, done)):
                tr[k].append(v)
            ended |= done
            # the bound member's candidate; fresh memory on a new episode
            reset = lambda x: torch.where(done[None, :, None], 0.0, x)
            sel = opp_idx.long()
            h_o = reset(h2[sel, :, envs].transpose(0, 1))
            c_o = reset(c2[sel, :, envs].transpose(0, 1))
            h_b, c_b = reset(h2[S]), reset(c2[S])
            ep_return, opp_idx = tally.step(done, out.reward_b, ep_return,
                                            opp_idx, dr["gate"][t],
                                            dr["pick"][t])
        state.env_state = env
        state.hid = join_hidden(torch.stack([h_b, c_b, h_o, c_o]))
        state.opp_idx = opp_idx
        state.ep_return = ep_return
        state.ended = ended
        state.epsilon = trace.readback(tally.eps, float)
        state.episodes += trace.readback(tally.n_done, int)
        counts, ret_sum = self._sum_counts(tally.stats, tally.ret_sum)
        return counts, ret_sum, {k: torch.stack(v) for k, v in tr.items()}

    # -- update --------------------------------------------------------------
    def _update(self, state: DRQNTrainState, noise=None, candidates=None):
        """K updates on the learner's route (in place on ``state``) once
        the ring has admitted more than ``batch_size *
        min_episodes_for_training_start`` episodes. ``noise (K, NN)``
        (``flat_noise`` rows) and the window candidates are drawn from the
        state's generator unless given: ``(env, t0)``, or ``(directory
        slot, offset)`` with ``episode_uniform_sampling``. In the sharded
        layout ``candidates`` is every rank's ``K * bs / n`` windows over
        its own ring (a list in rank order), of which this rank takes its
        own. Returns ``(mean_loss, updates_run)``."""
        cfg = self.cfg
        bs, K = cfg.batch_size, cfg.updates_per_iteration
        gen = state.generator
        episodic = cfg.episode_uniform_sampling
        gate = bs * cfg.min_episodes_for_training_start
        with trace.span("learner::draws"):
            if noise is None:
                noise = flat_noise(qnet_rnn_sample_noise(gen, self.template,
                                                         batch=(K,)))
            if self.sharded:
                bs //= self.n_data
                if candidates is None:
                    candidates = [draw_candidates(state.buffer, gen, K * bs,
                                                  cfg.trace_length)
                                  for _ in range(self.n_data)]
                candidates = candidates[self.mesh.rank]
            elif candidates is None:
                draw = (draw_episode_candidates if episodic
                        else draw_candidates)
                candidates = draw(state.buffer, gen, K * bs,
                                  cfg.trace_length)
            ready = state.buffer.ep_count > gate
            if ready:
                noise = noise.to(self.device)
        if not ready:
            return 0.0, 0
        with trace.span("replay::sample"):
            smp = seq_sample(state.buffer, K * bs, cfg.trace_length,
                             *candidates, episode_uniform=episodic)
        if self.sharded:
            run = self._update_sharded
        elif self.route.update == "kernel":
            run = self._update_kernel
        else:
            run = self._update_autodiff
        with trace.span("learner::update"):
            losses = run(state, smp, noise)
            return trace.readback(losses.sum(), float) / K, K

    def _update_kernel(self, state: DRQNTrainState, smp: SeqSample, noise):
        """K fused updates (kernel 4). Returns the losses ``(K,)``."""
        cfg = self.cfg
        bs, K = cfg.batch_size, cfg.updates_per_iteration
        shape = lambda x: x.reshape((K, bs) + x.shape[1:])
        losses = drqn_update_block(
            train_steps=state.train_steps, adam_count=state.opt_count,
            obs=shape(smp.obs), next_obs=shape(smp.next_obs),
            action=shape(smp.action[:, -1]), reward=shape(smp.reward[:, -1]),
            done=shape(smp.done[:, -1]), valid=shape(smp.valid),
            noise=noise, params=state.params,
            target=state.target, m=state.opt_mu, v=state.opt_nu,
            dims=self.dims, lr=cfg.lr, clip=cfg.grad_clip_norm,
            gamma=cfg.gamma, interval=cfg.target_update_interval,
            tau=cfg.target_tau)
        state.train_steps += K
        state.opt_count += K
        return losses

    # -- autodiff update -------------------------------------------------------
    def _apply_flat(self, flat: torch.Tensor, obs_seq, hidden: Hidden,
                    noise: Optional[QNetRNNNoise] = None):
        """``qnet_rnn_apply`` with the parameters taken from the raveled
        vector ``flat`` (views of it, so autograd reaches ``flat``)."""
        return torch.func.functional_call(
            self.template, flat_views(flat, self.template),
            (obs_seq, hidden, noise))

    def _zero_hidden(self, batch: int) -> Hidden:
        c = self.cfg
        z = torch.zeros((c.lstm_layers, batch, c.lstm_hidden_dim),
                        dtype=torch.float32, device=self.device)
        return Hidden(h=z, c=z)

    def _target_q(self, target: torch.Tensor, next_obs):
        """The target's eval-mode Q over ``(N, trace)`` next-obs windows,
        with the optional burn-in split
        (``pingpong_tpu/train/drqn.py:742-763``). Returns ``(q, h0_t)``:
        the target's burn-in hidden, which the online net's next-obs
        forward starts from, or None without burn-in."""
        burn = self.cfg.burn_in_length
        n = next_obs.shape[0]
        with torch.no_grad():
            if burn > 0:
                _, h0_t = self._apply_flat(target, next_obs[:, :burn],
                                           self._zero_hidden(n))
                q, _ = self._apply_flat(target, next_obs[:, burn:], h0_t)
                return q, h0_t
            q, _ = self._apply_flat(target, next_obs, self._zero_hidden(n))
        return q, None

    def _drqn_huber(self, flat, smp: SeqSample, noise: QNetRNNNoise,
                    q_next_target, h0_t: Hidden):
        """Per-sample Smooth-L1 losses ``(bs,)`` of the last step's
        Double-DQN residual (``pingpong_tpu/train/drqn.py:765-811``): the
        burn-in warms the hidden on the first frames without gradient, the
        online net runs (s, s') as one batch (the s' half from the
        target's burn-in hidden), its argmax at s' indexes the target's
        Q(s'), the target held constant."""
        cfg = self.cfg
        burn = cfg.burn_in_length
        bs = smp.obs.shape[0]
        obs_seq, next_seq = smp.obs, smp.next_obs
        if burn > 0:
            with torch.no_grad():
                _, h0 = self._apply_flat(flat.detach(), obs_seq[:, :burn],
                                         self._zero_hidden(bs))
            obs_seq, next_seq = obs_seq[:, burn:], next_seq[:, burn:]
        else:
            h0 = self._zero_hidden(bs)
        x = torch.cat([obs_seq, next_seq])
        h = Hidden(h=torch.cat([h0.h, h0_t.h], dim=1),
                   c=torch.cat([h0.c, h0_t.c], dim=1))
        q, _ = self._apply_flat(flat, x, h, noise)
        q_a = q[:bs].gather(1, smp.action[:, -1].long()[:, None])[:, 0]
        na = argmax3(q[bs:].detach()).long()
        with torch.no_grad():
            nq = q_next_target.gather(1, na[:, None])[:, 0]
            y = smp.reward[:, -1] + cfg.gamma * nq * (
                1.0 - smp.done[:, -1].to(torch.float32))
        td = q_a - y
        return torch.where(td.abs() <= 1.0, 0.5 * td * td, td.abs() - 0.5)

    def _update_autodiff(self, state: DRQNTrainState, smp: SeqSample, noise,
                         reduce=None):
        """K autodiff updates (``pingpong_tpu/train/drqn.py:918-1041``) on
        the K minibatches of ``smp``: the target's Q(s') for all K in one
        batch up front, recomputed per update from the live target once a
        sync lands inside the block (every update under Polyak); per
        update the masked-mean Huber loss, its gradient by
        ``torch.autograd.grad``, the gradient clipped to
        ``grad_clip_norm``, Adam, the target sync. ``reduce`` (the sharded
        layout's) sums ``[gradient of the numerator, numerator,
        denominator]`` of the local masked sum over the ranks before the
        mean is taken. Returns the losses ``(K,)``."""
        cfg = self.cfg
        K = cfg.updates_per_iteration
        bs = smp.obs.shape[0] // K
        nz = unflat_noise(noise, self.template)
        qt_all, h0t_all = self._target_q(state.target, smp.next_obs)
        synced = cfg.target_tau > 0.0
        losses = []
        for k in range(K):
            sl = slice(k * bs, (k + 1) * bs)
            sk = SeqSample(*(x[sl] for x in smp))
            if synced:
                qt, h0t = self._target_q(state.target, sk.next_obs)
            else:
                qt = qt_all[sl]
                h0t = h0t_all and Hidden(h0t_all.h[:, sl], h0t_all.c[:, sl])
            h0t = h0t or self._zero_hidden(bs)
            noise_k = QNetRNNNoise(*(
                None if x is None else NoisyNoise(x.eps_w[k], x.eps_b[k])
                for x in nz))
            w = sk.valid.to(torch.float32)
            flat = state.params.detach().requires_grad_(True)
            huber = self._drqn_huber(flat, sk, noise_k, qt, h0t)
            if reduce is None:
                loss = torch.sum(w * huber) / torch.clamp(w.sum(), min=1.0)
                (grad,) = torch.autograd.grad(loss, flat)
            else:
                num = torch.sum(w * huber)
                (g_num,) = torch.autograd.grad(num, flat)
                g = reduce(torch.cat([g_num, num.detach()[None],
                                      w.sum()[None]]))
                denom = torch.clamp(g[-1], min=1.0)
                grad, loss = g[:-2] / denom, g[-2] / denom
            state.opt_count += 1
            adam_(state.params, clip_by_global_norm(grad, cfg.grad_clip_norm),
                  state.opt_mu, state.opt_nu, state.opt_count, cfg.lr)
            state.train_steps += 1
            if cfg.target_tau > 0.0:
                state.target = state.target + cfg.target_tau * (
                    state.params - state.target)
            elif state.train_steps % cfg.target_update_interval == 0:
                state.target = state.params.clone()
                synced = True
            losses.append(loss.detach())
        return torch.stack(losses)

    def _update_sharded(self, state: DRQNTrainState, smp: SeqSample, noise):
        """K updates of the sharded layout
        (``pingpong_tpu/train/drqn.py:1044-1200``) on this rank's ``bs / n``
        windows an update: the autodiff update with one all-reduce an update
        of the gradient and the masked mean's numerator and denominator.
        Returns the losses ``(K,)``."""
        return self._update_autodiff(
            state, smp, noise, reduce=lambda x: all_reduce_(x, self.mesh))

    # -- one full iteration ------------------------------------------------
    def train_iteration(self, state: DRQNTrainState,
                        opp: PreparedRNNOpponents, pool_size: int, *,
                        seed: Optional[int] = None, noise=None,
                        candidates=None):
        """One rollout chunk, its push and one update block. ``seed``,
        ``noise`` and ``candidates`` replace the state generator's draws
        (the tests inject the JAX side's)."""
        with trace.span("learner::iteration"):
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
