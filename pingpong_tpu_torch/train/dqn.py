"""DQN actor-learner: rollout chunk + PER push + K Double-DQN updates.

Port of the single-device learner of ``pingpong_tpu/train/dqn.py``. The
route is decided once, at construction, from the config alone
(:func:`dqn_route`, the JAX learner's rule):

* rollout: the fused kernel (``ops/actor_rollout.py``) when
  ``use_pallas_rollout``, else the scan rollout, a loop of PyTorch ops
  over the chunk's steps (``_rollout_scan``, the JAX ``lax.scan``);
* update: the fused kernel (``ops/dqn_update.py``) over the block replay
  layout when ``use_pallas_update`` and ``supports_fused_update(cfg)``,
  else the autodiff update over the row layout (``_update_autodiff``).

One ``train_iteration``:

1. the rollout chunk. Fused: opponents of the envs whose episode ended in
   the last chunk re-bind at the chunk boundary (``opponent_binding``:
   "bucketed" fixed contiguous buckets, or "sorted" iid draws with envs
   sorted by slot) and epsilon decays once per chunk by ``decay **
   episodes_done``. Scan: epsilon decays per step, each env re-binds iid
   the step its episode ends, every slot's Q is computed and the bound one
   gathered;
2. the time-major flattened chunk goes into PER (``replay/per.py``);
3. K Double-DQN updates once the buffer holds a batch: the fused block,
   whose emitted ``(idx, new_p)`` stream is replayed into the raw
   priorities (last writer wins); or K autodiff steps (PER sample, IS-
   weighted MSE, ``torch.autograd.grad``, the heads-only mask on the
   gradient, flat Adam as optax computes it, priority write-back, target
   sync).

The train state is a mutable object updated in place. Parameters, target
and the Adam moments are flat vectors in ``ravel_pytree`` order; the
optimizer state ``[count, mu, nu]`` is exactly the JAX learner's flat
``optax.adam`` state. Host-side randomness (rollout seeds and draws,
update uniforms and noise, opponent draws, env resets) comes from the
state's CPU ``torch.Generator``, so a CPU run and a card run of the same
seed draw the same numbers.

Data parallelism (``mesh``, ``parallel/mesh.py``): one process a card,
the env batch split into contiguous rank blocks. Each rank rolls out its
block (kernel 1 with ``tile0`` = the rank's first global tile, so its
draws are the single-device call's; or the scan rollout on its columns of
the global draws); the episode counts and return sums are all-reduced.
``learner_sharding`` picks the learner layout as the JAX learner does
(``pingpong_tpu/train/dqn.py:261-320``): "auto" is replicated up to 16
data shards and sharded above, "sharded" needs the batch and the replay to
divide and warns and falls back otherwise, and with one data shard it
warns and runs the single-device learner.

* replicated: the rank-order all-gather of the ``(T, B_local, ...)`` chunk
  rebuilds the global chunk, every rank pushes it into its whole replay and
  runs the identical update block from the same draws, so every rank's
  parameters are bit-equal to the single-process iteration's;
* sharded (``_update_sharded``): each rank pushes its own chunk into its
  ring of ``memory_size / n`` rows (rank s holds the global rows ``[s cap /
  n, (s+1) cap / n)``), samples ``batch_size / n`` rows from it per update
  (stratified, raw weights), and one all-reduce of the raw-weighted
  gradient and loss plus one MAX of the weights' maximum join the ranks;
  priorities are written back locally, Adam runs on every rank alike.

Under a mesh the state's per-env leaves (and, sharded, the replay) hold
this rank's block; :meth:`DQNLearner.shard_state` cuts a whole state to it
and :meth:`DQNLearner.gather_state` (collective) rebuilds the whole state.
Every rank draws the whole batch's host randomness from the same
generator and keeps its columns, so the generators stay in step.
"""

from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pingpong_tpu_torch.config.schema import DQNConfig, EnvConfig
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
from pingpong_tpu_torch.models.qnet import (
    QNet,
    QNetNoise,
    argmax3,
    flat_views,
    qnet_apply,
    qnet_copy,
    qnet_from_flat,
    qnet_init,
    qnet_sample_noise,
    qnet_to_flat,
)
from pingpong_tpu_torch.ops.actor_rollout import (
    actor_rollout,
    check_slot_range,
    flat_train_pack,
    pack_qnet,
    packed_flat,
    slot_range,
)
from pingpong_tpu_torch.ops.dqn_update import (
    dqn_update_block,
    pack_dqn_noise,
    supports_fused_update,
)
from pingpong_tpu_torch.replay.per import (
    PERBuffer,
    Transition,
    beta_schedule,
    last_writer_wins,
    per_init,
    per_push,
    per_sample,
    per_update_priorities,
)
from pingpong_tpu_torch.train.optim import adam_
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.device import Readout, resolve_device

ONE_SHARD_WARNING = (
    "learner_sharding='sharded' requested but the mesh has one data shard "
    "— running the single-device learner")


def fallback_warning(mode: str, ndata: int) -> str:
    return (f"learner_sharding={mode!r} wants the sharded learner on {ndata} "
            "shards but needs num_envs and batch_size divisible by the "
            "data-axis size and memory_size divisible by 128*n; falling back "
            "to 'replicated' (per-chip all-gather grows with n)")


def resolve_layout(cfg, mesh: Optional[Mesh], divisible: bool,
                   warning) -> bool:
    """The JAX learners' layout rule: True for the sharded learner. One
    data shard with "sharded" warns :data:`ONE_SHARD_WARNING`; "sharded",
    or "auto" above 16 data shards, is sharded when ``divisible`` and
    otherwise warns ``warning(mode, n)`` and stays replicated."""
    mode = cfg.learner_sharding
    if mode not in ("auto", "replicated", "sharded"):
        raise ValueError(f"unknown learner_sharding={mode!r}")
    ndata = 1 if mesh is None else mesh.n_data
    if mode == "sharded" and ndata <= 1:
        warnings.warn(ONE_SHARD_WARNING, stacklevel=3)
    elif ndata > 1 and (mode == "sharded" or (mode == "auto" and ndata > 16)):
        if divisible:
            return True
        warnings.warn(warning(mode, ndata), stacklevel=3)
    return False

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


class DeferredLoss:
    """An update block's mean loss that the call returns without waiting
    for the block: its sum is copied behind an event (:class:`Readout`),
    the first read (``float()``, numpy, ``==``, ``repr``, a format) waits
    for that event and divides by the block's ``K`` as the host read did,
    later reads reuse the value. Pickles as a float."""

    __slots__ = ("readout", "k", "_value")

    def __init__(self, total: torch.Tensor, k: int):
        self.readout = Readout(total)
        self.k = k
        self._value = None

    def __float__(self) -> float:
        if self._value is None:
            self._value = float(self.readout.wait()[0]) / self.k
            self.readout = None
        return self._value

    def __eq__(self, other):
        try:
            return float(self) == float(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self):
        return hash(float(self))

    def __array__(self, dtype=None, copy=None):
        return np.asarray(float(self), dtype=dtype)

    def __repr__(self) -> str:
        return repr(float(self))

    def __format__(self, spec: str) -> str:
        return format(float(self), spec)

    def __reduce__(self):
        return float, (float(self),)


class DQNMetrics(NamedTuple):
    episodes: int
    games_vs_a: int
    wins_vs_a: int
    games_vs_pool: int
    wins_vs_pool: int
    episode_return_sum: float
    mean_loss: float             # a DeferredLoss on one card (reads as one)
    updates_run: int
    epsilon: float
    train_steps: int
    buffer_size: int
    env_steps: int


class PreparedOpponents(NamedTuple):
    """An opponent stack prepared once per generation block: ``packed``,
    mirror-folded for player A's seat, in kernel 1's layout
    (``packed_flat``, ``(n_slots, NET)``) for the fused rollout (None on
    the scan route); ``raw``, every parameter stacked on a leading slot
    axis, for the scan rollout (None on the fused route). ``shared_trunk``:
    every slot carries slot 0's feature trunk bit for bit (heads-only
    lineages), checked on the host."""

    packed: Optional[torch.Tensor]
    n_slots: int
    shared_trunk: bool
    raw: Optional[Dict[str, torch.Tensor]] = None


class DQNRoute(NamedTuple):
    rollout: str     # "kernel" (kernel 1) or "scan"
    update: str      # "kernel" (kernel 2, block replay) or "autodiff" (rows)


def dqn_route(cfg: DQNConfig) -> DQNRoute:
    """The JAX learner's routing (``pingpong_tpu/train/dqn.py:251-260``):
    the fused update when ``use_pallas_update`` and the kernel takes the
    shapes, else the row layout and the autodiff update; the fused rollout
    when ``use_pallas_rollout``, else the scan rollout. A function of the
    config alone: the CPU runs the kernels' plain versions on their
    route."""
    return DQNRoute(
        rollout="kernel" if cfg.use_pallas_rollout else "scan",
        update=("kernel" if cfg.use_pallas_update
                and supports_fused_update(cfg) else "autodiff"))


def bucketed_covers_pool(num_envs: int, ratio: float, n_members: int) -> bool:
    """True when the pool-bucket span has at least one env per member;
    below it :func:`bucket_opp_idx` rotates the member offset by phase, so
    that no member is starved."""
    boundary = int(round((1.0 - ratio) * num_envs))
    return (num_envs - boundary) >= max(n_members, 1)


def scan_step_draws(gen: torch.Generator, steps: int, n: int,
                    pool_size: int, device) -> Dict[str, torch.Tensor]:
    """The per-step draws of a scan rollout chunk (after the learner's
    noise), up front from the CPU generator and moved to ``device`` once:
    the epsilon-greedy uniforms and random actions, the serves' uniforms,
    and the re-binding's gate uniforms and member picks."""
    cpu = dict(
        explore=torch.rand((steps, n), generator=gen),
        random_a=torch.randint(0, 3, (steps, n), generator=gen,
                               dtype=torch.int32),
        serve=torch.rand((steps, 4, n), generator=gen),
        gate=torch.rand((steps, n), generator=gen),
        pick=torch.randint(0, max(pool_size, 1), (steps, n), generator=gen,
                           dtype=torch.int32))
    return {k: v.to(device) for k, v in cpu.items()}


class EpisodeTally:
    """A scan rollout's per-step episode bookkeeping, on the device: the
    statistics ``[games_vs_a, wins_vs_a, games_vs_pool, wins_vs_pool]``
    and the return sum of the episodes that end, epsilon decayed by
    ``decay ** done`` (floored at ``min_epsilon``; ``eps`` is the value
    the next step explores with), and iid re-binding of the ended envs.
    On a rank of a mesh the statistics are the rank's block's, while
    ``reduce`` makes a step's done count the whole batch's, which epsilon
    decays by."""

    def __init__(self, cfg, epsilon: float, pool_size: int, device,
                 reduce=None):
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        self.ratio, self.pool_size = cfg.selfplay.opponent_pool_ratio, \
            pool_size
        self.decay, self.min_eps = f32(cfg.epsilon_decay), \
            f32(cfg.min_epsilon)
        self.eps = f32(epsilon)
        self.stats = torch.zeros((4,), dtype=torch.int32, device=device)
        self.ret_sum = f32(0.0)
        self.n_done = torch.zeros((), dtype=torch.int64, device=device)
        self.reduce = reduce or (lambda x: x)

    def step(self, done, reward_b, ep_return, opp_idx, gate_u, pick):
        """Tally one step; returns the next ``(ep_return, opp_idx)``."""
        ep_ret = ep_return + reward_b
        win = (ep_ret > 0.0) & done
        vs_pool = opp_idx > 0
        self.stats += torch.stack([(done & ~vs_pool).sum(),
                                   (win & ~vs_pool).sum(),
                                   (done & vs_pool).sum(),
                                   (win & vs_pool).sum()]).to(torch.int32)
        self.ret_sum += torch.where(done, ep_ret, 0.0).sum()
        nd = self.reduce(done.sum())
        self.n_done += nd
        self.eps = torch.maximum(self.min_eps,
                                 self.eps * self.decay ** nd.to(torch.float32))
        use_pool = (gate_u < self.ratio) & (self.pool_size > 0)
        new_opp = torch.where(use_pool, pick + 1, 0)
        return (torch.where(done, 0.0, ep_ret),
                torch.where(done, new_opp, opp_idx).to(torch.int32))


def sorted_binding_draws(gen: torch.Generator, n: int, ratio: float,
                         pool_size: int) -> torch.Tensor:
    """``opponent_binding="sorted"``: iid slots for ``n`` envs, A (slot 0)
    with probability ``1 - ratio``, else a uniform pool member."""
    use_pool = (torch.rand((n,), generator=gen) < ratio) & (pool_size > 0)
    pick = torch.randint(0, max(pool_size, 1), (n,), generator=gen,
                         dtype=torch.int32)
    return torch.where(use_pool, pick + 1, 0).to(torch.int32)


def stack_qnets(members: Sequence[QNet]) -> Dict[str, torch.Tensor]:
    """Every parameter of ``members`` stacked on a leading slot axis."""
    return {name: torch.stack([m.get_parameter(name) for m in members])
            for name, _ in members[0].named_parameters()}


def stacked_q(st: Dict[str, torch.Tensor], obs: torch.Tensor):
    """Eval-mode Q of every slot of a :func:`stack_qnets` stack on ``obs
    (B, 7)``: ``(slots, B, 3)``."""
    h = torch.relu(obs @ st["feat1.w"] + st["feat1.b"][:, None])
    h = torch.relu(h @ st["feat2.w"] + st["feat2.b"][:, None])
    v = h @ st["fc_v.w_mu"] + st["fc_v.b_mu"][:, None]
    a = h @ st["fc_a.w_mu"] + st["fc_a.b_mu"][:, None]
    return v + (a - a.mean(dim=-1, keepdim=True))


def unpack_dqn_noise(noise: torch.Tensor) -> QNetNoise:
    """``(K, 260)`` noise rows (``pack_dqn_noise``) -> a ``(K,)``-batched
    QNetNoise."""
    k, h = noise.shape[0], (noise.shape[1] - 4) // 4
    return QNetNoise(
        v=NoisyNoise(noise[:, :h].reshape(k, h, 1), noise[:, h:h + 1]),
        a=NoisyNoise(noise[:, h + 1:4 * h + 1].reshape(k, h, 3),
                     noise[:, 4 * h + 1:]))


def _same_trunk(members: Sequence[QNet]) -> bool:
    """Every member's feature trunk equal to member 0's (reads the card)."""
    return all(torch.equal(getattr(p, layer).get_parameter(f),
                           getattr(members[0], layer).get_parameter(f))
               for p in members[1:] for layer in ("feat1", "feat2")
               for f in ("w", "b"))


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


class DQNLearner(RankBlocks):
    """Binds (EnvConfig, DQNConfig) to one device, and with ``mesh`` to this
    rank's block of a data-parallel run, and runs train iterations on a
    :class:`DQNTrainState`."""

    def __init__(self, env_cfg: EnvConfig, cfg: DQNConfig, device="cuda",
                 mesh: Optional[Mesh] = None):
        if cfg.rollout_length * cfg.num_envs > cfg.memory_size:
            raise ValueError(
                "one rollout chunk may not exceed replay capacity: "
                f"{cfg.rollout_length}*{cfg.num_envs} > {cfg.memory_size}")
        if cfg.opponent_binding not in ("bucketed", "sorted"):
            raise ValueError(
                f"unknown opponent_binding={cfg.opponent_binding!r}")
        ndata = 1 if mesh is None else mesh.n_data
        if cfg.num_envs % ndata:
            raise ValueError(f"num_envs {cfg.num_envs} does not split over "
                             f"{ndata} data shards")
        self.sharded = resolve_layout(
            cfg, mesh, cfg.num_envs % ndata == 0
            and cfg.batch_size % ndata == 0
            and cfg.memory_size % (128 * ndata) == 0, fallback_warning)
        self.mesh = mesh if ndata > 1 else None
        self.n_data = ndata
        self.env_cfg = env_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.route = dqn_route(cfg)
        if self.sharded:   # the sharded layout runs the row update per rank
            self.route = self.route._replace(update="autodiff")
        self.env_params: EnvParams = env_params_from_config(env_cfg)
        # the event after the last call's update block, on one card
        self._block_done: Optional[torch.cuda.Event] = None
        # shapes (and device) of the learner's QNet; values unused
        self.template = qnet_init(torch.Generator().manual_seed(0),
                                  device=self.device)
        # heads-only training: a 0/1 mask on the raveled gradient
        self._grad_mask = torch.cat([
            torch.full((p.numel(),), 0.0 if cfg.train_heads_only
                       and n.startswith("feat") else 1.0, device=self.device)
            for n, p in self.template.named_parameters()])
        layout = ""
        if self.mesh is not None:
            layout = (f", {'sharded' if self.sharded else 'replicated'} "
                      f"learner, rank {mesh.rank} of {ndata}")
        print(f"[route:dqn] rollout {self.route.rollout}, update "
              f"{self.route.update}, replay "
              f"{'block' if self._block else 'row'} layout, on "
              f"{self.device}{layout}", file=sys.stderr, flush=True)

    @property
    def _block(self) -> bool:
        return self.route.update == "kernel"

    # -- parameters --------------------------------------------------------
    def params_b(self, state: DQNTrainState) -> QNet:
        """Learner B as a QNet (a copy of the flat vector)."""
        return qnet_from_flat(state.params, self.template)

    def _flat(self, params: QNet) -> torch.Tensor:
        return qnet_to_flat(params).to(self.device, torch.float32).clone()

    # -- state init --------------------------------------------------------
    def init_state(self, seed: int, params_b: Optional[QNet] = None,
                   epsilon: float = 1.0, episodes: int = 0) -> DQNTrainState:
        """A fresh state (this rank's block of it under a mesh)."""
        return self.shard_state(self.init_global_state(seed, params_b,
                                                       epsilon, episodes))

    def init_global_state(self, seed: int, params_b: Optional[QNet] = None,
                          epsilon: float = 1.0,
                          episodes: int = 0) -> DQNTrainState:
        """A fresh state of the whole batch and replay (the single-device
        state; the layout :meth:`gather_state` returns)."""
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
            buffer=per_init(self.cfg.memory_size, device=dev,
                            block=self._block),
            env_state=reset(self.env_params, n, gen, dev),
            opp_idx=torch.zeros((n,), dtype=torch.int32, device=dev),
            ep_return=torch.zeros((n,), dtype=torch.float32, device=dev),
            ended=torch.zeros((n,), dtype=torch.bool, device=dev),
            epsilon=float(np.float32(epsilon)),
            train_steps=0,
            frame_idx=0,
            episodes=int(episodes),
        )

    def _fresh_buffer(self) -> PERBuffer:
        buf = per_init(self.cfg.memory_size, device=self.device,
                       block=self._block)
        return self._shard_buffer(buf) if self.sharded else buf

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
        state.buffer = self._fresh_buffer()
        state.epsilon = 1.0
        state.train_steps = 0
        state.frame_idx = 0
        return state

    # -- data-parallel layout ----------------------------------------------
    def _shard_buffer(self, buf: PERBuffer) -> PERBuffer:
        """Rank s's rows ``[s cap / n, (s+1) cap / n)`` of a whole replay
        (its cursor and fill are the ring's own, alike on every rank)."""
        return PERBuffer(data=self._blk(buf.data), prios=self._blk(buf.prios),
                         p_alpha=self._blk(buf.p_alpha),
                         chunk_sums=self._blk(buf.chunk_sums), pos=buf.pos,
                         size=buf.size)

    def shard_state(self, state: DQNTrainState) -> DQNTrainState:
        """This rank's part of a whole state: its block of the per-env
        leaves and, in the sharded layout, of the replay; the rest is
        replicated. The identity without a mesh."""
        if self.mesh is None:
            return state
        return dataclasses.replace(
            state, env_state=EnvState(*(self._blk(x)
                                        for x in state.env_state)),
            opp_idx=self._blk(state.opp_idx),
            ep_return=self._blk(state.ep_return),
            ended=self._blk(state.ended),
            buffer=(self._shard_buffer(state.buffer) if self.sharded
                    else state.buffer))

    def gather_state(self, state: DQNTrainState) -> DQNTrainState:
        """The whole state from every rank's part (collective: every rank
        calls it at the same point); the identity without a mesh."""
        if self.mesh is None:
            return state
        buf = state.buffer
        if self.sharded:
            buf = PERBuffer(data=self._cat(buf.data),
                            prios=self._cat(buf.prios),
                            p_alpha=self._cat(buf.p_alpha),
                            chunk_sums=self._cat(buf.chunk_sums),
                            pos=buf.pos, size=buf.size)
        return dataclasses.replace(
            state, env_state=EnvState(*(self._cat(x)
                                        for x in state.env_state)),
            opp_idx=self._cat(state.opp_idx),
            ep_return=self._cat(state.ep_return),
            ended=self._cat(state.ended), buffer=buf)

    def prepare_opponents(self, opp_stack: Sequence[QNet]) -> PreparedOpponents:
        """Prepare an opponent stack once per generation block: packed for
        the fused rollout, or stacked for the scan rollout; and detect the
        shared-trunk invariant (exact equality of every slot's feature
        weights with slot 0's)."""
        members = [qnet_copy(p).to(self.device) for p in opp_stack]
        shared = len(members) > 1 and trace.readback(members, _same_trunk)
        if self.route.rollout == "kernel":
            return PreparedOpponents(
                packed=packed_flat(pack_qnet(members, mirror=True)),
                n_slots=len(members), shared_trunk=shared)
        return PreparedOpponents(packed=None, n_slots=len(members),
                                 shared_trunk=shared,
                                 raw=stack_qnets(members))

    # -- rollout -------------------------------------------------------------
    def _ahead(self, state: DQNTrainState) -> bool:
        """True where a call runs ahead of the card: the kernel rollout on
        one card (CUDA tensors, no mesh). Such a call waits once, on kernel
        1's totals, after it has queued the push and the update block."""
        return (self.mesh is None and self.route.rollout == "kernel"
                and state.params.is_cuda)

    def _to_device(self, *xs: torch.Tensor) -> List[torch.Tensor]:
        """Host tensors of one dtype on the learner's device: on a card in
        one non-blocking copy from pinned memory (the caching host
        allocator hands a pinned block out again only once its copy has
        run), elsewhere as they are."""
        if self.device.type != "cuda":
            return [x.to(self.device).contiguous() for x in xs]
        sizes = [x.numel() for x in xs]
        host = torch.empty((sum(sizes),), dtype=xs[0].dtype, pin_memory=True)
        torch.cat([x.reshape(-1) for x in xs], out=host)
        dev = host.to(self.device, non_blocking=True)
        return [v.view(x.shape) for v, x in zip(dev.split(sizes), xs)]

    def _rollout_draws(self, state: DQNTrainState, opp: PreparedOpponents,
                       pool_size: int, seed: Optional[int]):
        """The kernel rollout's host draws from the state's generator, in
        order: the chunk's seed (unless given), then, with sorted binding
        and more than one slot, every env's slot draw. ``(seed, binding)``,
        None where nothing is drawn; ``(None, None)`` on the scan route,
        which draws inside its chunk."""
        if self.route.rollout != "kernel":
            return None, None
        gen, binding = state.generator, None
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        if opp.n_slots > 1 and self.cfg.opponent_binding == "sorted":
            binding = sorted_binding_draws(
                gen, self.cfg.num_envs, self.cfg.selfplay.opponent_pool_ratio,
                pool_size)
        return seed, binding

    def _rollout(self, state: DQNTrainState, opp: PreparedOpponents,
                 pool_size: int, seed: Optional[int] = None):
        """One rollout chunk on the learner's route and its PER push (in
        place on ``state``), its draws taken and its counts read. Returns
        ``(stat_counts, ret_sum)`` of the whole batch, the counts
        ``[games_vs_a, wins_vs_a, games_vs_pool, wins_vs_pool, ...]``."""
        with trace.span("learner::draws"):
            draws = self._rollout_draws(state, opp, pool_size, seed)
        return self._queue_rollout(state, opp, pool_size, *draws)()

    def _queue_rollout(self, state: DQNTrainState, opp: PreparedOpponents,
                       pool_size: int, seed: Optional[int],
                       binding: Optional[torch.Tensor]):
        """One rollout chunk from its draws (:meth:`_rollout_draws`) and
        its PER push, in place on ``state``. Returns ``finish()``, which
        reads ``(stat_counts, ret_sum)`` and settles epsilon and the
        episode count (see :meth:`_queue_kernel_chunk`). Under a mesh the
        replicated layout pushes the all-gathered chunk, the sharded one
        this rank's own."""
        with trace.span("learner::rollout"):
            if self.route.rollout == "kernel":
                finish, tr = self._queue_kernel_chunk(state, opp, pool_size,
                                                      seed, binding)
            else:
                counts, ret_sum, tr = self._rollout_scan(state, opp,
                                                         pool_size)
                finish = lambda: (counts, ret_sum)   # noqa: E731
        with trace.span("replay::push"):
            if self.mesh is not None and not self.sharded:
                # one rank-order all-gather of the packed (T, B_local, 17)
                # chunk: the envs come back in the global order
                packed = self._cat(torch.cat([
                    tr["obs"], tr["next_obs"],
                    tr["action"].to(torch.float32)[..., None],
                    tr["reward"][..., None],
                    tr["done"].to(torch.float32)[..., None]], dim=-1), dim=1)
                tr = dict(obs=packed[..., :7], next_obs=packed[..., 7:14],
                          action=packed[..., 14].to(torch.int32),
                          reward=packed[..., 15], done=packed[..., 16] > 0.5)
            per_push(state.buffer, Transition(
                obs=tr["obs"].reshape(-1, 7), action=tr["action"].reshape(-1),
                reward=tr["reward"].reshape(-1),
                next_obs=tr["next_obs"].reshape(-1, 7),
                done=tr["done"].reshape(-1)), self.cfg.per_alpha)
        return finish

    def _rollout_kernel(self, state: DQNTrainState, opp: PreparedOpponents,
                        pool_size: int, seed: Optional[int]):
        """One fused rollout chunk (kernel 1) with its draws, in place on
        ``state``, its counts read. Returns ``(stat_counts (5,) ints,
        ret_sum, transitions)``."""
        with trace.span("learner::draws"):
            draws = self._rollout_draws(state, opp, pool_size, seed)
        finish, tr = self._queue_kernel_chunk(state, opp, pool_size, *draws)
        return (*finish(), tr)

    def _queue_kernel_chunk(self, state: DQNTrainState,
                            opp: PreparedOpponents, pool_size: int,
                            seed: int, binding: Optional[torch.Tensor]):
        """One fused rollout chunk (kernel 1) from its draws, in place on
        ``state``. Returns ``(finish, transitions)``: ``finish()`` gives
        ``(stat_counts (5,) ints, ret_sum)`` of the whole batch and decays
        epsilon and counts the episodes by them.

        The learner seat is gathered from ``state.params``
        (:func:`flat_train_pack`). On one card nothing is read before
        ``finish()``: the launch reads the slots clamped into the stack,
        and the chunk's counts, return sum and slots' range go to pinned
        memory behind an event, which ``finish()`` waits on and checks
        (``ValueError`` for a slot outside the stack). ``learner::ahead``
        counts the launches queued while the previous call's update block
        still ran.

        Under a mesh the rank runs its block with ``tile0`` its first
        global tile, unless the block does not split into whole tiles:
        then, as the JAX learner, every rank runs the whole batch and keeps
        its block. Sorted binding sorts the WHOLE batch by slot, as the JAX
        learner does, so envs move between ranks."""
        cfg = self.cfg
        n = cfg.num_envs
        dev = self.device
        env_state, ep_return = state.env_state, state.ep_return
        ratio = cfg.selfplay.opponent_pool_ratio
        if opp.n_slots == 1:
            opp_idx = state.opp_idx
        elif cfg.opponent_binding == "bucketed":
            target = self._blk(bucket_opp_idx(n, ratio, pool_size,
                                              phase=state.episodes,
                                              device=dev))
            opp_idx = torch.where(state.ended, target, state.opp_idx)
        else:
            (draw,) = self._to_device(binding)
            opp_idx = torch.where(self._cat(state.ended), draw,
                                  self._cat(state.opp_idx))
            perm = torch.sort(opp_idx, stable=True).indices
            opp_idx = self._blk(opp_idx[perm])
            env_state = EnvState(*(self._blk(self._cat(x)[perm])
                                   for x in env_state))
            ep_return = self._blk(self._cat(ep_return)[perm])

        tile, tile0, whole = self._tiling(cfg.pallas_tile_rows, n,
                                          opp_idx.shape[0])
        if whole:
            env_state = EnvState(*(self._cat(x) for x in env_state))
            opp_idx, ep_return = self._cat(opp_idx), self._cat(ep_return)
        ahead = self._ahead(state)
        if ahead and self._block_done is not None \
                and not self._block_done.query():
            trace.count("learner::ahead")
        (new_env, new_opp, new_ret, tr, counts, ret_sum,
         ended) = actor_rollout(
            self.env_params, env_state, opp_idx, ep_return,
            flat_train_pack(state.params, self.template), opp.packed,
            seed=seed, epsilon=state.epsilon, steps=cfg.rollout_length,
            max_episode_steps=self.env_cfg.max_episode_steps,
            tile_rows=tile, tile0=tile0,
            member_shared_trunk=opp.shared_trunk, check_slots=not ahead)
        if ahead:
            # read after the caller has queued the push and the update
            readout = Readout(counts, ret_sum, slot_range(opp_idx))

            def read():
                counts, ret_sum, slots = readout.wait()
                check_slot_range(*slots.tolist(), opp.n_slots)
                return counts.tolist(), float(ret_sum)
        else:
            if whole:
                counts = [int(c) for c in trace.readback(counts)]
                ret_sum = trace.readback(ret_sum, float)
                new_env = EnvState(*(self._blk(x) for x in new_env))
                new_opp, new_ret, ended = (self._blk(x) for x in (
                    new_opp, new_ret, ended))
                tr = {k: self._blk(v, 1) for k, v in tr.items()}
            else:
                counts, ret_sum = self._sum_counts(counts, ret_sum)
            read = lambda: (counts, ret_sum)   # noqa: E731
        state.env_state = new_env
        state.opp_idx = new_opp
        state.ep_return = new_ret
        state.ended = ended

        def finish():
            counts, ret_sum = read()
            n_done = counts[0] + counts[2]
            state.epsilon = float(max(
                np.float32(cfg.min_epsilon),
                np.float32(state.epsilon)
                * np.float32(cfg.epsilon_decay) ** np.float32(n_done)))
            state.episodes += n_done
            return counts, ret_sum
        return finish, tr

    def _rollout_scan(self, state: DQNTrainState, opp: PreparedOpponents,
                      pool_size: int):
        """One scan rollout chunk (``pingpong_tpu/train/dqn.py:665-765``),
        in place on ``state``: per step every slot's eval-mode Q on player
        A's view with the bound slot's action gathered, the learner's
        noisy Q and epsilon-greedy action, the env step with auto-reset,
        the episode statistics, epsilon decayed by ``decay ** done`` and
        iid re-binding of the envs whose episode ended. Under a mesh the
        rank takes its columns of the whole batch's draws and a step's done
        count is all-reduced (epsilon decays by the batch's). Returns
        ``(stat_counts (4,) ints, ret_sum, transitions)``."""
        cfg = self.cfg
        dev = self.device
        noise = qnet_sample_noise(state.generator, self.template,
                                  batch=(cfg.rollout_length,))
        dr = scan_step_draws(state.generator, cfg.rollout_length,
                             cfg.num_envs, pool_size, dev)
        dr = {k: self._blk(v, v.dim() - 1) for k, v in dr.items()}
        learner = self.params_b(state)
        tally = EpisodeTally(cfg, state.epsilon, pool_size, dev,
                             reduce=self._reducer())
        env, opp_idx, ep_return = state.env_state, state.opp_idx, \
            state.ep_return
        keys = ("obs", "action", "reward", "next_obs", "done")
        tr = {k: [] for k in keys}
        for t in range(cfg.rollout_length):
            obs_a, obs_b = observe_a(env), observe_b(env)
            act_all = argmax3(stacked_q(opp.raw, obs_a))           # (S, B)
            act_a = act_all.gather(0, opp_idx.long()[None])[0]
            nz = QNetNoise(
                v=NoisyNoise(noise.v.eps_w[t], noise.v.eps_b[t]),
                a=NoisyNoise(noise.a.eps_w[t], noise.a.eps_b[t]))
            act_b = epsilon_greedy(None, qnet_apply(learner, obs_b, nz),
                                   tally.eps, draws=(dr["explore"][t],
                                                     dr["random_a"][t]))
            env, out = step_autoreset_batch(
                self.env_params, env, None, act_a, act_b,
                self.env_cfg.max_episode_steps, u=dr["serve"][t])
            for k, x in zip(keys, (obs_b, act_b, out.reward_b, out.obs_b,
                                   out.done)):
                tr[k].append(x)
            ep_return, opp_idx = tally.step(out.done, out.reward_b,
                                            ep_return, opp_idx,
                                            dr["gate"][t], dr["pick"][t])
        state.env_state = env
        state.opp_idx = opp_idx
        state.ep_return = ep_return
        state.epsilon = trace.readback(tally.eps, float)
        state.episodes += trace.readback(tally.n_done, int)
        counts, ret_sum = self._sum_counts(tally.stats, tally.ret_sum)
        return counts, ret_sum, {k: torch.stack(v) for k, v in tr.items()}

    # -- update --------------------------------------------------------------
    def _block_draws(self, gen: torch.Generator, u01=None, noise=None):
        """The update block's host draws from ``gen``, each unless given:
        the noise ``(K, 260)``, then the uniforms ``(K, bs)``; in the
        sharded layout the uniforms are every rank's ``(n, K, bs / n)``, of
        which this rank keeps its own."""
        cfg = self.cfg
        bs, K = cfg.batch_size, cfg.updates_per_iteration
        if noise is None:
            noise = pack_dqn_noise(qnet_sample_noise(
                gen, self.template, batch=(K,), device="cpu"))
        if self.sharded:
            n = self.n_data
            if u01 is None:
                u01 = torch.rand((n, K, bs // n), generator=gen)
            u01 = u01[self.mesh.rank]
        elif u01 is None:
            u01 = torch.rand((K, bs), generator=gen)
        return u01, noise

    def _update(self, state: DQNTrainState, u01=None, noise=None):
        """K updates on the learner's route with their draws
        (:meth:`_block_draws`), in place on ``state``; see
        :meth:`_queue_update`."""
        with trace.span("learner::draws"):
            u01, noise = self._block_draws(state.generator, u01, noise)
        return self._queue_update(state, u01, noise)

    def _queue_update(self, state: DQNTrainState, u01, noise):
        """K updates on the learner's route from the block's draws (in
        place on ``state``) when the buffer holds at least a batch (its
        ring's ``bs / n`` rows, sharded). Returns ``(mean_loss,
        updates_run)``; on one card the loss is a :class:`DeferredLoss` and
        nothing here waits for the block."""
        cfg = self.cfg
        K = cfg.updates_per_iteration
        bs = cfg.batch_size // (self.n_data if self.sharded else 1)
        self._block_done = None
        if state.buffer.size < bs:
            return 0.0, 0
        with trace.span("learner::draws"):
            u01, noise = self._to_device(u01, noise)
        if self.sharded:
            run = self._update_sharded
        elif self.route.update == "kernel":
            run = self._update_kernel
        else:
            run = self._update_autodiff
        with trace.span("learner::update"):
            losses, _ = run(state, u01, noise)
            if not self._ahead(state):
                return trace.readback(losses.sum(), float) / K, K
            loss = DeferredLoss(losses.sum(), K)
            self._block_done = loss.readout.event
            return loss, K

    def _update_kernel(self, state: DQNTrainState, u01, noise):
        """K fused updates (kernel 2) over the block replay, then the
        last-writer-wins replay of the emitted priorities. Returns
        ``(losses (K,), sampled indices (K, bs))``."""
        cfg = self.cfg
        bs, K = cfg.batch_size, cfg.updates_per_iteration
        buf = state.buffer
        newp, idx, losses = dqn_update_block(
            train_steps=state.train_steps, adam_count=state.opt_count,
            frame_idx=state.frame_idx, size=buf.size, u01=u01, noise=noise,
            p_alpha=buf.p_alpha, chunk_sums=buf.chunk_sums,
            params=state.params, target=state.target, m=state.opt_mu,
            v=state.opt_nu, data=buf.data, K=K, bs=bs, lr=cfg.lr,
            gamma=cfg.gamma, interval=cfg.target_update_interval,
            tau=cfg.target_tau, alpha=cfg.per_alpha, per_eps=cfg.per_eps,
            beta_start=cfg.per_beta_start, beta_frames=cfg.per_beta_frames,
            heads_only=cfg.train_heads_only)
        with trace.span("replay::priorities"):
            slots, vals = last_writer_wins(idx.reshape(-1).long(),
                                           newp.reshape(-1))
            buf.prios[slots] = vals
        state.train_steps += K
        state.opt_count += K
        state.frame_idx += K
        return losses, idx.long()

    # -- autodiff update over the row layout ----------------------------------
    def _q_flat(self, flat: torch.Tensor, x: torch.Tensor,
                noise: Optional[QNetNoise] = None):
        """``qnet_apply`` with the parameters taken from the raveled vector
        ``flat`` (views of it, so autograd reaches ``flat``)."""
        return torch.func.functional_call(
            self.template, flat_views(flat, self.template), (x, noise))

    def _double_dqn_td(self, flat, flat_t, batch: Transition,
                       noise: QNetNoise):
        """TD residual of the Double-DQN target
        (``pingpong_tpu/train/dqn.py:905-925``): the online net (with
        ``noise``) over interleaved ``(obs_i, next_i)`` rows, its argmax at
        s' into the target's eval-mode Q(s'), the target held constant."""
        bs = batch.obs.shape[0]
        pairs = torch.stack([batch.obs, batch.next_obs], dim=1).reshape(
            2 * bs, -1)
        q2 = self._q_flat(flat, pairs, noise)
        q_a = q2[0::2].gather(1, batch.action.long()[:, None])[:, 0]
        na = argmax3(q2[1::2].detach()).long()
        with torch.no_grad():
            nq = self._q_flat(flat_t, batch.next_obs).gather(
                1, na[:, None])[:, 0]
            y = batch.reward + self.cfg.gamma * nq * (
                1.0 - batch.done.to(torch.float32))
        return q_a - y

    def _sync_target(self, state: DQNTrainState) -> None:
        """Hard sync every ``target_update_interval`` updates, or Polyak
        averaging with ``target_tau > 0``."""
        cfg = self.cfg
        if cfg.target_tau > 0.0:
            state.target = state.target + cfg.target_tau * (
                state.params - state.target)
        elif state.train_steps % cfg.target_update_interval == 0:
            state.target = state.params.clone()

    def _update_autodiff(self, state: DQNTrainState, u01, noise):
        """K autodiff updates over the row layout
        (``pingpong_tpu/train/dqn.py:1106-1199``): per update the PER
        sample with annealed beta, the loss ``mean(w td^2)``, its gradient
        by ``torch.autograd.grad``, the heads-only mask on the gradient,
        Adam, the priority write-back and the target sync. Returns
        ``(losses (K,), sampled indices (K, bs))``."""
        cfg = self.cfg
        bs, K = cfg.batch_size, cfg.updates_per_iteration
        buf = state.buffer
        nz = unpack_dqn_noise(noise)
        losses, sampled = [], []
        for k in range(K):
            state.frame_idx += 1
            beta = beta_schedule(state.frame_idx, cfg.per_beta_start,
                                 cfg.per_beta_frames)
            with trace.span("replay::sample"):
                smp = per_sample(buf, bs, beta, u01[k])
            flat = state.params.detach().requires_grad_(True)
            td = self._double_dqn_td(flat, state.target, smp.batch, QNetNoise(
                v=NoisyNoise(nz.v.eps_w[k], nz.v.eps_b[k]),
                a=NoisyNoise(nz.a.eps_w[k], nz.a.eps_b[k])))
            loss = torch.mean(smp.weights * td * td)
            (grad,) = torch.autograd.grad(loss, flat)
            state.opt_count += 1
            adam_(state.params, grad * self._grad_mask, state.opt_mu,
                  state.opt_nu, state.opt_count, cfg.lr)
            with trace.span("replay::priorities"):
                per_update_priorities(buf, smp.indices, td.detach().abs(),
                                      cfg.per_alpha, cfg.per_eps)
            state.train_steps += 1
            self._sync_target(state)
            losses.append(loss.detach())
            sampled.append(smp.indices)
        return torch.stack(losses), torch.stack(sampled)

    def _update_sharded(self, state: DQNTrainState, u01, noise):
        """K updates of the sharded layout
        (``pingpong_tpu/train/dqn.py:936-1103``) on this rank's ring: per
        update ``bs / n`` rows sampled with the raw (unnormalized) weights
        ``(N_local P(i))^-beta``, the exact importance weights of the
        stratified proposal; the raw-weighted loss sum and its gradient,
        summed over the ranks by ONE all-reduce, and the weights' maximum by
        one MAX; the global normalization ``1 / (bs max w)``, the heads-only
        mask and Adam (alike on every rank); the local priority write-back;
        the target sync. Returns ``(losses (K,), local indices (K, bs /
        n))``."""
        cfg = self.cfg
        K, bs_local = cfg.updates_per_iteration, u01.shape[1]
        buf = state.buffer
        nz = unpack_dqn_noise(noise)
        losses, sampled = [], []
        for k in range(K):
            state.frame_idx += 1
            beta = beta_schedule(state.frame_idx, cfg.per_beta_start,
                                 cfg.per_beta_frames)
            with trace.span("replay::sample"):
                smp = per_sample(buf, bs_local, beta, u01[k],
                                 normalize=False)
            flat = state.params.detach().requires_grad_(True)
            td = self._double_dqn_td(flat, state.target, smp.batch, QNetNoise(
                v=NoisyNoise(nz.v.eps_w[k], nz.v.eps_b[k]),
                a=NoisyNoise(nz.a.eps_w[k], nz.a.eps_b[k])))
            raw_sum = torch.sum(smp.weights * td * td)
            (g_raw,) = torch.autograd.grad(raw_sum, flat)
            g_sum = all_reduce_(torch.cat([g_raw, raw_sum.detach()[None]]),
                                self.mesh)
            wmax = all_reduce_(smp.weights.max(), self.mesh, op="max")
            scale = 1.0 / (cfg.batch_size * torch.clamp(wmax, min=1e-30))
            state.opt_count += 1
            adam_(state.params, g_sum[:-1] * scale * self._grad_mask,
                  state.opt_mu, state.opt_nu, state.opt_count, cfg.lr)
            with trace.span("replay::priorities"):
                per_update_priorities(buf, smp.indices, td.detach().abs(),
                                      cfg.per_alpha, cfg.per_eps)
            state.train_steps += 1
            self._sync_target(state)
            losses.append(g_sum[-1] * scale)
            sampled.append(smp.indices)
        return torch.stack(losses), torch.stack(sampled)

    # -- one full iteration ------------------------------------------------
    def train_iteration(self, state: DQNTrainState, opp: PreparedOpponents,
                        pool_size: int, *, seed: Optional[int] = None,
                        u01=None, noise=None):
        """One rollout chunk, its push and one update block. ``seed``,
        ``u01`` and ``noise`` replace the state generator's draws (the
        tests inject the JAX side's), which come in this order: the seed,
        the sorted binding's slots, the block's noise, its uniforms; the
        kernel route takes them all before kernel 1, the scan route draws
        its chunk's first. The chunk's counts are read last, so that on one
        card the call's one wait, on kernel 1's totals, comes after the
        update block is queued (:meth:`_queue_kernel_chunk`). The metrics
        are the whole batch's; ``buffer_size`` is the global fill (n local
        rings, sharded)."""
        with trace.span("learner::iteration"):
            ep_before = state.episodes
            gen, kernel = state.generator, self.route.rollout == "kernel"
            with trace.span("learner::draws"):
                draws = self._rollout_draws(state, opp, pool_size, seed)
                if kernel:
                    u01, noise = self._block_draws(gen, u01, noise)
            finish = self._queue_rollout(state, opp, pool_size, *draws)
            if not kernel:
                with trace.span("learner::draws"):
                    u01, noise = self._block_draws(gen, u01, noise)
            mean_loss, n_ran = self._queue_update(state, u01, noise)
            counts, ret_sum = finish()
        metrics = DQNMetrics(
            episodes=state.episodes - ep_before,
            games_vs_a=counts[0], wins_vs_a=counts[1],
            games_vs_pool=counts[2], wins_vs_pool=counts[3],
            episode_return_sum=ret_sum, mean_loss=mean_loss,
            updates_run=n_ran, epsilon=state.epsilon,
            train_steps=state.train_steps,
            buffer_size=state.buffer.size * (self.n_data if self.sharded
                                             else 1),
            env_steps=self.cfg.rollout_length * self.cfg.num_envs,
        )
        return state, metrics
