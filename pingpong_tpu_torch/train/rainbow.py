"""Rainbow's learner (Hessel et al. 2018, arXiv:1710.02298, "Rainbow: the
integrated agent") on the port's QNet family: the env, the generation
loop, the row PER and the match-runner gates are the QNet's; the net is
``models/rainbow.py``'s, and the learner is this module's alone (no QNet
route runs any of it).

One ``train_iteration``:

1. the scan rollout chunk (:func:`rainbow_rollout`): per step the
   opponents' eval-mode Q (every slot of the stack on player A's view, the
   bound slot's greedy action), the learner's Q with a fresh noise draw,
   epsilon-greedy on it (Rainbow's epsilon is 0: the noisy nets explore),
   the env step with auto-reset, the episode statistics and iid re-binding
   of the envs whose episode ended, all from the state's host generator as
   the QNet's scan route draws them;
2. the n-step fold (:func:`nstep_fold`, span ``learner::nstep``): each
   step's ``n``-step return ``G = sum_{k<n} gamma^k r_{t+k}``, cut at the
   episode's end, the observation ``n`` steps on (or the terminal one) and
   the bootstrap discount ``gamma^n`` (0 when the episode ended inside the
   n steps). The last ``n - 1`` steps of each env wait in the state's carry
   for the next chunk (saved and restored with the state); the rows go
   into the row PER (``replay/per.py``, :class:`NStepRows`) at the
   current maximum priority;
3. K updates once the replay holds a batch (:func:`rainbow_update_block`):
   per update the PER sample with annealed beta, the online net over
   ``(s_t, s_{t+n})`` with one noise draw, the Double-DQN bootstrap action
   ``argmax_a Q_online(s_{t+n}, a)``, the target net's distribution there
   with the target's own noise draw, kernel 6 (``ops/c51_loss.py``: the
   projection, the cross-entropy and its logit gradient, span
   ``learner::c51``, counter ``learner::c51_rows``), the backward from that
   gradient, Adam with the config's epsilon, the priorities ``(loss +
   per_eps)^alpha`` written back, and the hard (or Polyak) target sync.

The host draws of a call come in this order: the chunk's learner noise
``(T,)`` and its step draws, then the block's online noise ``(K,)``,
target noise ``(K,)`` and uniforms ``(K, bs)``. An update reads no host
value (its counters, beta and the replay's fill are device tensors), so on
a card, once a block has run eagerly on the same state tensors, each
update replays one CUDA graph of it (bit-equal to the eager update; then
``learner::c51`` is entered only at the capture, the counter counts every
row). The learner runs on one device; a mesh is refused at construction.
"""

from __future__ import annotations

import dataclasses
import sys
import contextlib
from typing import Dict, NamedTuple, Optional, Sequence

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
from pingpong_tpu_torch.models.policy import epsilon_greedy
from pingpong_tpu_torch.models.qnet import argmax3, flat_views
from pingpong_tpu_torch.models.rainbow import (
    RainbowNet,
    logits_flat,
    logits_of,
    noise_at,
    pack_noise,
    q_from_logits,
    rainbow_copy,
    rainbow_from_config,
    rainbow_from_flat,
    rainbow_sample_noise,
    rainbow_to_flat,
    support,
    unpack_noise,
)
from pingpong_tpu_torch.ops.c51_loss import c51_loss
from pingpong_tpu_torch.replay.per import (
    NStepRows,
    PERBuffer,
    Transition,
    decode_nstep_rows,
    per_init,
    per_push,
    per_sample,
    per_update_priorities,
)
from pingpong_tpu_torch.train.dqn import (
    DQNMetrics,
    EpisodeTally,
    scan_step_draws,
)
from pingpong_tpu_torch.train.optim import adam_
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.device import resolve_device

MESH_REFUSED = ("the Rainbow learner runs on one device: it takes no mesh "
                "(run cli train without --distributed)")


class StepCarry(NamedTuple):
    """The last ``n - 1`` steps of each env, time-major ``(n - 1, N,
    ...)``, whose n-step rows wait for the next chunk."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass
class RainbowTrainState:
    generator: torch.Generator   # host RNG stream
    params: torch.Tensor         # (P,) learner B, raveled
    target: torch.Tensor         # (P,)
    opt_count: int               # Adam step count
    opt_mu: torch.Tensor         # (P,)
    opt_nu: torch.Tensor         # (P,)
    buffer: PERBuffer            # row layout of n-step rows
    env_state: EnvState          # batched (num_envs,)
    opp_idx: torch.Tensor        # (num_envs,) i32; 0 = frozen A, k>0 = pool
    ep_return: torch.Tensor      # (num_envs,) f32 running return of B
    carry: StepCarry             # the n-step fold's carry
    carry_valid: bool            # False until a first chunk filled it
    epsilon: float
    train_steps: int
    frame_idx: int               # PER beta-anneal clock
    episodes: int


class RainbowOpponents(NamedTuple):
    """An opponent stack prepared once per generation block: every mu
    parameter stacked on a leading slot axis (the opponents play in eval
    mode)."""

    raw: Dict[str, torch.Tensor]
    n_slots: int


def stacked_q(st: Dict[str, torch.Tensor], obs: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """Eval-mode Q of every slot of a stack on ``obs (B, 7)``: ``(slots, B,
    3)``."""
    def lin(name, x, w="w_mu", b="b_mu"):
        return x @ st[f"{name}.{w}"] + st[f"{name}.{b}"][:, None]

    h = torch.relu(lin("feat1", obs, "w", "b"))
    h = torch.relu(lin("feat2", h, "w", "b"))
    v = lin("v2", torch.relu(lin("v1", h)))
    a = lin("a2", torch.relu(lin("a1", h)))
    a = a.view(*a.shape[:-1], 3, -1)
    return q_from_logits(v.unsqueeze(-2) + (a - a.mean(dim=-2, keepdim=True)),
                         z)


def nstep_fold(carry: StepCarry, tr: Dict[str, torch.Tensor], n: int,
               gamma: float):
    """The n-step rows of a chunk ``tr`` (time-major ``(T, N, ...)``)
    behind its ``carry``: one row for each of the ``T`` steps that start at
    the carry's first step, time-major flattened. Returns ``(NStepRows,
    the next carry)``."""
    keys = StepCarry._fields
    s = {k: torch.cat([getattr(carry, k), tr[k]], dim=0) for k in keys}
    T = tr["action"].shape[0]
    ret, boot, ended = s["reward"][:T], s["next_obs"][:T], s["done"][:T]
    f32 = lambda x: float(np.float32(x))   # noqa: E731
    for k in range(1, n):
        ret = ret + torch.where(ended, 0.0,
                                s["reward"][k:k + T] * f32(gamma ** k))
        boot = torch.where(ended[..., None], boot, s["next_obs"][k:k + T])
        ended = ended | s["done"][k:k + T]
    disc = torch.where(ended, 0.0, f32(gamma ** n))
    d = boot.shape[-1]
    rows = NStepRows(obs=s["obs"][:T].reshape(-1, d),
                     action=s["action"][:T].reshape(-1),
                     ret=ret.reshape(-1), next_obs=boot.reshape(-1, d),
                     disc=disc.reshape(-1))
    return rows, StepCarry(*(s[k][T:] for k in keys))


def rainbow_rollout(learner: "RainbowLearner", state: RainbowTrainState,
                    opp: RainbowOpponents, pool_size: int):
    """One scan rollout chunk, in place on ``state``'s envs, slots and
    returns (see the module docstring). Returns ``(tally, transitions)``:
    the chunk's episode statistics, return sum, episode count and epsilon
    on the device (``train/dqn.py::EpisodeTally``), and the transitions
    time-major ``(T, N, ...)``."""
    return learner._rollout(state, opp, pool_size)


def rainbow_update_block(learner: "RainbowLearner", state: RainbowTrainState,
                         *, u01: torch.Tensor, noise: torch.Tensor, bs: int):
    """K distributional updates of ``bs`` rows from the block's draws, in
    place on ``state``. Returns ``(losses (K,), sampled slots (K, bs))``."""
    return learner._update_block(state, u01, noise, bs)


class _Block:
    """The device buffers of one update block on one state's tensors
    (``key``): its draws, the update, frame and Adam counters, the
    replay's fill, the losses and sampled slots; on a card, the CUDA graph
    of one update once a block has run."""

    def __init__(self, key: tuple, K: int, bs: int, n_noise: int, device):
        i64 = dict(dtype=torch.int64, device=device)
        self.key = key
        self.u01 = torch.empty((K, bs), device=device)
        self.noise = torch.empty((K, n_noise), device=device)
        self.k, self.frame, self.count, self.size = (
            torch.zeros((), **i64) for _ in range(4))
        self.losses = torch.zeros((K,), device=device)
        self.sampled = torch.zeros((K, bs), **i64)
        self.ran = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None


class _Chunk:
    """The device buffers of one rollout chunk (``key``: its shape, the
    stack's slots, the pool and the learner's parameters): its inputs,
    which each call copies in, and on a card the CUDA graph of the chunk
    once a call has run, with its outputs and tally."""

    def __init__(self, key: tuple, live: dict):
        self.key = key
        self.x = {k: (EnvState(*(t.clone() for t in v)) if k == "env" else
                      {n: t.clone() for n, t in v.items()} if k == "raw"
                      else v.clone()) for k, v in live.items()}
        self.ran = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = self.tally = self.eps_in = None

    def load(self, live: dict) -> None:
        for k, v in live.items():
            dst = self.x[k]
            if k == "env":
                for d, t in zip(dst, v):
                    d.copy_(t)
            elif k == "raw":
                for n, t in v.items():
                    dst[n].copy_(t)
            else:
                dst.copy_(v)


class RainbowLearner:
    """Binds (EnvConfig, DQNConfig) to one device and runs Rainbow's train
    iterations on a :class:`RainbowTrainState`."""

    def __init__(self, env_cfg: EnvConfig, cfg: DQNConfig, device="cuda",
                 mesh=None):
        if mesh is not None:
            raise ValueError(MESH_REFUSED)
        if cfg.rollout_length * cfg.num_envs > cfg.memory_size:
            raise ValueError(
                "one rollout chunk may not exceed replay capacity: "
                f"{cfg.rollout_length}*{cfg.num_envs} > {cfg.memory_size}")
        if not 1 <= cfg.n_step <= cfg.rollout_length:
            raise ValueError(f"n_step {cfg.n_step} must lie in [1, "
                             f"rollout_length {cfg.rollout_length}]")
        if not 2 <= cfg.num_atoms <= 64 or not cfg.v_min < cfg.v_max:
            raise ValueError("Rainbow takes 2 to 64 atoms and v_min < v_max")
        self.env_cfg = env_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        # an update block's buffers, and on a card its CUDA graph
        self.graphs = self.device.type == "cuda"
        self._block: Optional[_Block] = None
        self._chunk_buf: Optional[_Chunk] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.env_params: EnvParams = env_params_from_config(env_cfg)
        # shapes (and device) of the learner's net; values unused
        self.template = rainbow_from_config(torch.Generator().manual_seed(0),
                                           cfg, device=self.device)
        self.z = support(cfg.num_atoms, cfg.v_min, cfg.v_max, self.device)
        self._grad_mask = torch.cat([
            torch.full((p.numel(),), 0.0 if cfg.train_heads_only
                       and n.startswith("feat") else 1.0, device=self.device)
            for n, p in self.template.named_parameters()])
        print(f"[route:rainbow] rollout scan, update autodiff with kernel 6, "
              f"replay row layout of {cfg.n_step}-step rows, "
              f"{cfg.num_atoms} atoms, streams of {cfg.stream_hidden}, on "
              f"{self.device}", file=sys.stderr, flush=True)

    # -- parameters --------------------------------------------------------
    def params_b(self, state: RainbowTrainState) -> RainbowNet:
        """Learner B as a net (a copy of the flat vector)."""
        return rainbow_from_flat(state.params, self.template)

    def _flat(self, params: RainbowNet) -> torch.Tensor:
        return rainbow_to_flat(params).to(self.device, torch.float32).clone()

    # -- state init --------------------------------------------------------
    def _empty_carry(self) -> StepCarry:
        m, n, dev = self.cfg.n_step - 1, self.cfg.num_envs, self.device
        f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        return StepCarry(obs=f(m, n, 7),
                         action=torch.zeros((m, n), dtype=torch.int32,
                                            device=dev),
                         reward=f(m, n), next_obs=f(m, n, 7),
                         done=torch.zeros((m, n), dtype=torch.bool,
                                          device=dev))

    def init_state(self, seed: int, params_b: Optional[RainbowNet] = None,
                   episodes: int = 0) -> RainbowTrainState:
        """A fresh state: ``params_b`` (else drawn from the seed's
        generator), its target and optimizer, an empty replay and carry,
        the envs reset from the generator; epsilon 0 (the noisy nets
        explore; the step's uniforms are drawn all the same)."""
        gen = torch.Generator().manual_seed(int(seed))
        if params_b is None:
            params_b = rainbow_from_config(gen, self.cfg)
        flat = self._flat(params_b)
        n, dev = self.cfg.num_envs, self.device
        return RainbowTrainState(
            generator=gen, params=flat, target=flat.clone(), opt_count=0,
            opt_mu=torch.zeros_like(flat), opt_nu=torch.zeros_like(flat),
            buffer=per_init(self.cfg.memory_size, device=dev),
            env_state=reset(self.env_params, n, gen, dev),
            opp_idx=torch.zeros((n,), dtype=torch.int32, device=dev),
            ep_return=torch.zeros((n,), dtype=torch.float32, device=dev),
            carry=self._empty_carry(), carry_valid=False,
            epsilon=0.0, train_steps=0, frame_idx=0,
            episodes=int(episodes))

    init_global_state = init_state

    def shard_state(self, state: RainbowTrainState) -> RainbowTrainState:
        return state

    def gather_state(self, state: RainbowTrainState) -> RainbowTrainState:
        return state

    def reset_learner(self, state: RainbowTrainState,
                      params_b: RainbowNet) -> RainbowTrainState:
        """Fresh learner weights, target, optimizer and replay, written
        into the state's own tensors (so that a card's CUDA graphs of the
        chunk and the update, which read them, stay valid); epsilon back
        to 0. The envs and the carry go on."""
        state.params.copy_(self._flat(params_b))
        state.target.copy_(state.params)
        state.opt_count = 0
        state.opt_mu.zero_()
        state.opt_nu.zero_()
        buf = state.buffer
        for t in (buf.data, buf.prios, buf.p_alpha, buf.chunk_sums):
            t.zero_()
        buf.pos = buf.size = 0
        state.epsilon = 0.0
        state.train_steps = 0
        state.frame_idx = 0
        return state

    def prepare_opponents(self, opp_stack: Sequence[RainbowNet]
                          ) -> RainbowOpponents:
        members = [rainbow_copy(p).to(self.device) for p in opp_stack]
        raw = {name: torch.stack([m.get_parameter(name) for m in members])
               for name, _ in members[0].named_parameters()}
        return RainbowOpponents(raw=raw, n_slots=len(members))

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """A host tensor on the learner's device (from pinned memory, in
        one non-blocking copy, on a card)."""
        if self.device.type != "cuda":
            return x.to(self.device)
        return x.pin_memory().to(self.device, non_blocking=True)

    # -- rollout -------------------------------------------------------------
    def _rollout(self, state: RainbowTrainState, opp: RainbowOpponents,
                 pool_size: int):
        cfg = self.cfg
        dev, T = self.device, cfg.rollout_length
        with trace.span("learner::draws"):
            noise = self._to_device(pack_noise(rainbow_sample_noise(
                state.generator, self.template, batch=(T,), device="cpu")))
            dr = scan_step_draws(state.generator, T, cfg.num_envs, pool_size,
                                 dev)
        live = dict(env=state.env_state, opp_idx=state.opp_idx,
                    ep_return=state.ep_return, noise=noise, raw=opp.raw,
                    **dr)
        if self.graphs:
            (env, opp_idx, ep_return, tr), tally = self._chunk_graph(
                state, live, opp.n_slots, pool_size)
        else:
            tally = EpisodeTally(cfg, state.epsilon, pool_size, dev)
            env, opp_idx, ep_return, tr = self._chunk(state.params, live,
                                                      tally)
        state.env_state, state.opp_idx, state.ep_return = env, opp_idx, \
            ep_return
        return tally, tr

    def _chunk(self, params: torch.Tensor, x: dict, tally: EpisodeTally):
        """The chunk's steps from its inputs ``x`` (the envs, their slots
        and returns, the noise and the step draws), on device values only.
        Returns ``(envs, slots, returns, transitions)``."""
        T = self.cfg.rollout_length
        noise = unpack_noise(x["noise"], self.template)
        env, opp_idx, ep_return = x["env"], x["opp_idx"], x["ep_return"]
        keys = ("obs", "action", "reward", "next_obs", "done")
        tr = {k: [] for k in keys}
        for t in range(T):
            obs_a, obs_b = observe_a(env), observe_b(env)
            act_all = argmax3(stacked_q(x["raw"], obs_a, self.z))
            act_a = act_all.gather(0, opp_idx.long()[None])[0]
            q_b = q_from_logits(logits_flat(params, self.template, obs_b,
                                            noise_at(noise, t)), self.z)
            act_b = epsilon_greedy(None, q_b, tally.eps,
                                   draws=(x["explore"][t], x["random_a"][t]))
            env, out = step_autoreset_batch(
                self.env_params, env, None, act_a, act_b,
                self.env_cfg.max_episode_steps, u=x["serve"][t])
            for k, v in zip(keys, (obs_b, act_b, out.reward_b, out.obs_b,
                                   out.done)):
                tr[k].append(v)
            ep_return, opp_idx = tally.step(out.done, out.reward_b,
                                            ep_return, opp_idx,
                                            x["gate"][t], x["pick"][t])
        return env, opp_idx, ep_return, {k: torch.stack(v)
                                         for k, v in tr.items()}

    def _chunk_graph(self, state: RainbowTrainState, live: dict,
                     n_slots: int, pool_size: int):
        """The chunk on a card: its inputs copied into the buffers of its
        shape (``_Chunk``); the first call runs eagerly on the side stream,
        the second captures the chunk as a CUDA graph, every later one
        replays it. Returns the chunk's outputs (the envs, slots and
        returns as copies) and its tally."""
        cfg = self.cfg
        key = (cfg.rollout_length, cfg.num_envs, n_slots, pool_size,
               state.params.data_ptr())
        ch = self._chunk_buf
        if ch is None or ch.key != key:
            ch = self._chunk_buf = _Chunk(key, live)
        else:
            ch.load(live)
        stream = self._side_stream()
        if ch.graph is None and ch.ran:
            ch.tally = EpisodeTally(cfg, 0.0, pool_size, self.device)
            ch.eps_in = ch.tally.eps
            ch.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(ch.graph, stream=stream):
                ch.out = self._chunk(state.params, ch.x, ch.tally)
        if ch.graph is not None:
            for t in (ch.tally.stats, ch.tally.ret_sum, ch.tally.n_done):
                t.zero_()
            ch.eps_in.fill_(state.epsilon)
            ch.graph.replay()
            env, opp_idx, ep_return, tr = ch.out
            return (EnvState(*(v.clone() for v in env)), opp_idx.clone(),
                    ep_return.clone(), tr), ch.tally
        tally = EpisodeTally(cfg, state.epsilon, pool_size, self.device)
        with torch.cuda.stream(stream):
            out = self._chunk(state.params, ch.x, tally)
        torch.cuda.current_stream().wait_stream(stream)
        ch.ran = True
        return out, tally

    def _side_stream(self) -> torch.cuda.Stream:
        """The side stream of eager warm-ups and captures, after the
        current stream's work."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def _push(self, state: RainbowTrainState, tr: Dict[str, torch.Tensor]):
        """Fold the chunk behind the carry and push its n-step rows (all
        but the first ``n - 1`` steps' rows while the carry is empty)."""
        cfg = self.cfg
        with trace.span("learner::nstep"):
            rows, state.carry = nstep_fold(state.carry, tr, cfg.n_step,
                                           cfg.gamma)
            if not state.carry_valid:
                skip = (cfg.n_step - 1) * cfg.num_envs
                rows = NStepRows(*(x[skip:] for x in rows))
                state.carry_valid = True
        with trace.span("replay::push"):
            per_push(state.buffer, Transition(
                obs=rows.obs, action=rows.action, reward=rows.ret,
                next_obs=rows.next_obs, done=rows.disc), cfg.per_alpha)

    # -- update --------------------------------------------------------------
    def _block_draws(self, gen: torch.Generator):
        """The update block's host draws from ``gen``: the online noise
        ``(K,)``, the target noise ``(K,)`` (packed side by side), then the
        uniforms ``(K, bs)``."""
        K, bs = self.cfg.updates_per_iteration, self.cfg.batch_size
        noise = torch.cat([pack_noise(rainbow_sample_noise(
            gen, self.template, batch=(K,), device="cpu")) for _ in range(2)],
            dim=1)
        return torch.rand((K, bs), generator=gen), noise

    def _sync_target(self, state: RainbowTrainState, steps: int) -> None:
        """Hard sync (in place) every ``target_update_interval`` updates,
        or Polyak averaging with ``target_tau > 0``."""
        cfg = self.cfg
        if cfg.target_tau > 0.0:
            state.target.copy_(state.target + cfg.target_tau * (
                state.params - state.target))
        elif steps % cfg.target_update_interval == 0:
            state.target.copy_(state.params)

    def _update_block(self, state: RainbowTrainState, u01: torch.Tensor,
                      noise: torch.Tensor, bs: int):
        """K updates of :meth:`_update_one` on the block's device buffers;
        on a card, after a block has run eagerly on the same state tensors,
        each update replays one CUDA graph of it. The target syncs between
        the updates, on the host's count."""
        K, buf = u01.shape[0], state.buffer
        key = (K, bs, noise.shape[1]) + tuple(t.data_ptr() for t in (
            state.params, state.target, state.opt_mu, state.opt_nu,
            buf.data, buf.prios, buf.p_alpha, buf.chunk_sums))
        blk = self._block
        if blk is None or blk.key != key:
            blk = self._block = _Block(key, K, bs, noise.shape[1],
                                       self.device)
        blk.u01.copy_(u01)
        blk.noise.copy_(noise)
        blk.k.zero_()
        blk.frame.fill_(state.frame_idx)
        blk.count.fill_(state.opt_count)
        blk.size.fill_(buf.size)
        side = contextlib.nullcontext()
        if self.graphs:
            # eager blocks and the capture share a side stream (the
            # capture's warm-up); replays run on the current stream
            stream = self._side_stream()
            if blk.ran and blk.graph is None:
                blk.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(blk.graph, stream=stream):
                    self._update_one(state, blk, bs)
            if blk.graph is None:
                side = torch.cuda.stream(stream)
        with side:
            for _ in range(K):
                if blk.graph is not None:
                    blk.graph.replay()
                else:
                    self._update_one(state, blk, bs)
                trace.count("learner::c51_rows", bs)
                state.train_steps += 1
                self._sync_target(state, state.train_steps)
        if self.graphs:
            torch.cuda.current_stream().wait_stream(self._stream)
        blk.ran = True
        state.frame_idx += K
        state.opt_count += K
        return blk.losses.clone(), blk.sampled.clone()

    def _update_one(self, state: RainbowTrainState, blk: "_Block", bs: int):
        """Update ``blk.k`` of the block, on device values only: the
        sample (``blk.size`` for the replay's fill, beta from
        ``blk.frame``), the online and target forwards, kernel 6, the
        backward, Adam (step ``blk.count``) and the priorities; the loss
        and the slots go to row ``k`` of ``blk.losses`` and
        ``blk.sampled``."""
        cfg = self.cfg
        buf = state.buffer
        k = blk.k.view(1)
        blk.frame += 1
        beta = torch.clamp(cfg.per_beta_start + blk.frame.to(torch.float32)
                           * (1.0 - cfg.per_beta_start) / cfg.per_beta_frames,
                           max=1.0)
        with trace.span("replay::sample"):
            smp = per_sample(buf, bs, beta, blk.u01.index_select(0, k)[0],
                             decode=decode_nstep_rows, size=blk.size)
        nz = blk.noise.index_select(0, k)[0]
        half = nz.shape[0] // 2
        b = smp.batch
        # the parameters as leaves of their own (views of the flat vector):
        # their gradients are joined by one cat
        leaves = {name: v.detach().requires_grad_(True) for name, v
                  in flat_views(state.params, self.template).items()}
        logits = logits_of(leaves, torch.cat([b.obs, b.next_obs]),
                           unpack_noise(nz[:half], self.template))
        rows = torch.arange(bs, device=self.device)
        x = logits[rows, b.action.long()]
        with torch.no_grad():
            a_star = argmax3(q_from_logits(logits[bs:], self.z)).long()
            lt = logits_flat(state.target, self.template, b.next_obs,
                             unpack_noise(nz[half:], self.template))
            p_t = torch.softmax(lt[rows, a_star], dim=-1)
        with trace.span("learner::c51"):
            row_loss, dx = c51_loss(x.detach(), p_t, b.ret, b.disc,
                                    smp.weights, cfg.v_min, cfg.v_max)
        grad = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            x, list(leaves.values()), grad_outputs=dx)])
        blk.count += 1
        adam_(state.params, grad * self._grad_mask, state.opt_mu,
              state.opt_nu, blk.count, cfg.lr, eps=cfg.adam_eps)
        with trace.span("replay::priorities"):
            per_update_priorities(buf, smp.indices, row_loss, cfg.per_alpha,
                                  cfg.per_eps)
        blk.losses.index_copy_(0, k, (smp.weights * row_loss).mean().view(1))
        blk.sampled.index_copy_(0, k, smp.indices.view(1, -1))
        blk.k += 1

    # -- one full iteration ------------------------------------------------
    def train_iteration(self, state: RainbowTrainState,
                        opp: RainbowOpponents, pool_size: int):
        """One rollout chunk, its n-step push and one update block (see
        the module docstring). Returns ``(state, DQNMetrics)``."""
        cfg = self.cfg
        K, bs = cfg.updates_per_iteration, cfg.batch_size
        with trace.span("learner::iteration"):
            ep_before = state.episodes
            with trace.span("learner::rollout"):
                tally, tr = rainbow_rollout(self, state, opp, pool_size)
            self._push(state, tr)
            with trace.span("learner::draws"):
                u01, noise = self._block_draws(state.generator)
            mean_loss, n_ran = 0.0, 0
            if state.buffer.size >= bs:
                with trace.span("learner::update"):
                    losses, _ = rainbow_update_block(
                        self, state, u01=self._to_device(u01),
                        noise=self._to_device(noise), bs=bs)
                    mean_loss = trace.readback(losses.sum(), float) / K
                    n_ran = K
            # the chunk's totals, read once its update block is queued
            state.epsilon = trace.readback(tally.eps, float)
            state.episodes += trace.readback(tally.n_done, int)
            counts = [int(c) for c in trace.readback(tally.stats)]
            ret_sum = trace.readback(tally.ret_sum, float)
        metrics = DQNMetrics(
            episodes=state.episodes - ep_before,
            games_vs_a=counts[0], wins_vs_a=counts[1],
            games_vs_pool=counts[2], wins_vs_pool=counts[3],
            episode_return_sum=ret_sum, mean_loss=mean_loss,
            updates_run=n_ran, epsilon=state.epsilon,
            train_steps=state.train_steps, buffer_size=state.buffer.size,
            env_steps=cfg.rollout_length * cfg.num_envs)
        return state, metrics
