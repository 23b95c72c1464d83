"""Fused DQN actor rollout: a whole rollout chunk in one CUDA launch.

Port of ``pingpong_tpu/ops/actor_rollout.py::pallas_actor_rollout``. Per
env and step: the bound opponent's greedy action (mu weights; player A's
mirrored view folded into the first layer by :func:`pack_qnet`), the
learner's NoisyNet + epsilon-greedy action from the advantage head only
(``argmax(V + A - mean A) == argmax(A)``), the env step, auto-reset with a
counter-hash serve, the ``max_episode_steps`` cap, transition emission and
the per-env statistics ``[games/wins vs A, games/wins vs pool, return sum,
ended, draws]``.

Two versions compute the same function:

* :func:`actor_rollout_plain`, step by step in PyTorch. It runs for
  tensors on the CPU (the tests, which hold it against the JAX kernel in
  interpret mode), and ``chip_smoke.py`` holds the kernel against it on
  the card;
* the CUDA kernel ``csrc/actor_rollout.cu``, launched for tensors on the
  card. There is no fallback between the two.

Random draws are the JAX interpreter's counter hash
(``ops/pong_kernel.py::_hash_uniform``), so all three agree bit for bit on
every draw: the learner's head noise is one factorized draw per (tile of
``tile_rows`` envs, step) from an ``(8, 128)`` hash grid, exploration and
serves are per env (row 0, column = lane in the tile). The hash is keyed by
the GLOBAL tile ``tile0 + local tile``: a rank that rolls out its block of
a data-parallel env batch passes the global index of its first tile, and
its draws are those of the same envs in the single-device call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    serve_from_uniforms,
    step,
)
from pingpong_tpu_torch.models.qnet import QNet, argmax3
from pingpong_tpu_torch.ops.build import (
    CudaKernel,
    check_cuda,
    ptr,
    stream_ptr,
)
from pingpong_tpu_torch.ops.pong_kernel import (
    _M32,
    EnvConsts,
    hash_u01,
    tile_seed_mix,
)
from pingpong_tpu_torch.utils.device import Readout

NEG_BIG = -1e30
HIDDEN = 64
NET = 5776            # floats per packed net (see csrc/actor_rollout.cu)
CUDA_ENVS = 16        # envs per CUDA block; tile_rows must be a multiple

# obs_a = _MIRROR @ obs_b (+ e_y): x, 1-y, vx, -vy, top, bottom, spin
_MIRROR = np.zeros((8, 8), np.float32)
for _i, _j, _v in [(0, 0, 1), (1, 1, -1), (2, 2, 1), (3, 3, -1),
                   (4, 5, 1), (5, 4, 1), (6, 6, 1)]:
    _MIRROR[_i, _j] = _v


class PackedQNet(NamedTuple):
    """Transposed, padded advantage-path weights, the JAX package's layout
    (optionally with a leading slot axis). Rows 3-7 of the advantage head
    are padding; the padding rows of ``bat_mu`` hold -1e30."""

    w1t: torch.Tensor       # (..., 64, 8)
    b1t: torch.Tensor       # (..., 64, 1)
    w2t: torch.Tensor       # (..., 64, 64)
    b2t: torch.Tensor       # (..., 64, 1)
    wat_mu: torch.Tensor    # (..., 8, 64)
    bat_mu: torch.Tensor    # (..., 8, 1)
    wat_sigma: torch.Tensor
    bat_sigma: torch.Tensor


def pack_qnet(params: Union[QNet, Sequence[QNet]],
              mirror: bool = False) -> PackedQNet:
    """Pad and transpose one QNet, or stack a sequence of them along a new
    leading slot axis. ``mirror=True`` folds player A's view into the
    first layer, so the net consumes player B's observation directly."""
    if not isinstance(params, QNet):
        packs = [pack_qnet(p, mirror) for p in params]
        return PackedQNet(*(torch.stack(f) for f in zip(*packs)))

    def pad_rows(x, rows, fill=0.0):
        out = torch.full((rows,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=x.device)
        out[:x.shape[0]] = x
        return out

    w1 = params.feat1.w.detach()
    w1t = pad_rows(w1, 8).T.contiguous()              # (64, 8)
    b1t = params.feat1.b.detach()[:, None].clone()    # (64, 1)
    if mirror:
        # w1t @ obs_a == (w1t @ M) @ obs_b + w1t[:, y]
        b1t = b1t + w1t[:, 1:2]
        w1t = w1t @ torch.as_tensor(_MIRROR, device=w1t.device)
    fa = params.fc_a
    return PackedQNet(
        w1t=w1t,
        b1t=b1t,
        w2t=params.feat2.w.detach().T.contiguous(),
        b2t=params.feat2.b.detach()[:, None].clone(),
        wat_mu=pad_rows(fa.w_mu.detach().T, 8),
        bat_mu=pad_rows(fa.b_mu.detach()[:, None], 8, fill=NEG_BIG),
        wat_sigma=pad_rows(fa.w_sigma.detach().T, 8),
        bat_sigma=pad_rows(fa.b_sigma.detach()[:, None], 8),
    )


def packed_flat(p: PackedQNet) -> torch.Tensor:
    """``(..., NET)`` contiguous vector per net, in the CUDA kernel's
    layout: the fields in :class:`PackedQNet` order, except that layer 2
    is stored input-major (``w2t`` transposed, so a 16-byte load holds 4
    hidden units of one input)."""
    lead = p.w1t.shape[:-2]
    fields = p._replace(w2t=p.w2t.transpose(-1, -2))
    flat = torch.cat([f.reshape(lead + (-1,)) for f in fields], dim=-1)
    if flat.shape[-1] != NET:
        raise ValueError(f"packed net has {flat.shape[-1]} floats, the "
                         f"kernel takes hidden={HIDDEN} ({NET} floats)")
    return flat.contiguous()


# The layout's fields in order, (rows, cols) each (``w2t`` stored
# input-major).
_FIELDS = ((HIDDEN, 8), (HIDDEN, 1), (HIDDEN, HIDDEN), (HIDDEN, 1),
           (8, HIDDEN), (8, 1), (8, HIDDEN), (8, 1))


def unpack_flat(flat: torch.Tensor) -> PackedQNet:
    """:func:`packed_flat`'s inverse: the fields of ``flat (..., NET)``,
    laid out as :func:`pack_qnet` lays them out."""
    lead = tuple(flat.shape[:-1])
    fields, i = [], 0
    for rows, cols in _FIELDS:
        fields.append(flat[..., i:i + rows * cols]
                      .reshape(lead + (rows, cols)).contiguous())
        i += rows * cols
    p = PackedQNet(*fields)
    return p._replace(w2t=p.w2t.transpose(-1, -2).contiguous())


class _PackMaps(NamedTuple):
    seat: torch.Tensor       # (NET,) int64 into [flat..., 0, NEG_BIG]
    train: torch.Tensor      # (NET,) int64, the same with the sigmas
    mirror: torch.Tensor     # (NET,) int64, the same with w1t mirrored
    sign: torch.Tensor       # (NET,) f32, the mirror's signs
    b1: slice                # b1t's place in the layout
    w1_y: slice              # w1t[:, 1] (feat1.w's row 1) in the flat vector
    tail: torch.Tensor       # (2,) f32: 0, NEG_BIG


@functools.lru_cache(maxsize=8)
def _pack_maps(shapes: tuple, device: torch.device) -> _PackMaps:
    """The gather maps of a QNet with these ``(name, shape)`` parameters,
    in ``ravel_pytree`` order, made once a template and device."""
    off, i = {}, 0
    for name, shape in shapes:
        off[name] = i
        i += int(np.prod(shape))
    dims = dict(shapes)
    n_in, hidden = dims["feat1.w"]
    n_act = dims["fc_a.w_mu"][1]
    if hidden != HIDDEN or not 2 <= n_in <= 8 or not 1 <= n_act <= 8:
        raise ValueError(f"QNet of widths {n_in} -> {hidden} -> {n_act}: "
                         f"the kernel takes hidden={HIDDEN} ({NET} floats)")
    zero, neg = i, i + 1
    h = np.arange(HIDDEN)

    def rows_of(name):
        # a head's (out, hidden) transpose padded to 8 rows: entry (a, h)
        # is the (in, out) parameter's h * n_act + a
        out = np.full((8, HIDDEN), zero)
        for a in range(n_act):
            out[a] = off[name] + h * n_act + a
        return out

    def w1t(cols):
        # (HIDDEN, 8); column j reads feat1.w's row cols[j] (None: 0)
        out = np.full((HIDDEN, 8), zero)
        for j, src in enumerate(cols):
            if src is not None and src < n_in:
                out[:, j] = off["feat1.w"] + src * HIDDEN + h
        return out

    def vec(name, fill):
        out = np.full((8, 1), fill)
        out[:n_act, 0] = off[name] + np.arange(n_act)
        return out

    def layout(w1t_idx, sigma):
        return np.concatenate([x.reshape(-1) for x in (
            w1t_idx,
            off["feat1.b"] + h,
            off["feat2.w"] + np.arange(HIDDEN * HIDDEN),
            off["feat2.b"] + h,
            rows_of("fc_a.w_mu"),
            vec("fc_a.b_mu", neg),
            rows_of("fc_a.w_sigma") if sigma else np.full((8, HIDDEN), zero),
            vec("fc_a.b_sigma", zero) if sigma else np.full((8, 1), zero))])

    # w1t @ _MIRROR is a signed column select: column j of the product is
    # the one column i with _MIRROR[i, j] != 0, times that entry
    src = [None] * 8
    sgn = np.ones((HIDDEN, 8), np.float32)
    for i_, j_ in zip(*np.nonzero(_MIRROR)):
        src[j_] = i_
        sgn[:, j_] = _MIRROR[i_, j_]
    sign = np.ones(NET, np.float32)
    sign[:HIDDEN * 8] = sgn.reshape(-1)
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt).to(device)
    b1 = HIDDEN * 8
    return _PackMaps(
        seat=as_t(layout(w1t(range(8)), sigma=False), torch.int64),
        train=as_t(layout(w1t(range(8)), sigma=True), torch.int64),
        mirror=as_t(layout(w1t(src), sigma=True), torch.int64),
        sign=as_t(sign, torch.float32),
        b1=slice(b1, b1 + HIDDEN),
        w1_y=slice(off["feat1.w"] + HIDDEN, off["feat1.w"] + 2 * HIDDEN),
        tail=as_t([0.0, NEG_BIG], torch.float32))


def _maps(flat: torch.Tensor, like: QNet) -> _PackMaps:
    return _pack_maps(tuple((n, tuple(p.shape))
                            for n, p in like.named_parameters()),
                      flat.device)


def flat_seat_pack(flat: torch.Tensor, like: QNet) -> torch.Tensor:
    """``packed_flat(pack_qnet(net))`` with the advantage head's sigmas
    zero (the gates' learner seat), gathered in one index from the raveled
    net ``flat`` (``qnet_to_flat`` order, as the learner's
    ``state.params``; ``like`` gives its shapes). ``(NET,)``."""
    m = _maps(flat, like)
    return torch.cat((flat, m.tail)).index_select(0, m.seat)


def flat_train_pack(flat: torch.Tensor, like: QNet) -> torch.Tensor:
    """``packed_flat(pack_qnet(net))``, sigmas included (the training
    rollout's learner seat), gathered in one index from the raveled net
    ``flat`` as :func:`flat_seat_pack` gathers it. ``(NET,)``."""
    m = _maps(flat, like)
    return torch.cat((flat, m.tail)).index_select(0, m.train)


def flat_mirror_pack(flat: torch.Tensor, like: QNet) -> torch.Tensor:
    """``packed_flat(pack_qnet([net], mirror=True))`` gathered from the
    raveled net: the mirror's column select with its signs, then
    ``b1t + w1t[:, 1]`` as the one float add :func:`pack_qnet` makes.
    ``(1, NET)``, one opponent slot."""
    m = _maps(flat, like)
    out = torch.cat((flat, m.tail)).index_select(0, m.mirror).mul_(m.sign)
    out[m.b1] += flat[m.w1_y]
    return out[None]


def epsilon_to_int(epsilon: float) -> int:
    """The kernel's epsilon argument: ``int32(float32(eps) * 1e6)``."""
    return int(np.float32(epsilon) * np.float32(1e6))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _trunk(w1t, b1t, w2t, b2t, obs7):
    """(B, 7) -> (B, 64) second hidden layer, one net."""
    h = torch.relu(obs7 @ w1t[:, :7].T + b1t[:, 0])
    return torch.relu(h @ w2t.T + b2t[:, 0])


def _opponent_adv(opp: PackedQNet, obs7, opp_idx, shared_trunk):
    """Advantages of each env's bound member, ``(B, 3)``: every slot's
    forward over the whole batch, then a per-env select."""
    if shared_trunk:
        h2 = _trunk(opp.w1t[0], opp.b1t[0], opp.w2t[0], opp.b2t[0], obs7)
        adv = torch.einsum("bh,kah->kba", h2, opp.wat_mu[:, :3])
    else:
        h1 = torch.relu(torch.einsum("bi,kji->kbj", obs7, opp.w1t[..., :7])
                        + opp.b1t[:, None, :, 0])
        h2 = torch.relu(torch.einsum("kbi,kji->kbj", h1, opp.w2t)
                        + opp.b2t[:, None, :, 0])
        adv = torch.einsum("kbh,kah->kba", h2, opp.wat_mu[:, :3])
    adv = adv + opp.bat_mu[:, None, :3, 0]
    env = torch.arange(obs7.shape[0], device=obs7.device)
    return adv[opp_idx.long(), env]


def _noise_grid(device):
    """The (row, col) hash coordinates of eps_in (row 0, cols 0-63) and
    eps_out[0:3] (rows 0-2, col 64) in the TPU kernel's (8, 128) draw."""
    rows = torch.tensor([0] * HIDDEN + [0, 1, 2], device=device)
    cols = torch.tensor(list(range(HIDDEN)) + [HIDDEN] * 3, device=device)
    return rows, cols


def _scale_noise(x):
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def hash_noise(seed_mix, ctr, k_u1, k_u2, row, col) -> torch.Tensor:
    """``f(N(0,1))`` from the hash at ``(k_u1, k_u2)``: Box-Muller (cos
    half) on U[1e-7, 1) and U[0, 1), then ``sign(x) sqrt|x|``."""
    u1 = 1e-7 + hash_u01(seed_mix, ctr, k_u1, row, col) * (1.0 - 1e-7)
    u2 = hash_u01(seed_mix, ctr, k_u2, row, col)
    return _scale_noise(torch.sqrt(-2.0 * torch.log(u1))
                        * torch.cos(2.0 * math.pi * u2))


def env_step_plain(env_params: EnvParams, st: EnvState, ret, act_a, act_b,
                   mix_env, lane, ctr: int, max_episode_steps: int, pool_f):
    """One env step of a rollout kernel, step by step: the transition, the
    ``max_episode_steps`` cap, the accounting rows ``[games/wins vs A,
    games/wins vs pool, return sum, ended, draws, 0]`` and the auto-reset
    with a counter-hash serve (``ctr + 8``, column = lane). Returns
    ``(next_obs_b, reward_b, done, stat_rows (8, B), state', return')``."""
    new, out = step(env_params, st, act_a, act_b)
    done = out.done
    if max_episode_steps:
        done = done | (new.t >= max_episode_steps)
    ep_ret = ret + out.reward_b
    d_f = done.to(torch.float32)
    w_f = (done & (ep_ret > 0.0)).to(torch.float32)
    srow = torch.stack([
        d_f * (1 - pool_f), w_f * (1 - pool_f), d_f * pool_f, w_f * pool_f,
        torch.where(done, ep_ret, 0.0), d_f,
        (done & (ep_ret == 0.0)).to(torch.float32), torch.zeros_like(d_f)])
    u = [hash_u01(mix_env, ctr + 8, k, 0, lane) for k in (1, 2, 3, 4)]
    svx, svy, ssp = serve_from_uniforms(env_params, *u)
    zi = torch.zeros_like(new.t)
    st = EnvState(
        ball_x=torch.where(done, 0.5, new.ball_x),
        ball_y=torch.where(done, 0.5, new.ball_y),
        ball_vx=torch.where(done, svx, new.ball_vx),
        ball_vy=torch.where(done, svy, new.ball_vy),
        spin=torch.where(done, ssp, new.spin),
        top_paddle_x=torch.where(done, 0.5, new.top_paddle_x),
        bottom_paddle_x=torch.where(done, 0.5, new.bottom_paddle_x),
        score_a=torch.where(done, zi, new.score_a),
        score_b=torch.where(done, zi, new.score_b),
        bounce_count=torch.where(done, zi, new.bounce_count),
        t=torch.where(done, zi, new.t),
        done=torch.zeros_like(done),
    )
    return out.obs_b, out.reward_b, done, srow, st, torch.where(
        done, 0.0, ep_ret)


def explore_plain(mix_env, lane, ctr: int, eps_i: int, greedy):
    """Epsilon-greedy of the rollout kernels: hash draws (k 5, 6) per env
    against ``eps = eps_i * 1e-6``."""
    eps = float(np.float32(eps_i) * np.float32(1e-6))
    u_expl = hash_u01(mix_env, ctr, 5, 0, lane)
    rand_a = torch.clamp((hash_u01(mix_env, ctr, 6, 0, lane) * 3.0)
                         .to(torch.int32), 0, 2)
    return torch.where(u_expl < eps, rand_a, greedy)


def actor_rollout_plain(env_params: EnvParams, state: EnvState, opp_idx,
                        ep_return, learner: PackedQNet, opponents: PackedQNet,
                        *, seed: int, eps_i: int, steps: int,
                        max_episode_steps: int, tile_rows: int,
                        emit_transitions: bool, shared_trunk: bool,
                        tile0: int = 0):
    """Step-by-step version of the kernel. Returns ``(state, ep_return,
    transitions or None, stats (8, B))`` with transitions as five
    ``(T, B[, 7])`` tensors ``obs, action, reward, next_obs, done``."""
    dev = state.ball_x.device
    B = state.ball_x.shape[0]
    env = torch.arange(B, device=dev)
    tile = env // tile_rows
    lane = env % tile_rows
    mix_tiles = tile_seed_mix(seed, B // tile_rows, dev, tile0)
    mix_env = mix_tiles[tile]
    rows, cols = _noise_grid(dev)
    pool_f = (opp_idx > 0).to(torch.float32)
    lw = learner

    st = state
    ret = ep_return
    stats = torch.zeros((8, B), dtype=torch.float32, device=dev)
    tr = {k: [] for k in ("obs", "action", "reward", "next_obs", "done")}
    for s in range(steps):
        ctr = s * 16
        # learner head noise: one factorized draw per (tile, step)
        sn = hash_noise(mix_tiles[:, None], ctr, 1, 2, rows, cols)
        ein, eout = sn[:, :HIDDEN], sn[:, HIDDEN:]
        wa = lw.wat_mu[:3] + lw.wat_sigma[:3] * (eout[:, :, None]
                                                 * ein[:, None, :])
        ba = lw.bat_mu[:3, 0] + lw.bat_sigma[:3, 0] * eout

        obs7 = torch.stack([st.ball_x, st.ball_y, st.ball_vx, st.ball_vy,
                            st.bottom_paddle_x, st.top_paddle_x, st.spin], -1)
        act_a = argmax3(_opponent_adv(opponents, obs7, opp_idx, shared_trunk))
        h2 = _trunk(lw.w1t, lw.b1t, lw.w2t, lw.b2t, obs7)
        greedy_b = argmax3(torch.einsum("bh,bah->ba", h2, wa[tile])
                           + ba[tile])
        act_b = explore_plain(mix_env, lane, ctr, eps_i, greedy_b)

        obs_next, reward, done, srow, st, ret = env_step_plain(
            env_params, st, ret, act_a, act_b, mix_env, lane, ctr,
            max_episode_steps, pool_f)
        if emit_transitions:
            tr["obs"].append(obs7)
            tr["next_obs"].append(obs_next)
            tr["action"].append(act_b)
            tr["reward"].append(reward)
            tr["done"].append(done)
        stats += srow
    trans = ({k: torch.stack(v) for k, v in tr.items()}
             if emit_transitions else None)
    return st, ret, trans, stats


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "actor_rollout", "actor_rollout_launch",
    [ctypes.POINTER(EnvConsts), _vp, _vp, _vp, _vp, _i, _vp, _vp,
     _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, ctypes.c_uint, _i,
     _vp],
)


def actor_rollout_launch(env_params: EnvParams, f_in, i_in, learner,
                         opponents, *, seed: int, eps_i: int, steps: int,
                         max_episode_steps: int, tile_rows: int,
                         emit_transitions: bool, shared_trunk: bool,
                         tile0: int = 0):
    """Launch the CUDA kernel on its own operands, with no read of device
    data: ``f_in (8, B)`` (ball x, y, vx, vy, bottom and top paddle, spin,
    episode return), ``i_in (5, B)`` (scores A and B, bounces, t, opponent
    slot), ``learner (NET,)`` and ``opponents (S, NET)`` in
    :func:`packed_flat`'s layout. The caller vouches that every slot lies
    in ``[0, S)``. Returns ``(f_out, i_out, transitions or None,
    stats (8, B))``; ``f_out`` and ``i_out`` are the next chunk's ``f_in``
    and ``i_in`` (the kernel writes the slot row back)."""
    if tile_rows % CUDA_ENVS:
        raise ValueError(f"tile_rows {tile_rows} must be a multiple of "
                         f"{CUDA_ENVS} on the card")
    dev = f_in.device
    B = f_in.shape[-1]
    check_cuda("learner", learner, torch.float32, (NET,))
    check_cuda("opponents", opponents, torch.float32,
               (opponents.shape[0], NET))
    check_cuda("f_in", f_in, torch.float32, (8, B))
    check_cuda("i_in", i_in, torch.int32, (5, B))
    f_out = torch.empty_like(f_in)
    i_out = torch.empty_like(i_in)
    stats = torch.empty((8, B), dtype=torch.float32, device=dev)
    if emit_transitions:
        obs = torch.empty((steps, B, 7), dtype=torch.float32, device=dev)
        nxt = torch.empty_like(obs)
        act = torch.empty((steps, B), dtype=torch.int32, device=dev)
        rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
        dn = torch.empty((steps, B), dtype=torch.int32, device=dev)
        tr_ptrs = [ptr(t) for t in (obs, nxt, act, rew, dn)]
    else:
        tr_ptrs = [None] * 5
    consts = EnvConsts.build(env_params, max_episode_steps)
    KERNEL.launch(ctypes.byref(consts), ptr(f_in), ptr(i_in), ptr(learner),
                  ptr(opponents), int(shared_trunk), ptr(f_out), ptr(i_out),
                  *tr_ptrs, ptr(stats), B, steps, tile_rows, tile0,
                  seed & _M32, eps_i, stream_ptr(dev))
    trans = None
    if emit_transitions:
        trans = {"obs": obs, "action": act, "reward": rew, "next_obs": nxt,
                 "done": dn.bool()}
    return f_out, i_out, trans, stats


def slot_range(opp_idx: torch.Tensor) -> torch.Tensor:
    """``[min, max] (2,)`` of the slots, on their device."""
    return torch.stack(torch.aminmax(opp_idx))


def check_slot_range(lo: int, hi: int, n_slots: int) -> None:
    """Raise unless every slot of a chunk lay in ``[0, n_slots)``."""
    if lo < 0 or hi >= n_slots:
        raise ValueError(f"opp_idx outside [0, {n_slots})")


def as_flat(net) -> torch.Tensor:
    """A :class:`PackedQNet` (or stack) in :func:`packed_flat`'s layout;
    a tensor is taken as already in it."""
    return net if isinstance(net, torch.Tensor) else packed_flat(net)


def as_packed(net) -> PackedQNet:
    """:func:`as_flat`'s counterpart for the plain version."""
    return unpack_flat(net) if isinstance(net, torch.Tensor) else net


def actor_rollout_cuda(env_params: EnvParams, state: EnvState, opp_idx,
                       ep_return, learner, opponents, *, seed: int,
                       eps_i: int, steps: int, max_episode_steps: int,
                       tile_rows: int, emit_transitions: bool,
                       shared_trunk: bool, tile0: int = 0,
                       check_slots: bool = True):
    """Launch the CUDA kernel on the nets packed or already flat (see
    :func:`as_flat`); same contract as :func:`actor_rollout_plain`
    (``opp_idx`` is returned unchanged by both). The launch reads every
    slot clamped into the stack. With ``check_slots`` the call then waits,
    after the launch, for the copy of the slots' range only (one read of
    device data) and raises for a slot outside the stack; without it the
    call reads nothing and the caller checks the range
    (:func:`slot_range`, :func:`check_slot_range`)."""
    B = state.ball_x.shape[0]
    lw, ow = as_flat(learner), as_flat(opponents)
    n_slots = ow.shape[0]
    check_cuda("opp_idx", opp_idx, torch.int32, (B,))
    f_in = torch.stack([state.ball_x, state.ball_y, state.ball_vx,
                        state.ball_vy, state.bottom_paddle_x,
                        state.top_paddle_x, state.spin, ep_return])
    i_in = torch.stack([state.score_a, state.score_b, state.bounce_count,
                        state.t, opp_idx.clamp(0, n_slots - 1)])
    if check_slots:
        slots = Readout(slot_range(opp_idx))
    f_out, i_out, trans, stats = actor_rollout_launch(
        env_params, f_in, i_in, lw, ow, seed=seed, eps_i=eps_i, steps=steps,
        max_episode_steps=max_episode_steps, tile_rows=tile_rows,
        emit_transitions=emit_transitions, shared_trunk=shared_trunk,
        tile0=tile0)
    if check_slots:
        check_slot_range(*slots.wait()[0].tolist(), n_slots)
    new_state = EnvState(
        ball_x=f_out[0], ball_y=f_out[1], ball_vx=f_out[2], ball_vy=f_out[3],
        bottom_paddle_x=f_out[4], top_paddle_x=f_out[5], spin=f_out[6],
        score_a=i_out[0], score_b=i_out[1], bounce_count=i_out[2],
        t=i_out[3], done=torch.zeros((B,), dtype=torch.bool,
                                     device=f_out.device),
    )
    return new_state, f_out[7], trans, stats


def actor_rollout_rows(env_params: EnvParams, f_in, i_in, learner,
                       opponents, *, seed: int, eps_i: int, steps: int,
                       max_episode_steps: int, tile_rows: int,
                       shared_trunk: bool = False):
    """One chunk without transitions on the kernel's own operands (see
    :func:`actor_rollout_launch`): the launch for CUDA tensors, the plain
    version on :func:`unpack_flat`'s fields for CPU tensors. Returns
    ``(f_out, i_out, stats (8, B))``."""
    kw = dict(seed=int(seed), eps_i=eps_i, steps=steps,
              max_episode_steps=int(max_episode_steps), tile_rows=tile_rows,
              emit_transitions=False, shared_trunk=bool(shared_trunk))
    if f_in.is_cuda:
        f_out, i_out, _, stats = actor_rollout_launch(
            env_params, f_in, i_in, learner, opponents, **kw)
        return f_out, i_out, stats
    state = EnvState(
        ball_x=f_in[0], ball_y=f_in[1], ball_vx=f_in[2], ball_vy=f_in[3],
        bottom_paddle_x=f_in[4], top_paddle_x=f_in[5], spin=f_in[6],
        score_a=i_in[0], score_b=i_in[1], bounce_count=i_in[2], t=i_in[3],
        done=torch.zeros(f_in.shape[-1:], dtype=torch.bool))
    st, ret, _, stats = actor_rollout_plain(
        env_params, state, i_in[4], f_in[7], unpack_flat(learner),
        unpack_flat(opponents), **kw)
    f_out = torch.stack([st.ball_x, st.ball_y, st.ball_vx, st.ball_vy,
                         st.bottom_paddle_x, st.top_paddle_x, st.spin, ret])
    i_out = torch.stack([st.score_a, st.score_b, st.bounce_count, st.t,
                         i_in[4]])
    return f_out, i_out, stats


def actor_rollout(env_params: EnvParams, state: EnvState, opp_idx,
                  ep_return, learner, opponents, *, seed: int,
                  epsilon: float, steps: int, max_episode_steps: int = 0,
                  tile_rows: int = 512, tile0: int = 0,
                  emit_transitions: bool = True,
                  member_shared_trunk: bool = False,
                  check_slots: bool = True):
    """One rollout chunk. ``state`` is batched ``(B,)``, ``opp_idx (B,)``
    i32 binds each env to a slot of the stacked ``opponents`` (fixed for
    the chunk; callers sort or bucket envs by slot), ``learner`` is one
    unmirrored net, ``opponents`` mirror-folded. ``member_shared_trunk``
    promises that every slot has slot 0's feature trunk (checked by the
    caller, ``train/dqn.py::DQNLearner.prepare_opponents``). ``tile0`` is
    the global index of the first tile (a rank's block of a data-parallel
    batch; 0 for a whole batch). ``learner`` and ``opponents`` are
    :class:`PackedQNet` packs or already in :func:`packed_flat`'s layout.
    ``check_slots=False`` leaves the slots' range check on the card to the
    caller, so that the call reads nothing (:func:`actor_rollout_cuda`).

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors. Returns ``(state, opp_idx, ep_return, transitions,
    stat_counts, ret_sum, ended)`` as the JAX function does: transitions
    a dict of ``(T, B[, 7])`` tensors (None when ``emit_transitions`` is
    False), ``stat_counts`` i32 ``[games_vs_a, wins_vs_a, games_vs_pool,
    wins_vs_pool, draws]``, ``ended (B,)`` bool = finished at least one
    episode in the chunk."""
    B = state.ball_x.shape[0]
    if B % tile_rows:
        raise ValueError(f"batch {B} must be a multiple of {tile_rows}")
    kw = dict(seed=int(seed), eps_i=epsilon_to_int(epsilon), steps=steps,
              max_episode_steps=int(max_episode_steps), tile_rows=tile_rows,
              tile0=int(tile0), emit_transitions=emit_transitions,
              shared_trunk=bool(member_shared_trunk))
    if state.ball_x.is_cuda:
        new_state, ret, trans, stats = actor_rollout_cuda(
            env_params, state, opp_idx, ep_return, learner, opponents, **kw,
            check_slots=check_slots)
    else:
        new_state, ret, trans, stats = actor_rollout_plain(
            env_params, state, opp_idx, ep_return, as_packed(learner),
            as_packed(opponents), **kw)
    totals = stats.sum(dim=1)
    # rows 0-3 and 6 by slices: a list index is copied to the card, waiting
    stat_counts = torch.cat([totals[0:4], totals[6:7]]).to(torch.int32)
    return (new_state, opp_idx, ret, trans, stat_counts, totals[4],
            stats[5] > 0.0)
