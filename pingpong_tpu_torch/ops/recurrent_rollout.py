"""Fused DRQN actor rollout: a whole recurrent rollout chunk in one CUDA
launch.

Port of ``pingpong_tpu/ops/recurrent_rollout.py::pallas_recurrent_rollout``.
Per env and step: the bound opponent's recurrent forward (mu weights;
player A's mirrored view folded into the first layer by
:func:`pack_qnet_rnn`), the learner's recurrent forward with this step's
factorized noise on the shared and A heads (the V head is argmax-invariant
and skipped), epsilon-greedy, the env step with auto-reset, the zero-reset
of both LSTM streams on ``done``, the emission of obs / action / reward /
done (``next_obs`` is derived by the sequence ring) and the per-env
statistics. Hidden states travel as one ``(4H, B)`` block ``[h_b; c_b;
h_opp; c_opp]``, the JAX function's layout.

Two versions compute the same function:

* :func:`recurrent_rollout_plain`, step by step in PyTorch. It runs for
  tensors on the CPU (the tests hold it against the JAX kernel in
  interpret mode), and ``chip_smoke.py`` holds the kernel against it on
  the card;
* the CUDA kernel ``csrc/recurrent_rollout.cu``, launched for tensors on
  the card. There is no fallback between the two.

Random draws follow the JAX kernel's interpret path (``_rnn_kernel``):
the counter hash with ``seed_mix = seed ^ (tile * 747796405)`` and
``ctr = 16 * step``; the learner noise of a step is one factorized draw
shared by a tile of ``tile_rows`` envs (``_draw_noise``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Union

import torch

from pingpong_tpu_torch.env.pong import EnvParams, EnvState
from pingpong_tpu_torch.models.qnet import argmax3
from pingpong_tpu_torch.models.qnet_rnn import QNetRNN
from pingpong_tpu_torch.ops.actor_rollout import (
    _MIRROR,
    NEG_BIG,
    env_step_plain,
    epsilon_to_int,
    explore_plain,
    hash_noise,
)
from pingpong_tpu_torch.ops.build import (
    CudaKernel,
    check_cuda,
    ptr,
    stream_ptr,
)
from pingpong_tpu_torch.ops.pong_kernel import _M32, EnvConsts, tile_seed_mix

MAX_WIDTH = 128       # every width the kernel takes
CUDA_ENVS = 8         # envs per CUDA block; tile_rows must be a multiple


class PackedQNetRNN(NamedTuple):
    """Transposed, padded mu weights of one QNetRNN, or a stack of them
    with a leading slot axis: the JAX package's layout. The V head is
    omitted; the LSTM biases are pre-summed (``bgt = b_ih + b_hh``); rows
    3-7 of the A head are padding, their ``bat`` -1e30."""

    w1t: torch.Tensor    # (..., F1, 8)
    b1t: torch.Tensor    # (..., F1, 1)
    w2t: torch.Tensor    # (..., F, F1)
    b2t: torch.Tensor    # (..., F, 1)
    wght: torch.Tensor   # (..., 4H, F+H)  [w_ih | w_hh]
    bgt: torch.Tensor    # (..., 4H, 1)
    wst: torch.Tensor    # (..., HH, H)   shared noisy mu
    bst: torch.Tensor    # (..., HH, 1)
    wat: torch.Tensor    # (..., 8, HH)
    bat: torch.Tensor    # (..., 8, 1)


class RNNSigma(NamedTuple):
    """The learner's noisy sigmas (opponents run mu only)."""

    wst_sigma: torch.Tensor  # (HH, H)
    bst_sigma: torch.Tensor  # (HH, 1)
    wat_sigma: torch.Tensor  # (8, HH)
    bat_sigma: torch.Tensor  # (8, 1)


def _pad_rows(x, rows, fill=0.0):
    out = torch.full((rows,) + tuple(x.shape[1:]), fill, dtype=torch.float32,
                     device=x.device)
    out[:x.shape[0]] = x
    return out


def pack_qnet_rnn(params: Union[QNetRNN, Sequence[QNetRNN]],
                  mirror: bool = False) -> PackedQNetRNN:
    """Pad and transpose one QNetRNN, or stack a sequence of them along a
    new leading slot axis. ``mirror=True`` folds player A's view into the
    first feature layer, so the net consumes player B's observation."""
    if not isinstance(params, QNetRNN):
        packs = [pack_qnet_rnn(p, mirror) for p in params]
        return PackedQNetRNN(*(torch.stack(f) for f in zip(*packs)))
    if len(params.lstm) != 1 or params.shared is None:
        raise ValueError("the recurrent kernel takes lstm_layers=1 with a "
                         "shared head")
    w1t = _pad_rows(params.feat1.w.detach(), 8).T.contiguous()   # (F1, 8)
    b1t = params.feat1.b.detach()[:, None].clone()
    if mirror:
        # w1t @ obs_a == (w1t @ M) @ obs_b + w1t[:, y]
        b1t = b1t + w1t[:, 1:2]
        w1t = w1t @ torch.as_tensor(_MIRROR, device=w1t.device)
    lstm = params.lstm[0]
    return PackedQNetRNN(
        w1t=w1t,
        b1t=b1t,
        w2t=params.feat2.w.detach().T.contiguous(),
        b2t=params.feat2.b.detach()[:, None].clone(),
        wght=torch.cat([lstm.w_ih.detach().T, lstm.w_hh.detach().T], dim=1),
        bgt=(lstm.b_ih.detach() + lstm.b_hh.detach())[:, None],
        wst=params.shared.w_mu.detach().T.contiguous(),
        bst=params.shared.b_mu.detach()[:, None].clone(),
        wat=_pad_rows(params.fc_a.w_mu.detach().T, 8),
        bat=_pad_rows(params.fc_a.b_mu.detach()[:, None], 8, fill=NEG_BIG),
    )


def pack_rnn_sigma(params: QNetRNN) -> RNNSigma:
    return RNNSigma(
        wst_sigma=params.shared.w_sigma.detach().T.contiguous(),
        bst_sigma=params.shared.b_sigma.detach()[:, None].clone(),
        wat_sigma=_pad_rows(params.fc_a.w_sigma.detach().T, 8),
        bat_sigma=_pad_rows(params.fc_a.b_sigma.detach()[:, None], 8),
    )


def supports_kernel(dims) -> bool:
    """Whether the kernel takes these (F1, F, H, HH) widths."""
    return max(dims) <= MAX_WIDTH and min(dims) > 0


def packed_dims(p: PackedQNetRNN):
    """(F1, F, H, HH) of a packed net."""
    return (p.w1t.shape[-2], p.w2t.shape[-2], p.wght.shape[-2] // 4,
            p.wst.shape[-2])


def rnn_kernel_flat(p: PackedQNetRNN) -> torch.Tensor:
    """``(..., NET)`` contiguous vector per net in the CUDA kernel's layout:
    w1 (F1, 8), b1, w2 (F1, F), b2, wg (F+H, 4H), bg, ws (H, HH), bs,
    wa (3, HH), ba (3) (see ``csrc/recurrent_rollout.cu``)."""
    lead = p.w1t.shape[:-2]
    t = lambda x: x.transpose(-1, -2)
    fields = [p.w1t, p.b1t, t(p.w2t), p.b2t, t(p.wght), p.bgt, t(p.wst),
              p.bst, p.wat[..., :3, :], p.bat[..., :3, :]]
    return torch.cat([f.reshape(lead + (-1,)) for f in fields],
                     dim=-1).contiguous()


def sigma_kernel_flat(s: RNNSigma) -> torch.Tensor:
    """The learner's sigmas in the kernel's layout: ws (H, HH), bs,
    wa (3, HH), ba (3)."""
    fields = [s.wst_sigma.T, s.bst_sigma, s.wat_sigma[:3], s.bat_sigma[:3]]
    return torch.cat([f.reshape(-1) for f in fields]).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _rnn_advantage(w: PackedQNetRNN, obs7, h, c, heads=None):
    """Recurrent forward of one net on ``(B, ·)`` rows: ``(adv (B, 3), h',
    c')``. ``heads`` replaces the mu shared and A heads with one per tile
    of envs: ``(ws (tiles, HH, H), bs (tiles, HH), wa (tiles, 3, HH),
    ba (tiles, 3))``."""
    H = h.shape[-1]
    f1 = torch.relu(obs7 @ w.w1t[:, :7].T + w.b1t[:, 0])
    f2 = torch.relu(f1 @ w.w2t.T + w.b2t[:, 0])
    gates = torch.cat([f2, h], dim=-1) @ w.wght.T + w.bgt[:, 0]
    gi = torch.sigmoid(gates[:, 0:H])
    gf = torch.sigmoid(gates[:, H:2 * H])
    gg = torch.tanh(gates[:, 2 * H:3 * H])
    go = torch.sigmoid(gates[:, 3 * H:4 * H])
    c_new = gf * c + gi * gg
    h_new = go * torch.tanh(c_new)
    if heads is None:
        s = torch.relu(h_new @ w.wst.T + w.bst[:, 0])
        adv = s @ w.wat[:3].T + w.bat[:3, 0]
    else:
        ws, bs, wa, ba = heads
        n_tiles = ws.shape[0]
        ht = h_new.reshape(n_tiles, -1, H)
        s = torch.relu(ht @ ws.transpose(1, 2) + bs[:, None])
        adv = (s @ wa.transpose(1, 2) + ba[:, None]).reshape(-1, 3)
    return adv, h_new, c_new


def _learner_heads(lw: PackedQNetRNN, sig: RNNSigma, mix_tiles, ctr, dims):
    """Each tile's noisy shared and A head of one step, ``(tiles, ...)``
    (the JAX kernel's ``_draw_noise``)."""
    _, _, H, HH = dims
    dev = mix_tiles.device
    mix = mix_tiles[:, None]
    ein_s = hash_noise(mix, ctr, 10, 11, 0, torch.arange(H, device=dev))
    ein_a = hash_noise(mix, ctr, 10, 11, 1, torch.arange(HH, device=dev))
    eout_s = hash_noise(mix, ctr, 12, 13, torch.arange(HH, device=dev), 0)
    eout_a = hash_noise(mix, ctr, 12, 13, torch.arange(3, device=dev), 1)
    ws = lw.wst + sig.wst_sigma * (eout_s[:, :, None] * ein_s[:, None, :])
    bs = lw.bst[:, 0] + sig.bst_sigma[:, 0] * eout_s
    wa = lw.wat[:3] + sig.wat_sigma[:3] * (eout_a[:, :, None]
                                           * ein_a[:, None, :])
    ba = lw.bat[:3, 0] + sig.bat_sigma[:3, 0] * eout_a
    return ws, bs, wa, ba


def recurrent_rollout_plain(env_params: EnvParams, state: EnvState, opp_idx,
                            ep_return, hid, learner: PackedQNetRNN,
                            sigma: RNNSigma, opponents: PackedQNetRNN, *,
                            seed: int, eps_i: int, steps: int,
                            max_episode_steps: int, tile_rows: int,
                            emit_transitions: bool):
    """Step-by-step version of the kernel. Returns ``(state, ep_return,
    hid (4H, B), transitions or None, stats (8, B))`` with transitions as
    four ``(T, B[, 7])`` tensors ``obs, action, reward, done``."""
    dev = state.ball_x.device
    B = state.ball_x.shape[0]
    dims = packed_dims(learner)
    H = dims[2]
    env = torch.arange(B, device=dev)
    gtile = env // tile_rows
    lane = env % tile_rows
    mix_tiles = tile_seed_mix(seed, B // tile_rows, dev)
    mix_env = mix_tiles[gtile]
    pool_f = (opp_idx > 0).to(torch.float32)
    members = [int(m) for m in torch.unique(opp_idx).tolist()]
    h_b, c_b, h_o, c_o = (hid[i * H:(i + 1) * H].T for i in range(4))

    st = state
    ret = ep_return
    stats = torch.zeros((8, B), dtype=torch.float32, device=dev)
    tr = {k: [] for k in ("obs", "action", "reward", "done")}
    for s in range(steps):
        ctr = s * 16
        obs7 = torch.stack([st.ball_x, st.ball_y, st.ball_vx, st.ball_vy,
                            st.bottom_paddle_x, st.top_paddle_x, st.spin], -1)
        # the bound opponent: each member present runs over every env and
        # keeps its own envs' results (the TPU kernel's member loop)
        act_a = torch.zeros((B,), dtype=torch.int32, device=dev)
        h_on, c_on = h_o, c_o
        for m in members:
            ow = PackedQNetRNN(*(f[m] for f in opponents))
            adv, h_m, c_m = _rnn_advantage(ow, obs7, h_o, c_o)
            sel = (opp_idx == m)
            act_a = torch.where(sel, argmax3(adv), act_a)
            h_on = torch.where(sel[:, None], h_m, h_on)
            c_on = torch.where(sel[:, None], c_m, c_on)
        ws, bs, wa, ba = _learner_heads(learner, sigma, mix_tiles, ctr, dims)
        adv, h_b, c_b = _rnn_advantage(learner, obs7, h_b, c_b,
                                       (ws, bs, wa, ba))
        act_b = explore_plain(mix_env, lane, ctr, eps_i, argmax3(adv))
        _, reward, done, srow, st, ret = env_step_plain(
            env_params, st, ret, act_a, act_b, mix_env, lane, ctr,
            max_episode_steps, pool_f)
        if emit_transitions:
            tr["obs"].append(obs7)
            tr["action"].append(act_b)
            tr["reward"].append(reward)
            tr["done"].append(done)
        stats += srow
        keep = (~done)[:, None].to(torch.float32)
        h_b, c_b, h_o, c_o = (x * keep for x in (h_b, c_b, h_on, c_on))
    trans = ({k: torch.stack(v) for k, v in tr.items()}
             if emit_transitions else None)
    hid_out = torch.cat([h_b.T, c_b.T, h_o.T, c_o.T], dim=0)
    return st, ret, hid_out, trans, stats


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "recurrent_rollout", "recurrent_rollout_launch",
    [ctypes.POINTER(EnvConsts)] + [_vp] * 14 + [_i, _i, _i, ctypes.c_uint,
                                                 _i, _i, _i, _i, _i, _vp],
)


def recurrent_rollout_cuda(env_params: EnvParams, state: EnvState, opp_idx,
                           ep_return, hid, learner: PackedQNetRNN,
                           sigma: RNNSigma, opponents: PackedQNetRNN, *,
                           seed: int, eps_i: int, steps: int,
                           max_episode_steps: int, tile_rows: int,
                           emit_transitions: bool):
    """Launch the CUDA kernel; same contract as
    :func:`recurrent_rollout_plain`."""
    dev = state.ball_x.device
    B = state.ball_x.shape[0]
    dims = packed_dims(learner)
    F1, F, H, HH = dims
    if not supports_kernel(dims):
        raise ValueError(f"recurrent kernel takes widths <= {MAX_WIDTH}, "
                         f"got {dims}")
    if tile_rows % CUDA_ENVS:
        raise ValueError(f"tile_rows {tile_rows} must be a multiple of "
                         f"{CUDA_ENVS} on the card")
    lw = rnn_kernel_flat(learner)
    sw = sigma_kernel_flat(sigma)
    ow = rnn_kernel_flat(opponents)
    n_slots, net = ow.shape
    check_cuda("learner", lw, torch.float32, (net,))
    check_cuda("sigma", sw, torch.float32, (H * HH + HH + 3 * HH + 3,))
    check_cuda("opp_idx", opp_idx, torch.int32, (B,))
    check_cuda("hid", hid, torch.float32, (4 * H, B))
    lo, hi = torch.aminmax(opp_idx)
    if int(lo) < 0 or int(hi) >= n_slots:
        raise ValueError(f"opp_idx outside [0, {n_slots})")
    f_in = torch.stack([state.ball_x, state.ball_y, state.ball_vx,
                        state.ball_vy, state.bottom_paddle_x,
                        state.top_paddle_x, state.spin, ep_return])
    i_in = torch.stack([state.score_a, state.score_b, state.bounce_count,
                        state.t, opp_idx])
    check_cuda("f_in", f_in, torch.float32, (8, B))
    check_cuda("i_in", i_in, torch.int32, (5, B))
    f_out = torch.empty_like(f_in)
    i_out = torch.empty_like(i_in)
    hid_out = torch.empty_like(hid)
    stats = torch.empty((8, B), dtype=torch.float32, device=dev)
    if emit_transitions:
        obs = torch.empty((steps, B, 7), dtype=torch.float32, device=dev)
        act = torch.empty((steps, B), dtype=torch.int32, device=dev)
        rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
        dn = torch.empty((steps, B), dtype=torch.int32, device=dev)
        tr_ptrs = [ptr(t) for t in (obs, act, rew, dn)]
    else:
        tr_ptrs = [None] * 4
    consts = EnvConsts.build(env_params, max_episode_steps)
    KERNEL.launch(ctypes.byref(consts), ptr(f_in), ptr(i_in), ptr(hid),
                  ptr(lw), ptr(sw), ptr(ow), ptr(f_out), ptr(i_out),
                  ptr(hid_out), *tr_ptrs, ptr(stats), B, steps, tile_rows,
                  seed & _M32, eps_i, F1, F, H, HH, stream_ptr(dev))
    new_state = EnvState(
        ball_x=f_out[0], ball_y=f_out[1], ball_vx=f_out[2], ball_vy=f_out[3],
        bottom_paddle_x=f_out[4], top_paddle_x=f_out[5], spin=f_out[6],
        score_a=i_out[0], score_b=i_out[1], bounce_count=i_out[2],
        t=i_out[3], done=torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    trans = None
    if emit_transitions:
        trans = {"obs": obs, "action": act, "reward": rew, "done": dn.bool()}
    return new_state, f_out[7], hid_out, trans, stats


def recurrent_rollout(env_params: EnvParams, state: EnvState, opp_idx,
                      ep_return, hid, learner: PackedQNetRNN,
                      sigma: RNNSigma, opponents: PackedQNetRNN, *,
                      seed: int, epsilon: float, steps: int,
                      max_episode_steps: int = 0, tile_rows: int = 512,
                      emit_transitions: bool = True):
    """One recurrent rollout chunk. ``state`` is batched ``(B,)``,
    ``opp_idx (B,)`` i32 binds each env to a slot of the stacked
    ``opponents`` (fixed for the chunk; callers bucket envs by slot and
    zero the opponent stream of re-bound envs), ``hid (4H, B)`` carries
    ``[h_b; c_b; h_opp; c_opp]``, ``learner`` is one unmirrored net with
    its ``sigma``, ``opponents`` mirror-folded.

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors. Returns ``(state, opp_idx, ep_return, hid, transitions,
    stat_counts, ret_sum, ended)`` as the JAX function does:
    transitions a dict of ``(T, B[, 7])`` tensors ``obs, action, reward,
    done`` (None when ``emit_transitions`` is False), ``stat_counts`` i32
    ``[games_vs_a, wins_vs_a, games_vs_pool, wins_vs_pool, draws]``,
    ``ended (B,)`` bool = finished at least one episode in the chunk."""
    B = state.ball_x.shape[0]
    if B % tile_rows:
        raise ValueError(f"batch {B} must be a multiple of {tile_rows}")
    kw = dict(seed=int(seed), eps_i=epsilon_to_int(epsilon), steps=steps,
              max_episode_steps=int(max_episode_steps), tile_rows=tile_rows,
              emit_transitions=emit_transitions)
    run = (recurrent_rollout_cuda if state.ball_x.is_cuda
           else recurrent_rollout_plain)
    new_state, ret, hid_out, trans, stats = run(
        env_params, state, opp_idx, ep_return, hid, learner, sigma,
        opponents, **kw)
    totals = stats.sum(dim=1)
    stat_counts = totals[[0, 1, 2, 3, 6]].to(torch.int32)
    return (new_state, opp_idx, ret, hid_out, trans, stat_counts, totals[4],
            stats[5] > 0.0)
