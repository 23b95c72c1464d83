"""Frozen copy of ``pingpong_tpu_torch/ops/recurrent_rollout.py`` (kernel 3's
plain version and the packing it reads), as the port had it when the
benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from .env import EnvParams, EnvState
from .qnet import argmax3
from .qnet_rnn import QNetRNN
from .actor import (
    _MIRROR,
    NEG_BIG,
    env_step_plain,
    epsilon_to_int,
    explore_plain,
    hash_noise,
)
from .hashrng import tile_seed_mix

MAX_WIDTH = 128       # every width the kernel takes
CUDA_ENVS = 8         # the fewest envs a CUDA block takes; tile_rows must be
                      # a multiple
                      # starts on 128 bytes (bulk copies need 16)


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


def packed_dims(p: PackedQNetRNN):
    """(F1, F, H, HH) of a packed net."""
    return (p.w1t.shape[-2], p.w2t.shape[-2], p.wght.shape[-2] // 4,
            p.wst.shape[-2])


# ---------------------------------------------------------------------------
# Blocks of one opponent: the kernel's env lists
# ---------------------------------------------------------------------------


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
                            emit_transitions: bool, tile0: int = 0):
    """Step-by-step version of the kernel. Returns ``(state, ep_return,
    hid (4H, B), transitions or None, stats (8, B))`` with transitions as
    four ``(T, B[, 7])`` tensors ``obs, action, reward, done``."""
    dev = state.ball_x.device
    B = state.ball_x.shape[0]
    dims = packed_dims(learner)
    H = dims[2]
    env = torch.arange(B, device=dev)
    lane = env % tile_rows
    mix_tiles = tile_seed_mix(seed, B // tile_rows, dev, tile0)
    mix_env = mix_tiles[env // tile_rows]
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


def recurrent_rollout(env_params: EnvParams, state: EnvState, opp_idx,
                      ep_return, hid, learner: PackedQNetRNN,
                      sigma: RNNSigma, opponents: PackedQNetRNN, *,
                      seed: int, epsilon: float, steps: int,
                      max_episode_steps: int = 0, tile_rows: int = 512,
                      tile0: int = 0, emit_transitions: bool = True):
    """The plain version behind the program's dispatcher, with its
    returns: ``(state, opp_idx, ep_return, hid, transitions, stat_counts,
    ret_sum, ended)``."""
    B = state.ball_x.shape[0]
    if B % tile_rows:
        raise ValueError(f"batch {B} must be a multiple of {tile_rows}")
    new_state, ret, hid_out, trans, stats = recurrent_rollout_plain(
        env_params, state, opp_idx, ep_return, hid, learner, sigma,
        opponents, seed=int(seed), eps_i=epsilon_to_int(epsilon),
        steps=steps, max_episode_steps=int(max_episode_steps),
        tile_rows=tile_rows, tile0=int(tile0),
        emit_transitions=emit_transitions)
    totals = stats.sum(dim=1)
    stat_counts = totals[[0, 1, 2, 3, 6]].to(torch.int32)
    return (new_state, opp_idx, ret, hid_out, trans, stat_counts, totals[4],
            stats[5] > 0.0)
