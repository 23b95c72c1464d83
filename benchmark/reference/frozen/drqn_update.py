"""Frozen copy of ``pingpong_tpu_torch/ops/drqn_update.py`` (kernel 4's plain
version: the recurrent Double-DQN loss, its backward, clipping, Adam), as
the port had it when the benchmark was written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import math

import torch

from .qnet_rnn import QNetRNN, QNetRNNNoise
from .optim import B2, adam_, clip_by_global_norm


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def param_slices(dims):
    """Name -> (offset, shape) of every tensor of the flat QNetRNN vector
    (``ravel_pytree`` order), for widths ``(F1, F, H, HH)``."""
    F1, F, H, HH = dims
    shapes = [("w1", (7, F1)), ("b1", (F1,)), ("w2", (F1, F)), ("b2", (F,)),
              ("wih", (F, 4 * H)), ("whh", (H, 4 * H)), ("bih", (4 * H,)),
              ("bhh", (4 * H,)), ("ws", (H, HH)), ("wss", (H, HH)),
              ("bs", (HH,)), ("bss", (HH,)), ("wv", (HH, 1)), ("wvs", (HH, 1)),
              ("bv", (1,)), ("bvs", (1,)), ("wa", (HH, 3)), ("was", (HH, 3)),
              ("ba", (3,)), ("bas", (3,))]
    out, o = {}, 0
    for name, shape in shapes:
        out[name] = (o, shape)
        o += math.prod(shape)
    out["n"] = (o, ())
    return out


def noise_slices(dims):
    """Name -> (offset, shape) of one update's flat noise row."""
    _, _, H, HH = dims
    shapes = [("sw", (H, HH)), ("sb", (HH,)), ("vw", (HH, 1)), ("vb", (1,)),
              ("aw", (HH, 3)), ("ab", (3,))]
    out, o = {}, 0
    for name, shape in shapes:
        out[name] = (o, shape)
        o += math.prod(shape)
    out["n"] = (o, ())
    return out


def _views(flat, slices):
    return {k: flat[..., o:o + math.prod(s)].reshape(flat.shape[:-1] + s)
            for k, (o, s) in slices.items() if k != "n"}


def flat_noise(noise: QNetRNNNoise) -> torch.Tensor:
    """``(K,)``-batched QNetRNNNoise -> ``(K, NN)`` kernel noise rows (a
    net without the shared head has no shared section)."""
    K = noise.v.eps_w.shape[0]
    layers = [noise.v, noise.a] if noise.shared is None else [
        noise.shared, noise.v, noise.a]
    return torch.cat([x.reshape(K, -1) for n in layers
                      for x in (n.eps_w, n.eps_b)], dim=1).contiguous()


def _pad_rows(x, rows):
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def kernel_inputs(obs, next_obs, action, reward, done, valid):
    """The kernels' inputs from K minibatches of ``(K, bs, T, 7)`` traces
    and ``(K, bs)`` last-step fields: ``xt (K, 7, T*2bs)`` obs‖next with
    T-major columns (column ``t*2bs + b``, ``b < bs`` the obs half),
    ``nextt (T, 7, K*bs)`` every update's next-obs (column ``k*bs + b``),
    ``meta (K, 4, bs)`` rows action, reward, done, valid."""
    K, bs, T, _ = obs.shape
    both = torch.cat([obs, next_obs], dim=1)                  # (K, 2bs, T, 7)
    xt = both.permute(0, 3, 2, 1).reshape(K, 7, T * 2 * bs).contiguous()
    nextt = next_obs.permute(2, 3, 0, 1).reshape(T, 7, K * bs).contiguous()
    meta = torch.stack([action.to(torch.float32), reward.to(torch.float32),
                        done.to(torch.float32), valid.to(torch.float32)],
                       dim=1).contiguous()
    return xt, nextt, meta


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _features(P, x):
    """f1, f2 and the input projection ``(w_ih f2 + b_ih) + b_hh`` of
    ``x (7, n)`` columns."""
    f1 = torch.relu(P["w1"].T @ x + P["b1"][:, None])
    f2 = torch.relu(P["w2"].T @ f1 + P["b2"][:, None])
    xp = (P["wih"].T @ f2 + P["bih"][:, None]) + P["bhh"][:, None]
    return f1, f2, xp


def _lstm(P, xp, T, n, store):
    H = P["whh"].shape[0]
    h = xp.new_zeros((H, n))
    c = xp.new_zeros((H, n))
    acts = []
    for t in range(T):
        g = xp[:, t * n:(t + 1) * n] + P["whh"].T @ h
        i = torch.sigmoid(g[0:H])
        f = torch.sigmoid(g[H:2 * H])
        gg = torch.tanh(g[2 * H:3 * H])
        o = torch.sigmoid(g[3 * H:4 * H])
        c_new = f * c + i * gg
        h_new = o * torch.tanh(c_new)
        if store:
            acts.append((i, f, gg, o, c, c_new, h))
        h, c = h_new, c_new
    return h, acts


def _q(s, wv, bv, wa, ba):
    """Dueling Q ``(3, n)`` from the shared head's output ``s (HH, n)``."""
    v = wv.T @ s + bv[:, None]
    a = wa.T @ s + ba[:, None]
    return (v + a) - (a[0:1] + a[1:2] + a[2:3]) / 3.0


def _target_q(P, x, T, n):
    """Target Q(s') ``(3, n)`` (mu weights) of ``x (7, T*n)`` columns
    ``t*n + col``."""
    _, _, xp = _features(P, x)
    h, _ = _lstm(P, xp, T, n, store=False)
    s = torch.relu(P["ws"].T @ h + P["bs"][:, None])
    return _q(s, P["wv"], P["bv"], P["wa"], P["ba"])


def _argmax_rows(q):
    """Argmax over the 3 rows of ``(3, n)``, ties to the lowest index."""
    i01 = (q[1] > q[0]).long()
    return torch.where(q[2] > torch.maximum(q[0], q[1]), 2, i01)


def drqn_grad(P, E, nz, x, meta, qt_k, T, bs, gamma):
    """One update's loss and flat gradient, the kernel's hand backward.
    ``P``/``E``/``nz``: views of the parameters, the effective noisy heads
    and the noise; ``x (7, T*2bs)``; ``meta (4, bs)``; ``qt_k (3, bs)``
    the target's Q(s')."""
    B2 = 2 * bs
    f1, f2, xp = _features(P, x)
    h_T, acts = _lstm(P, xp, T, B2, store=True)
    s_pre = E["sw"].T @ h_T + E["sb"][:, None]
    s = torch.relu(s_pre)
    q = _q(s, E["vw"], E["vb"], E["aw"], E["ab"])
    q_s, q_ns = q[:, :bs], q[:, bs:]
    act, rew, done, w = meta[0].long(), meta[1], meta[2], meta[3]
    ar = torch.arange(bs, device=x.device)
    nq = qt_k[_argmax_rows(q_ns), ar]
    y = rew + gamma * nq * (1.0 - done)
    td = q_s[act, ar] - y
    huber = torch.where(td.abs() <= 1.0, 0.5 * td * td, td.abs() - 0.5)
    denom = torch.clamp(w.sum(), min=1.0)
    loss = (w * huber).sum() / denom

    # heads (obs half; the next half's gradient is exactly zero)
    dq = w * torch.clamp(td, -1.0, 1.0) / denom
    dv = dq
    da = torch.nn.functional.one_hot(act, 3).T.to(dq.dtype) * dq - dq / 3.0
    so = s[:, :bs]
    g = {}
    g["wv"] = (so @ dv)[:, None]
    g["bv"] = dv.sum()[None]
    g["wa"] = so @ da.T
    g["ba"] = da.sum(dim=1)
    ds = E["vw"] * dv[None, :] + E["aw"] @ da
    ds_pre = ds * (s_pre[:, :bs] > 0.0)
    g["ws"] = h_T[:, :bs] @ ds_pre.T
    g["bs"] = ds_pre.sum(dim=1)
    dh = E["sw"] @ ds_pre
    # BPTT
    dc = torch.zeros_like(dh)
    dgs = [None] * T
    for t in range(T - 1, -1, -1):
        i, f, gg, o, c_prev, c_new, _ = (a[:, :bs] for a in acts[t])
        tc = torch.tanh(c_new)
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        dgs[t] = torch.cat([dc * gg * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - gg * gg),
                            do * o * (1.0 - o)], dim=0)
        dh = P["whh"] @ dgs[t]
        dc = dc * f
    dg = torch.cat(dgs, dim=1)                                # (4H, T*bs)
    obs_cols = (torch.arange(T, device=x.device)[:, None] * B2
                + torch.arange(bs, device=x.device)[None, :]).reshape(-1)
    h_prev = torch.cat([acts[t][6][:, :bs] for t in range(T)], dim=1)
    g["whh"] = h_prev @ dg.T
    g["bih"] = dg.sum(dim=1)
    g["bhh"] = g["bih"]
    f2o, f1o, xo = f2[:, obs_cols], f1[:, obs_cols], x[:, obs_cols]
    g["wih"] = f2o @ dg.T
    dz2 = (P["wih"] @ dg) * (f2o > 0.0)
    g["w2"] = f1o @ dz2.T
    g["b2"] = dz2.sum(dim=1)
    dz1 = (P["w2"] @ dz2) * (f1o > 0.0)
    g["w1"] = xo @ dz1.T
    g["b1"] = dz1.sum(dim=1)
    for mu, sig, n in (("ws", "wss", "sw"), ("bs", "bss", "sb"),
                       ("wv", "wvs", "vw"), ("bv", "bvs", "vb"),
                       ("wa", "was", "aw"), ("ba", "bas", "ab")):
        g[sig] = g[mu] * nz[n]
    return loss, g


def drqn_update_plain(*, ts0, count0, xt, nextt, meta, noise, params, target,
                      m, v, dims, K, bs, T, lr, clip, gamma, interval, tau):
    """Step-by-step version of the kernel (in place on ``params, target,
    m, v``). Returns ``losses (K,)``."""
    ps = param_slices(dims)
    ns = noise_slices(dims)
    P, Tg = _views(params, ps), _views(target, ps)
    grad = torch.zeros_like(params)
    G = _views(grad, ps)
    qt = params.new_zeros((K, 3, bs))
    losses = []
    for k in range(K):
        if tau > 0.0 or (ts0 % interval) + k >= interval:
            x = xt[k].reshape(7, T, 2 * bs)[:, :, bs:].reshape(7, T * bs)
            qt[k] = _target_q(Tg, x, T, bs)
        elif k == 0:
            q_all = _target_q(Tg, nextt.permute(1, 0, 2).reshape(7, -1), T,
                              K * bs)
            qt.copy_(q_all.reshape(3, K, bs).transpose(0, 1))
        nz = _views(noise[k], ns)
        E = {"sw": P["ws"] + P["wss"] * nz["sw"],
             "sb": P["bs"] + P["bss"] * nz["sb"],
             "vw": P["wv"] + P["wvs"] * nz["vw"],
             "vb": P["bv"] + P["bvs"] * nz["vb"],
             "aw": P["wa"] + P["was"] * nz["aw"],
             "ab": P["ba"] + P["bas"] * nz["ab"]}
        loss, g = drqn_grad(P, E, nz, xt[k], meta[k], qt[k], T, bs, gamma)
        for name, val in g.items():
            G[name].copy_(val.reshape(G[name].shape))
        losses.append(loss)
        # clip_by_global_norm + flat Adam + target sync
        adam_(params, clip_by_global_norm(grad, clip), m, v, count0 + k + 1,
              lr)
        if tau > 0.0:
            target.copy_(target + tau * (params - target))
        elif (ts0 + k + 1) % interval == 0:
            target.copy_(params)
    return torch.stack(losses)


# ---------------------------------------------------------------------------
# CUDA kernel


def drqn_update_block(*, train_steps: int, adam_count: int, obs, next_obs,
                      action, reward, done, valid, noise, params, target, m,
                      v, dims, lr: float, clip: float, gamma: float,
                      interval: int, tau: float):
    """The plain version behind the program's dispatcher: K updates on
    ``obs``/``next_obs (K, bs, T, 7)`` and the last-step fields ``(K,
    bs)``, in place on ``params``, ``target``, ``m`` and ``v``. Returns
    each update's loss ``(K,)``."""
    K, bs, T, _ = obs.shape
    xt, nextt, meta = kernel_inputs(obs, next_obs, action, reward, done,
                                    valid)
    return drqn_update_plain(
        ts0=int(train_steps), count0=int(adam_count), xt=xt, nextt=nextt,
        meta=meta, noise=noise.contiguous(), params=params, target=target,
        m=m, v=v, dims=tuple(dims), K=K, bs=bs, T=T, lr=lr, clip=clip,
        gamma=gamma, interval=interval, tau=tau)
