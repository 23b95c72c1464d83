"""Frozen copy of ``pingpong_tpu_torch/ops/dqn_update.py`` (kernel 2's plain
version: the two-level PER sample, the Double-DQN loss and its backward,
Adam, the priority write-back), as the port had it when the benchmark was
written.

The benchmark's reference computes with this copy and never imports the
program; a later change to the program does not change this file.
"""

from __future__ import annotations

import torch

from .qnet import QNetNoise
from .per import exact_cumsum, last_writer_wins
from .optim import adam_

D, H, CH, R = 7, 64, 128, 16
P_W1 = 0
P_B1 = P_W1 + D * H
P_W2 = P_B1 + H
P_B2 = P_W2 + H * H
P_WV = P_B2 + H          # fc_v: w_mu, w_sigma (64, 1), b_mu, b_sigma (1)
P_WA = P_WV + 2 * H + 2  # fc_a: w_mu, w_sigma (64, 3), b_mu, b_sigma (3)
FEATURES_END = P_WV                   # frozen when train_heads_only


def pack_dqn_noise(noise: QNetNoise) -> torch.Tensor:
    """``(K,)``-batched QNetNoise -> ``(K, 260)`` kernel noise rows."""
    k = noise.v.eps_w.shape[0]
    return torch.cat([noise.v.eps_w.reshape(k, -1), noise.v.eps_b,
                      noise.a.eps_w.reshape(k, -1), noise.a.eps_b],
                     dim=1).contiguous()


def _heads(P, noise_k):
    """Effective noisy head weights of one update: wv (64,), bv, wa
    (64, 3), ba (3,)."""
    o = P_WV
    wv = P[o:o + H] + P[o + H:o + 2 * H] * noise_k[0:H]
    bv = P[o + 2 * H] + P[o + 2 * H + 1] * noise_k[H]
    o = P_WA
    wa = (P[o:o + 3 * H] + P[o + 3 * H:o + 6 * H]
          * noise_k[H + 1:4 * H + 1]).view(H, 3)
    ba = P[o + 6 * H:o + 6 * H + 3] + P[o + 6 * H + 3:o + 6 * H + 6] \
        * noise_k[4 * H + 1:]
    return wv, bv, wa, ba


def _trunk(P, x):
    f1 = torch.relu(x @ P[P_W1:P_B1].view(D, H) + P[P_B1:P_W2])
    f2 = torch.relu(f1 @ P[P_W2:P_B2].view(H, H) + P[P_B2:P_WV])
    return f1, f2


def _q(f2, wv, bv, wa, ba):
    v = f2 @ wv + bv
    a = f2 @ wa + ba
    mean = (a[:, 0] + a[:, 1] + a[:, 2]) / 3.0
    return (v[:, None] + a) - mean[:, None]


def _argmax3(q):
    i01 = (q[:, 1] > q[:, 0]).long()
    return torch.where(q[:, 2] > torch.maximum(q[:, 0], q[:, 1]), 2, i01)


def dqn_update_plain(*, ts0, count0, frame0, size, u01, noise, p_alpha,
                     chunk_sums, params, target, m, v, data, K, bs, lr,
                     gamma, interval, tau, alpha, per_eps, beta_start,
                     beta_frames, heads_only, given_idx=None,
                     given_newp=None):
    """Step-by-step version of the kernel (in place on ``p_alpha,
    chunk_sums, params, target, m, v``). Returns ``(newp (K, bs),
    idx (K, bs) i32, losses (K,))``.

    ``given_idx`` and ``given_newp (K, bs)``, the benchmark's one addition
    to the copy: the slots another run of the block sampled and the raw
    priorities it wrote back. Each update then takes those slots in place
    of its own and writes those priorities in place of its own, and
    ``idx`` and ``newp`` return its own, so that the caller can count
    where the two parted."""
    dev = params.device
    nc = chunk_sums.shape[0]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    slope = (1.0 - beta_start) / beta_frames
    pa_rows = p_alpha.view(nc, CH)
    newp_all, idx_all, losses = [], [], []
    for k in range(K):
        # ---- two-level inverse-CDF sample
        # prefix sums exact in double, rounded to float32 once: the
        # kernel's CDF, whatever the summation order
        cdf = exact_cumsum(chunk_sums)
        total = cdf[-1]
        uu = u01[k] * total
        c = torch.clamp((cdf[None, :] < uu[:, None]).sum(dim=1), max=nc - 1)
        c = torch.clamp(c, max=size // CH - 1)
        prev = cdf[torch.clamp(c - 1, min=0)]
        resid = uu - torch.where(c > 0, prev, torch.zeros_like(prev))
        rows = pa_rows[c]
        row_cdf = exact_cumsum(rows, dim=1)
        off = torch.clamp((row_cdf < resid[:, None])
                          .sum(dim=1), max=CH - 1)
        idx = c * CH + off
        own = idx
        if given_idx is not None:
            idx = given_idx[k].long()
            c, off = idx // CH, idx % CH
            rows = pa_rows[c]
        probs = rows[torch.arange(bs, device=dev), off] / torch.clamp(
            total, min=1e-30)
        beta = torch.clamp(beta_start + f32(frame0 + k + 1) * slope, max=1.0)
        w_raw = torch.exp(-beta * torch.log(
            float(size) * torch.clamp(probs, min=1e-30)))
        w = w_raw / torch.clamp(w_raw.max(), min=1e-30)
        fields = data[c, :, off]                        # (bs, 16)
        x, xn = fields[:, :D], fields[:, D:2 * D]
        rew, ad = fields[:, 2 * D], fields[:, 2 * D + 1]
        done = (ad > 3.5).to(torch.float32)
        act = (ad - 4.0 * done).long()

        # ---- Double-DQN TD and IS-weighted MSE
        wv, bv, wa, ba = _heads(params, noise[k])
        _, f2t = _trunk(target, xn)
        q_t = _q(f2t, target[P_WV:P_WV + H], target[P_WV + 2 * H],
                 target[P_WA:P_WA + 3 * H].view(H, 3),
                 target[P_WA + 6 * H:P_WA + 6 * H + 3])
        _, f2n = _trunk(params, xn)
        na = _argmax3(_q(f2n, wv, bv, wa, ba))
        f1, f2 = _trunk(params, x)
        q_s = _q(f2, wv, bv, wa, ba)
        ar = torch.arange(bs, device=dev)
        y = rew + gamma * q_t[ar, na] * (1.0 - done)
        td = q_s[ar, act] - y
        losses.append(torch.sum(w * td * td) * (1.0 / bs))

        # ---- backward
        dq = (2.0 / bs) * w * td
        dV = dq
        dA = torch.nn.functional.one_hot(act, 3).to(torch.float32) \
            * dq[:, None] - (dq / 3.0)[:, None]
        g = torch.zeros_like(params)
        o = P_WV
        g[o:o + H] = f2.T @ dV
        g[o + H:o + 2 * H] = g[o:o + H] * noise[k, 0:H]
        g[o + 2 * H] = dV.sum()
        g[o + 2 * H + 1] = g[o + 2 * H] * noise[k, H]
        o = P_WA
        g[o:o + 3 * H] = (f2.T @ dA).reshape(-1)
        g[o + 3 * H:o + 6 * H] = g[o:o + 3 * H] * noise[k, H + 1:4 * H + 1]
        g[o + 6 * H:o + 6 * H + 3] = dA.sum(dim=0)
        g[o + 6 * H + 3:o + 6 * H + 6] = g[o + 6 * H:o + 6 * H + 3] \
            * noise[k, 4 * H + 1:]
        if not heads_only:
            dz2 = (wv[None, :] * dV[:, None] + dA @ wa.T) * (f2 > 0.0)
            g[P_W2:P_B2] = (f1.T @ dz2).reshape(-1)
            g[P_B2:P_WV] = dz2.sum(dim=0)
            dz1 = (dz2 @ params[P_W2:P_B2].view(H, H).T) * (f1 > 0.0)
            g[P_W1:P_B1] = (x.T @ dz1).reshape(-1)
            g[P_B1:P_W2] = dz1.sum(dim=0)

        # ---- flat Adam + target sync
        lo = FEATURES_END if heads_only else 0
        adam_(params[lo:], g[lo:], m[lo:], v[lo:], count0 + k + 1, lr)
        if tau > 0.0:
            target.copy_(target + tau * (params - target))
        elif (ts0 + k + 1) % interval == 0:
            target.copy_(params)

        # ---- priority write-back in sample order, touched chunks re-summed
        newp = own_p = torch.abs(td) + per_eps
        if given_newp is not None:
            newp = given_newp[k]
        newpa = torch.exp(alpha * torch.log(newp))
        slots, vals = last_writer_wins(idx, newpa)
        p_alpha[slots] = vals
        chunk_sums[c] = pa_rows[c].double().sum(dim=1).float()
        newp_all.append(own_p)
        idx_all.append(own.to(torch.int32))
    return torch.stack(newp_all), torch.stack(idx_all), torch.stack(losses)
