"""Fused DQN update block: PER sampling + K Double-DQN updates in one CUDA
launch.

Port of ``pingpong_tpu/ops/dqn_update.py::pallas_dqn_update_block``. The
K updates form a serial chain (each samples from the priorities the last
one wrote and steps from its parameters), so the whole block is one
kernel: one cluster of 8 thread blocks that split each update's samples
and its parameter step. Per update: inverse-CDF prioritized sample from
pre-drawn uniforms, importance weights ``(N P(i))^-beta`` max-normalized, the
Double-DQN TD error with this update's head noise on the online net and
mu weights on the target, IS-weighted MSE, a hand-written backward
(heads only by default), flat Adam (b1 0.9, b2 0.999, eps 1e-8), hard or
Polyak target sync, and the priority write-back in sample order (last
writer of a duplicated slot wins) with an exact refresh of the touched
chunk sums.

The port's own layout: parameters, target and both Adam moments are flat
vectors in the JAX ``ravel_pytree`` order (:data:`N_PARAMS` floats, the
layout the optimizer state of both packages already uses), and the
per-update noise is a ``(K, 260)`` matrix (v.eps_w, v.eps_b, a.eps_w,
a.eps_b). Replay is the chunk-block ring of ``replay/per.py``.

:func:`dqn_update_plain` is the step-by-step PyTorch version (the CPU
path, and the reference ``chip_smoke.py`` holds the kernel against);
``csrc/dqn_update.cu`` is the kernel. Both update ``p_alpha``,
``chunk_sums``, the parameters, the target and the moments IN PLACE.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pingpong_tpu_torch.models.qnet import QNetNoise
from pingpong_tpu_torch.replay.per import exact_cumsum, last_writer_wins
from pingpong_tpu_torch.train.optim import ADAM_EPS, B1, B2, adam_
from pingpong_tpu_torch.ops.build import (
    CudaKernel,
    check_cuda,
    ptr,
    stream_ptr,
)

D, H, CH, R = 7, 64, 128, 16
P_W1 = 0
P_B1 = P_W1 + D * H
P_W2 = P_B1 + H
P_B2 = P_W2 + H * H
P_WV = P_B2 + H          # fc_v: w_mu, w_sigma (64, 1), b_mu, b_sigma (1)
P_WA = P_WV + 2 * H + 2  # fc_a: w_mu, w_sigma (64, 3), b_mu, b_sigma (3)
N_PARAMS = P_WA + 6 * H + 6           # 5192
FEATURES_END = P_WV                   # frozen when train_heads_only
N_NOISE = 4 * H + 4                   # 260
MAX_BATCH = 512                       # the JAX kernel's limit too
MAX_CHUNKS = 8192                     # replay <= 2^20: the CDF in shared memory
CLUSTER = 8                           # thread blocks of the kernel's cluster


def pack_dqn_noise(noise: QNetNoise) -> torch.Tensor:
    """``(K,)``-batched QNetNoise -> ``(K, 260)`` kernel noise rows."""
    k = noise.v.eps_w.shape[0]
    return torch.cat([noise.v.eps_w.reshape(k, -1), noise.v.eps_b,
                      noise.a.eps_w.reshape(k, -1), noise.a.eps_b],
                     dim=1).contiguous()


def supports_fused_update(cfg) -> bool:
    """Shapes the update kernel handles: the JAX package's
    ``supports_pallas_dqn_update``: lane-aligned batch of at most
    :data:`MAX_BATCH`, capacity a multiple of 128^2 and at most 2^20,
    aligned block pushes."""
    m = cfg.num_envs * cfg.rollout_length
    return (cfg.batch_size % CH == 0
            and cfg.batch_size <= MAX_BATCH
            and cfg.memory_size % (CH * CH) == 0
            and cfg.memory_size <= 1 << 20
            and m % CH == 0
            and cfg.memory_size % m == 0)


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
                     beta_frames, heads_only):
    """Step-by-step version of the kernel (in place on ``p_alpha,
    chunk_sums, params, target, m, v``). Returns ``(newp (K, bs),
    idx (K, bs) i32, losses (K,))``."""
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
        newp = torch.abs(td) + per_eps
        newpa = torch.exp(alpha * torch.log(newp))
        slots, vals = last_writer_wins(idx, newpa)
        p_alpha[slots] = vals
        chunk_sums[c] = pa_rows[c].double().sum(dim=1).float()
        newp_all.append(newp)
        idx_all.append(idx.to(torch.int32))
    return torch.stack(newp_all), torch.stack(idx_all), torch.stack(losses)


class Hyper(ctypes.Structure):
    """The kernel's ``Hyper`` struct (float32 each, rounded once)."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "lr", "gamma", "tau", "alpha", "per_eps", "beta_start", "beta_slope",
        "b1", "b2", "one_m_b1", "one_m_b2", "eps", "log_b1", "log_b2",
        "inv_bs", "two_bs")] + [("interval", ctypes.c_int),
                                ("heads_only", ctypes.c_int)]


_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "dqn_update", "dqn_update_launch",
    [_i, _i, _i, _i, _i, _i, _i, ctypes.POINTER(Hyper)] + [_vp] * 14,
)


def dqn_update_cuda(*, ts0, count0, frame0, size, u01, noise, p_alpha,
                    chunk_sums, params, target, m, v, data, K, bs, lr, gamma,
                    interval, tau, alpha, per_eps, beta_start, beta_frames,
                    heads_only):
    """Launch the CUDA kernel; same contract as :func:`dqn_update_plain`.
    Raises if the cluster launch is refused. (The C interface's ``grad``
    scratch is unused: the gradient lives in shared memory.)"""
    nc = chunk_sums.shape[0]
    dev = params.device
    if bs > MAX_BATCH or bs % (4 * CLUSTER) or nc > MAX_CHUNKS or nc % CH:
        raise ValueError(f"update kernel takes a batch <= {MAX_BATCH} and a "
                         f"multiple of {4 * CLUSTER}, and a multiple of "
                         f"{CH} chunks <= {MAX_CHUNKS}, got batch {bs}, "
                         f"{nc} chunks")
    check_cuda("u01", u01, torch.float32, (K, bs))
    check_cuda("noise", noise, torch.float32, (K, N_NOISE))
    check_cuda("p_alpha", p_alpha, torch.float32, (nc * CH,))
    check_cuda("chunk_sums", chunk_sums, torch.float32, (nc,))
    for name, t in (("params", params), ("target", target), ("m", m),
                    ("v", v)):
        check_cuda(name, t, torch.float32, (N_PARAMS,))
    check_cuda("data", data, torch.float32, (nc, 2 * D + 2, CH))
    newp = torch.empty((K, bs), dtype=torch.float32, device=dev)
    idx = torch.empty((K, bs), dtype=torch.int32, device=dev)
    losses = torch.empty((K,), dtype=torch.float32, device=dev)
    hp = Hyper(lr=lr, gamma=gamma, tau=tau, alpha=alpha, per_eps=per_eps,
               beta_start=beta_start,
               beta_slope=(1.0 - beta_start) / beta_frames,
               b1=B1, b2=B2, one_m_b1=1.0 - B1, one_m_b2=1.0 - B2,
               eps=ADAM_EPS, log_b1=math.log(B1), log_b2=math.log(B2),
               inv_bs=1.0 / bs, two_bs=2.0 / bs, interval=interval,
               heads_only=int(heads_only))
    KERNEL.launch(ts0, count0, frame0, size, K, bs, nc, ctypes.byref(hp),
                  ptr(u01), ptr(noise), ptr(p_alpha), ptr(chunk_sums),
                  ptr(params), ptr(target), ptr(m), ptr(v), ptr(data),
                  ptr(newp), ptr(idx), ptr(losses), None,
                  stream_ptr(dev))
    return newp, idx, losses


def dqn_update_block(*, train_steps: int, adam_count: int, frame_idx: int,
                     size: int, u01, noise, p_alpha, chunk_sums, params,
                     target, m, v, data, K: int, bs: int, lr: float,
                     gamma: float, interval: int, tau: float, alpha: float,
                     per_eps: float, beta_start: float, beta_frames: int,
                     heads_only: bool):
    """Run K fused PER + SGD updates, in place on ``p_alpha``,
    ``chunk_sums``, ``params``, ``target``, ``m`` and ``v``. Requires
    ``size >= bs`` (the caller skips the block otherwise). Runs the CUDA
    kernel for CUDA tensors and the plain version for CPU tensors.
    Returns ``(newp (K, bs), idx (K, bs) i32, losses (K,))``: the raw
    priority stream for the caller's last-writer-wins replay into
    ``prios``, and each update's loss."""
    kw = dict(ts0=int(train_steps), count0=int(adam_count),
              frame0=int(frame_idx), size=int(size), u01=u01, noise=noise,
              p_alpha=p_alpha, chunk_sums=chunk_sums, params=params,
              target=target, m=m, v=v, data=data, K=K, bs=bs, lr=lr,
              gamma=gamma, interval=interval, tau=tau, alpha=alpha,
              per_eps=per_eps, beta_start=beta_start,
              beta_frames=beta_frames, heads_only=heads_only)
    if params.is_cuda:
        return dqn_update_cuda(**kw)
    return dqn_update_plain(**kw)
