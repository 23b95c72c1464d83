"""Chip smoke test of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py

1. builds every CUDA kernel from ``pingpong_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together), prints ptxas' register/smem/spill
   lines and fails if a rollout kernel spills or kernel 5's rollout
   function has a stack frame;
2. holds each kernel against its plain PyTorch version on the card, at its
   paths' shapes (the training configs' and the bench's, and the update
   kernel at batch 512 too, update by update), with the stated
   tolerances (kernel 5 also bit for bit), checks kernel 5's division and
   sine and cosine against the card's own on every float they take, and
   checks that every kernel gives bit-identical results run to run;
3. drives the port's paths, each with the kernels' launch counters set
   to 0 just before it and read just after: ``cli train`` at
   ``configs/qnet.yaml``'s widths and batch, and ``cli train-rnn`` at
   ``configs/rnn.yaml``'s, each twice in one workdir at the shipped
   autosave interval (the second run restores the first run's full-state
   autosave, loads its promotion into the pool and promotes generation
   2), then ``cli bench`` at the headline bench's shapes with fewer timing
   windows; then, at the shipped configs' full width, a straight run
   against a kill-and-resume run of each trainer, held bit for bit
   (``[resume:*]``), the autosave stall bench at the bench's QNet shape and
   at ``configs/rnn.yaml`` (``[autosave:*]``), ``cli train`` with the
   match-runner gates, single-seat and side-balanced, timed beside the
   fused gate (``[gates:match]``), and ``cli round-robin`` over the QNet
   checkpoints and ``cli arena`` twice over the DRQN ones, the second
   planning 0 pairings (``[tournament]``); then the viewer's path, which
   runs no kernel: the port's env on the card against the C++ engine
   built with ``g++`` (``[view:engine]``), ``record_episode`` on the card
   against the CPU for bot vs bot, ``model5-1`` vs bot and
   ``rnn_pong_soul_1`` vs ``model5-1`` (``[view:record]``), ``cli view``
   to GIFs and a headless live episode on the host (``[view:cli]``, or
   a line saying PIL is missing), and ``model5-1`` through ``cli
   import-torch`` as a reference ``.pth`` (``[import]``);
4. times each kernel (CUDA events, warm) beside its plain version and its
   bound, and a train iteration of each path end to end, and profiles
   where an iteration's and the bench's device time goes
   (``torch.profiler``); for kernel 3 it prints, at each timed binding,
   the L2 weight bytes of a chunk under the parent design's and the
   one-member design's stream counts, the launch plan (envs a block,
   blocks, rounds, residency) and checks that the card's block
   table equals ``block_table``'s and holds one member a block;
5. prints the ``kernels`` JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA card
it exits 1 and prints no result.

    python3 chip_smoke.py --rollout-times DIR

times only the three rollout kernels (kernels 1, 3 and 5) of the checkout
at DIR, at every shape their paths launch them at, with this script's
inputs and yardstick (``time_rollouts``), and prints one JSON line. Run it
on a parent commit unpacked under ``build/`` and on this checkout, in one
call, to compare the two on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12        # H100 SXM float32 (non-tensor-core) FLOP/s
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
# set by setup() from the card, configs/qnet.yaml and configs/rnn.yaml
CARD = DEV = ENV_PARAMS = TILE = MAX_EP_STEPS = MAX_ROLLOUT = QNET_B = None
RNN_ENV = RNN_CFG = None


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# kernel 1: actor rollout
# ---------------------------------------------------------------------------

def actor_inputs(seed, n_slots, shared, eval_mode, B, dev):
    from pingpong_tpu_torch.env.pong import reset
    from pingpong_tpu_torch.evaluation.fast_eval import _zero_sigma
    from pingpong_tpu_torch.models.qnet import qnet_init
    from pingpong_tpu_torch.ops.actor_rollout import pack_qnet
    from pingpong_tpu_torch.train.dqn import bucket_opp_idx

    gen = torch.Generator().manual_seed(seed)
    learner = qnet_init(gen)
    if eval_mode:
        learner = _zero_sigma(learner)
    members = [qnet_init(gen) for _ in range(n_slots)]
    if shared:
        for p in members[1:]:
            for layer in ("feat1", "feat2"):
                for f in ("w", "b"):
                    getattr(p, layer).get_parameter(f).data.copy_(
                        getattr(members[0], layer).get_parameter(f))
    opp_idx = bucket_opp_idx(B, 0.33, n_slots - 1, device=dev)
    return dict(
        state0=reset(ENV_PARAMS, B, gen, dev), opp_idx=opp_idx,
        ep_return=torch.zeros(B, device=dev),
        learner=pack_qnet(learner.to(dev)),
        opponents=pack_qnet([m.to(dev) for m in members], mirror=True),
        shared=shared, eval_mode=eval_mode)


def run_actor(fn, inp, steps, seed=11):
    return fn(ENV_PARAMS, inp["state0"], inp["opp_idx"], inp["ep_return"],
              inp["learner"], inp["opponents"], seed=seed,
              eps_i=0 if inp["eval_mode"] else 300000, steps=steps,
              max_episode_steps=0 if inp["eval_mode"] else MAX_EP_STEPS,
              tile_rows=TILE, emit_transitions=not inp["eval_mode"],
              shared_trunk=inp["shared"])


def compare_actor(name, inp):
    """16-step chunk: discrete streams equal on >= 99.9 % of (env, step),
    f32 within 1e-5 on matching envs; 64-step games and wins within 1 %."""
    from pingpong_tpu_torch.ops.actor_rollout import (
        actor_rollout_cuda,
        actor_rollout_plain,
    )

    sk, rk, tk, stk = run_actor(actor_rollout_cuda, inp, 16)
    sp, rp, tp, stp = run_actor(actor_rollout_plain, inp, 16)
    torch.cuda.synchronize()
    if tk is not None:
        eq = ((tk["action"] == tp["action"]) & (tk["reward"] == tp["reward"])
              & (tk["done"] == tp["done"]))
        frac = float(eq.float().mean())
        ok_env = eq.all(dim=0)
        f32_err = max(
            float((tk[k] - tp[k]).abs()[:, ok_env].max())
            for k in ("obs", "next_obs"))
    else:
        eq = torch.stack([sk.score_a == sp.score_a, sk.score_b == sp.score_b,
                          sk.t == sp.t, sk.bounce_count == sp.bounce_count,
                          stk[5] == stp[5]]).all(dim=0)
        frac = float(eq.float().mean())
        ok_env = eq
        f32_err = 0.0
    for f in ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin",
              "top_paddle_x", "bottom_paddle_x"):
        f32_err = max(f32_err, float(
            (getattr(sk, f) - getattr(sp, f)).abs()[ok_env].max()))
    f32_err = max(f32_err, float((rk - rp).abs()[ok_env].max()))
    _, _, _, stk64 = run_actor(actor_rollout_cuda, inp, 64)
    _, _, _, stp64 = run_actor(actor_rollout_plain, inp, 64)
    gk, gp = float(stk64[0].sum() + stk64[2].sum()), float(
        stp64[0].sum() + stp64[2].sum())
    wk, wp = float(stk64[1].sum() + stk64[3].sum()), float(
        stp64[1].sum() + stp64[3].sum())
    print(f"[actor:{name}] discrete match {frac:.6f} f32 max err "
          f"{f32_err:.3g} | 64 steps games {gk:.0f}/{gp:.0f} wins "
          f"{wk:.0f}/{wp:.0f} | {CARD}", flush=True)
    check(frac >= 0.999, f"actor {name}: discrete match {frac} < 0.999")
    check(f32_err <= 1e-5, f"actor {name}: f32 error {f32_err} > 1e-5")
    check(abs(gk - gp) <= 0.01 * max(gp, 1.0), f"actor {name}: games")
    check(abs(wk - wp) <= 0.01 * max(wp, 1.0), f"actor {name}: wins")
    return f32_err


def actor_bound_ms(B, T, n_slots, emit=True):
    flops = 2 * 2 * (7 * 64 + 64 * 64 + 3 * 64) * B * T
    nbytes = (2 * 13 * 4 * B + 8 * 4 * B + 5776 * 4 * (1 + n_slots)
              + (68 * B * T if emit else 0))
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# ---------------------------------------------------------------------------
# kernel 2: update block
# ---------------------------------------------------------------------------

def update_inputs(seed, dev, cap=1 << 20, bs=256, K=64):
    from pingpong_tpu_torch.models.qnet import qnet_init, qnet_sample_noise
    from pingpong_tpu_torch.ops.dqn_update import pack_dqn_noise
    from pingpong_tpu_torch.models.qnet import qnet_to_flat
    from pingpong_tpu_torch.replay.per import Transition, per_init, per_push

    g = torch.Generator(device=dev).manual_seed(seed)
    buf = per_init(cap, device=dev)
    m = min(262144, cap)
    for _ in range(cap // m):
        per_push(buf, Transition(
            obs=torch.rand((m, 7), generator=g, device=dev) * 2 - 1,
            action=torch.randint(0, 3, (m,), generator=g, device=dev,
                                 dtype=torch.int32),
            reward=torch.randn((m,), generator=g, device=dev),
            next_obs=torch.rand((m, 7), generator=g, device=dev) * 2 - 1,
            done=torch.rand((m,), generator=g, device=dev) < 0.2), 0.6)
    buf.prios.copy_(0.1 + 1.9 * torch.rand(cap, generator=g, device=dev))
    buf.p_alpha.copy_(buf.prios ** 0.6)
    buf.chunk_sums.copy_(buf.p_alpha.view(-1, 128).sum(dim=1))
    hg = torch.Generator().manual_seed(seed)
    params = qnet_to_flat(qnet_init(hg)).to(dev)
    target = qnet_to_flat(qnet_init(hg)).to(dev)
    noise = pack_dqn_noise(qnet_sample_noise(hg, qnet_init(hg),
                                             batch=(K,))).to(dev)
    return dict(buf=buf, params=params, target=target, K=K, bs=bs,
                u01=torch.rand((K, bs), generator=g, device=dev),
                noise=noise)


def update_kwargs(inp, heads_only, tau, interval):
    buf = inp["buf"]
    return dict(ts0=0, count0=0, frame0=0, size=buf.size, u01=inp["u01"],
                noise=inp["noise"], p_alpha=buf.p_alpha.clone(),
                chunk_sums=buf.chunk_sums.clone(),
                params=inp["params"].clone(), target=inp["target"].clone(),
                m=torch.zeros_like(inp["params"]),
                v=torch.zeros_like(inp["params"]), data=buf.data,
                K=inp["K"], bs=inp["bs"], lr=2.5e-4, gamma=0.99,
                interval=interval, tau=tau, alpha=0.6, per_eps=1e-6,
                beta_start=0.4, beta_frames=100_000, heads_only=heads_only)


def compare_update(name, inp, heads_only, tau, interval):
    """idx identical for the first update and >= 99 % over the block;
    params, target, moments and losses within rtol 1e-4."""
    from pingpong_tpu_torch.ops.dqn_update import (
        dqn_update_cuda,
        dqn_update_plain,
    )

    kk = update_kwargs(inp, heads_only, tau, interval)
    kp = update_kwargs(inp, heads_only, tau, interval)
    nk, ik, lk = dqn_update_cuda(**kk)
    np_, ip, lp = dqn_update_plain(**kp)
    torch.cuda.synchronize()
    first = bool((ik[0] == ip[0]).all())
    frac = float((ik == ip).float().mean())
    err = 0.0
    for key, atol in (("params", 1e-6), ("target", 1e-6), ("m", 1e-7),
                      ("v", 1e-9), ("chunk_sums", 1e-6)):
        a, b = kk[key], kp[key]
        err = max(err, float((a - b).abs().max()))
        check(torch.allclose(a, b, rtol=1e-4, atol=atol),
              f"update {name}: {key} differs beyond rtol 1e-4")
    check(torch.allclose(lk, lp, rtol=1e-4, atol=1e-6),
          f"update {name}: losses differ beyond rtol 1e-4")
    err = max(err, float((lk - lp).abs().max()))
    print(f"[update:{name}] idx first-update equal {first}, block match "
          f"{frac:.5f}, max abs err {err:.3g}, loss[0] {float(lk[0]):.5g}"
          f"/{float(lp[0]):.5g} | {CARD}", flush=True)
    check(first, f"update {name}: first update's idx differ")
    check(frac >= 0.99, f"update {name}: idx match {frac} < 0.99")
    check(bool(torch.isfinite(lk).all()), f"update {name}: losses finite")
    return err, ik


def compare_update_stepwise(name, inp, heads_only, tau, interval):
    """The block's K updates one launch each (K = 1), the kernel and the
    plain version from the same state, the plain version's state carried
    to the next update: idx identical on every update; params, target,
    moments, chunk sums and the loss within rtol 1e-4 after every update.
    At batch 512 and 2^20 slots the f32 CDF (spacing 0.0625 near its total
    of about 8e5) turns a rounding difference of the two versions' TD
    errors into a neighbouring slot now and then, and one such sample
    moves every later sample of a block run; so the block run's match is
    printed and its first update checked, and every update is held here."""
    from pingpong_tpu_torch.ops.dqn_update import (
        dqn_update_cuda,
        dqn_update_plain,
    )

    kb, kp = (update_kwargs(inp, heads_only, tau, interval) for _ in range(2))
    _, ib, _ = dqn_update_cuda(**kb)
    _, ipb, _ = dqn_update_plain(**kp)
    torch.cuda.synchronize()
    same = (ib == ipb).all(dim=1)
    first_diff = int((~same).nonzero()[0]) if not bool(same.all()) else None
    check(bool(same[0]), f"update {name}: first update's idx differ")
    state = update_kwargs(inp, heads_only, tau, interval)
    inplace = ("p_alpha", "chunk_sums", "params", "target", "m", "v")
    err = 0.0
    for k in range(inp["K"]):
        step = dict(state, ts0=k, count0=k, frame0=k, K=1,
                    u01=inp["u01"][k:k + 1], noise=inp["noise"][k:k + 1])
        kk = dict(step, **{key: step[key].clone() for key in inplace})
        kp = dict(step, **{key: step[key].clone() for key in inplace})
        nk, ik, lk = dqn_update_cuda(**kk)
        np_, ip, lp = dqn_update_plain(**kp)
        torch.cuda.synchronize()
        check(bool((ik == ip).all()), f"update {name}: idx differ at {k}")
        for key, atol in (("params", 1e-6), ("target", 1e-6), ("m", 1e-7),
                          ("v", 1e-9), ("chunk_sums", 1e-6)):
            err = max(err, float((kk[key] - kp[key]).abs().max()))
            check(torch.allclose(kk[key], kp[key], rtol=1e-4, atol=atol),
                  f"update {name}: {key} differs beyond rtol 1e-4 at {k}")
        check(torch.allclose(lk, lp, rtol=1e-4, atol=1e-6)
              and bool(torch.isfinite(lk).all()),
              f"update {name}: loss differs beyond rtol 1e-4 at {k}")
        err = max(err, float((lk - lp).abs().max()))
        state.update({key: kp[key] for key in inplace})
    print(f"[update:{name}] block run: idx first-update equal True, block "
          f"match {float((ib == ipb).float().mean()):.5f}, first update "
          f"with a differing idx {first_diff}; every update on its own: idx "
          f"equal, max abs err {err:.3g} | {CARD}", flush=True)
    return err


def check_bit_reproducible(upd_inp, drqn_kw):
    """Kernels 2 and 4 twice each on the same inputs: every output and
    in-place tensor bit-identical (their cross-block reductions run in a
    fixed order)."""
    from pingpong_tpu_torch.ops.dqn_update import dqn_update_cuda
    from pingpong_tpu_torch.ops.drqn_update import drqn_update_cuda

    for name, fn, kw, keys in (
            ("dqn_update", dqn_update_cuda,
             update_kwargs(upd_inp, False, 0.0, 16),
             ("params", "target", "m", "v", "chunk_sums", "p_alpha")),
            ("drqn_update", drqn_update_cuda, drqn_kw,
             ("params", "target", "m", "v"))):
        runs = []
        for _ in range(2):
            k = fresh(kw)
            out = fn(**k)
            torch.cuda.synchronize()
            runs.append((out if isinstance(out, tuple) else (out,), k))
        (o1, k1), (o2, k2) = runs
        same = all(torch.equal(a, b) for a, b in zip(o1, o2)) and all(
            torch.equal(k1[key], k2[key]) for key in keys)
        print(f"[repro:{name}] two runs on the same inputs bit-identical "
              f"({', '.join(('newp', 'idx', 'losses') if len(o1) == 3 else ('losses',))}, "
              f"{', '.join(keys)}): {same} | {CARD}", flush=True)
        check(same, f"{name}: two runs on the same inputs differ")


def check_rollouts_reproducible(actor_inp, rnn_inp):
    """Kernels 1 and 3 twice each on the same inputs (blocks of several
    opponent members included): every output bit-identical (their sums run
    in fixed loop and shuffle orders)."""
    from pingpong_tpu_torch.ops.actor_rollout import actor_rollout_cuda
    from pingpong_tpu_torch.ops.recurrent_rollout import recurrent_rollout_cuda

    def tensors(out):
        for x in out:
            if isinstance(x, dict):
                yield from x.values()
            elif isinstance(x, tuple):
                yield from x
            elif x is not None:
                yield x

    for name, run, fn, inp in (
            ("actor_rollout", run_actor, actor_rollout_cuda, actor_inp),
            ("recurrent_rollout", run_rnn, recurrent_rollout_cuda, rnn_inp)):
        one, two = run(fn, inp, 64), run(fn, inp, 64)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b)
                   for a, b in zip(tensors(one), tensors(two)))
        print(f"[repro:{name}] two 64-step runs on the same inputs "
              f"bit-identical (state, return, transitions, hidden, stats): "
              f"{same} | {CARD}", flush=True)
        check(same, f"{name}: two runs on the same inputs differ")


def check_pong_reproducible(params, state):
    """Kernel 5 twice on the same inputs: final state and reward sums
    bit-identical (each env is one thread's chain; nothing is summed
    across threads)."""
    from pingpong_tpu_torch.ops.pong_kernel import pong_rollout_cuda

    runs = [pong_rollout_cuda(params, state, PONG_STEPS, 9,
                              tile_rows=PONG_TILE) for _ in range(2)]
    torch.cuda.synchronize()
    (s1, r1), (s2, r2) = runs
    same = torch.equal(r1, r2) and all(
        torch.equal(a, b) for a, b in zip(s1, s2))
    print(f"[repro:pong_kernel] two {PONG_STEPS}-step runs on the same "
          f"inputs bit-identical (state, reward sums): {same} | {CARD}",
          flush=True)
    check(same, "pong_kernel: two runs on the same inputs differ")


def check_no_stack_frame(log, function):
    """ptxas reports 0 bytes of stack frame for the named function."""
    m = re.search(rf"Function properties for \S*{function}\S*\s*\n\s*"
                  r"(\d+) bytes stack frame", log)
    print(f"[build:stack] {function}: "
          f"{m.group(1) if m else '?'} bytes stack frame", flush=True)
    check(m is not None and m.group(1) == "0",
          f"{function} has a stack frame (or ptxas printed none)")


def check_no_spills(logs, names):
    """ptxas' line of every function of these kernels reports 0 bytes of
    spill stores."""
    for name in names:
        lines = [ln for ln in logs[name].splitlines() if "spill stores" in ln]
        stores = [int(m) for ln in lines
                  for m in re.findall(r"(\d+) bytes spill stores", ln)]
        print(f"[build:spill] {name}: {len(stores)} function(s), spill "
              f"stores {stores}", flush=True)
        check(stores and not any(stores), f"{name} spills registers")


def update_bound_ms(bs, K, nc, heads_only, idx):
    fwd = 2 * (7 * 64 + 64 * 64) + 2 * 4 * 64
    flops = 3 * bs * fwd + 2 * bs * 4 * 64 + nc + bs * 128
    if not heads_only:
        flops += bs * 2 * (4 * 64 + 2 * 64 * 64 + 7 * 64)
    flops = (flops + 12 * 5192) * K
    chunks = int(torch.unique(idx.long() // 128).numel())
    slots = int(torch.unique(idx.long()).numel())
    nbytes = (4 * K * bs + 4 * K * 260 + 8 * 4 * 5192 + 4 * nc
              + 512 * chunks + 64 * slots + 4 * slots + 4 * chunks
              + 8 * K * bs + 4 * K)
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# kernel 3: recurrent rollout
# ---------------------------------------------------------------------------

def rnn_nets(gen, n, dev):
    from pingpong_tpu_torch.models.qnet_rnn import qnet_rnn_init

    c = RNN_CFG
    return [qnet_rnn_init(gen, feature_dim=c.feature_dim,
                          lstm_hidden_dim=c.lstm_hidden_dim,
                          head_hidden_dim=c.head_hidden_dim).to(dev)
            for _ in range(n)]


def rebind_opp_idx(B, ratio, pool_size, seed, dev):
    """The binding ``train/drqn.py`` leaves after the pool grew from
    ``pool_size - 1`` to ``pool_size`` members: a seeded random half of the
    envs (those that ended) on the new buckets, the rest on the old."""
    from pingpong_tpu_torch.train.dqn import bucket_opp_idx

    g = torch.Generator().manual_seed(seed)
    moved = (torch.randperm(B, generator=g) < B // 2).to(dev)
    return torch.where(moved, bucket_opp_idx(B, ratio, pool_size, device=dev),
                       bucket_opp_idx(B, ratio, pool_size - 1, device=dev))


def rnn_inputs(seed, n_slots, eval_mode, dev, B=None, rebind=False):
    """Kernel 3's inputs at ``configs/rnn.yaml``'s widths: random nets from
    ``seed``, ``n_slots`` opponents bound in the learner's contiguous
    buckets, or (``rebind``) half on the buckets of one member fewer."""
    from pingpong_tpu_torch.env.pong import reset
    from pingpong_tpu_torch.evaluation.fast_eval import _zero_rnn_sigma
    from pingpong_tpu_torch.ops import recurrent_rollout as rr
    from pingpong_tpu_torch.train.dqn import bucket_opp_idx

    B, H = B or RNN_CFG.num_envs, RNN_CFG.lstm_hidden_dim
    ratio = RNN_CFG.selfplay.opponent_pool_ratio
    gen = torch.Generator().manual_seed(seed)
    learner, *members = rnn_nets(gen, 1 + n_slots, dev)
    if eval_mode:
        learner = _zero_rnn_sigma(learner)
    hid = torch.zeros((4 * H, B), device=dev)
    if not eval_mode:
        hid.uniform_(-0.5, 0.5, generator=torch.Generator(dev).manual_seed(seed))
    return dict(
        state0=reset(RNN_ENV, B, gen, dev),
        opp_idx=(rebind_opp_idx(B, ratio, n_slots - 1, seed, dev) if rebind
                 else bucket_opp_idx(B, ratio, n_slots - 1, device=dev)),
        ep_return=torch.zeros(B, device=dev), hid=hid,
        learner=rr.pack_qnet_rnn(learner), sigma=rr.pack_rnn_sigma(learner),
        opponents=rr.pack_qnet_rnn(members, mirror=True), eval_mode=eval_mode)


def run_rnn(fn, inp, steps, seed=11):
    return fn(RNN_ENV, inp["state0"], inp["opp_idx"], inp["ep_return"],
              inp["hid"], inp["learner"], inp["sigma"], inp["opponents"],
              seed=seed, eps_i=0 if inp["eval_mode"] else 300000,
              steps=steps, max_episode_steps=RNN_CFG.max_episode_steps,
              tile_rows=min(RNN_CFG.pallas_tile_rows, RNN_CFG.num_envs),
              emit_transitions=not inp["eval_mode"])


def compare_rnn(name, inp):
    """16-step chunk: discrete streams equal on >= 99.9 % of (env, step);
    on matching envs, env floats within 1e-5 and the LSTM streams within
    1e-4 (the gate sums of 256 products run in another order, with FMAs,
    and 16 recurrent steps carry the difference); 128-step games and wins
    within 1 %."""
    from pingpong_tpu_torch.ops.recurrent_rollout import (
        recurrent_rollout_cuda,
        recurrent_rollout_plain,
    )

    sk, rk, hk, tk, stk = run_rnn(recurrent_rollout_cuda, inp, 16)
    sp, rp, hp, tp, stp = run_rnn(recurrent_rollout_plain, inp, 16)
    torch.cuda.synchronize()
    if tk is not None:
        eq = ((tk["action"] == tp["action"]) & (tk["reward"] == tp["reward"])
              & (tk["done"] == tp["done"]))
        frac = float(eq.float().mean())
        ok_env = eq.all(dim=0)
        f32_err = float((tk["obs"] - tp["obs"]).abs()[:, ok_env].max())
    else:
        ok_env = torch.stack([sk.score_a == sp.score_a,
                              sk.score_b == sp.score_b, sk.t == sp.t,
                              sk.bounce_count == sp.bounce_count,
                              stk[5] == stp[5]]).all(dim=0)
        frac = float(ok_env.float().mean())
        f32_err = 0.0
    for f in ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin",
              "top_paddle_x", "bottom_paddle_x"):
        f32_err = max(f32_err, float(
            (getattr(sk, f) - getattr(sp, f)).abs()[ok_env].max()))
    f32_err = max(f32_err, float((rk - rp).abs()[ok_env].max()))
    hid_err = float((hk - hp).abs()[:, ok_env].max())
    _, _, _, _, stk128 = run_rnn(recurrent_rollout_cuda, inp, 128)
    _, _, _, _, stp128 = run_rnn(recurrent_rollout_plain, inp, 128)
    gk, gp = float(stk128[0].sum() + stk128[2].sum()), float(
        stp128[0].sum() + stp128[2].sum())
    wk, wp = float(stk128[1].sum() + stk128[3].sum()), float(
        stp128[1].sum() + stp128[3].sum())
    print(f"[rnn:{name}] discrete match {frac:.6f} env f32 max err "
          f"{f32_err:.3g} hidden max err {hid_err:.3g} | 128 steps games "
          f"{gk:.0f}/{gp:.0f} wins {wk:.0f}/{wp:.0f} | {CARD}", flush=True)
    check(frac >= 0.999, f"rnn {name}: discrete match {frac} < 0.999")
    check(f32_err <= 1e-5, f"rnn {name}: env f32 error {f32_err} > 1e-5")
    check(hid_err <= 1e-4, f"rnn {name}: hidden error {hid_err} > 1e-4")
    check(abs(gk - gp) <= 0.01 * max(gp, 1.0), f"rnn {name}: games")
    check(abs(wk - wp) <= 0.01 * max(wp, 1.0), f"rnn {name}: wins")
    return max(f32_err, hid_err)


def rnn_weight_bytes(opp_idx, T):
    """L2 weight bytes of one kernel-3 chunk at ``configs/rnn.yaml``'s
    widths under two stream counts. Parent: 8 contiguous envs a block,
    each block-step reading the whole flat net of every member present
    (157,379 floats), the learner's and its sigmas (16,899 floats). Blocks
    of one member: each block-step reads the streamed matrices (w2, wg, ws
    of both nets and the learner's ws sigmas), and each block reads the
    resident parts once. Returns ``(parent bytes,
    parent's most members in a block, None)``, or for a checkout whose
    kernel has block tables ``(..., dict(bytes, plan, n_blocks,
    rounds))`` after checking the card's table against ``block_table``."""
    from pingpong_tpu_torch.ops import recurrent_rollout as rr

    F1, F, H, HH = (RNN_CFG.feature_dim // 2, RNN_CFG.feature_dim,
                    RNN_CFG.lstm_hidden_dim, RNN_CFG.head_hidden_dim)
    net = F1 * 9 + F1 * F + F + (F + H) * 4 * H + 4 * H + H * HH + HH \
        + 3 * HH + 3
    sig = H * HH + HH + 3 * HH + 3
    members = [int(torch.unique(b).numel()) for b in opp_idx.view(-1, 8)]
    parent = 4 * T * sum(m * net + net + sig for m in members)
    if not hasattr(rr, "launch_plan"):
        return parent, max(members), None
    tile = min(RNN_CFG.pallas_tile_rows, opp_idx.numel())
    n_slots = int(opp_idx.max()) + 1
    plan = rr.launch_plan(opp_idx, tile, n_slots, (F1, F, H, HH))
    counts = rr.segment_counts(opp_idx, tile, n_slots)
    plain = rr.block_table(opp_idx, tile, plan.envs, counts,
                           plan.table.shape[0])
    _, _, n_blocks, rounds = rr.plan_counts(plan)
    check(torch.equal(plain, plan.table) and n_blocks == int(
        rr.member_blocks(counts, plan.envs).sum()),
          "the card's block table differs from block_table")
    lay, _ = rr.net_layout((F1, F, H, HH))
    slay, _ = rr.sigma_layout((F1, F, H, HH))
    streamed = 2 * (F1 * F + (F + H) * 4 * H + H * HH) + H * HH
    resident = 2 * lay["w2"][0] + slay["ws"][0]
    change = 4 * (T * streamed + resident) * n_blocks
    return parent, max(members), dict(bytes=change, plan=plan,
                                      n_blocks=n_blocks, rounds=rounds)


def check_one_member_blocks(opp_idx, table, n_blocks):
    """Every block of the table (built on the card, and equal to
    ``block_table``'s) holds envs of its own member only: at most one
    opponent pass a block-step. Returns the idle lanes."""
    envs = table[:n_blocks, 1:]
    valid = envs >= 0
    member = table[:n_blocks, :1].expand_as(envs)
    ok = bool((opp_idx[envs[valid].long()] == member[valid]).all())
    check(ok, "a block holds envs of two opponents")
    return int((~valid).sum())


def rnn_bound_ms(B, T, n_slots, tiles, emit=True):
    """Kernel 3's least time: two recurrent forwards per env-step (the
    learner's and the bound opponent's), each the feature MLP, the packed
    gates product, the cell and the shared and A heads, plus the tile's
    noisy head weights once per step; bytes: state and both LSTM streams
    in and out, every net once, the transitions."""
    F1, F, H, HH = (RNN_CFG.feature_dim // 2, RNN_CFG.feature_dim,
                    RNN_CFG.lstm_hidden_dim, RNN_CFG.head_hidden_dim)
    per_net = (2 * (7 * F1 + F1 * F + (F + H) * 4 * H + H * HH + HH * 3)
               + 10 * H)
    flops = 2 * per_net * B * T + 3 * (H * HH + 3 * HH) * tiles * T
    net = F1 * 9 + F1 * F + F + (F + H) * 4 * H + 4 * H + H * HH + HH \
        + 3 * HH + 3
    nbytes = (2 * (13 + 4 * H) * 4 * B + 8 * 4 * B
              + 4 * (net * (1 + n_slots) + H * HH + 4 * HH + 3)
              + (40 * B * T if emit else 0))
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# ---------------------------------------------------------------------------
# kernel 4: DRQN update block
# ---------------------------------------------------------------------------

def drqn_update_inputs(seed, dev, ts0=0, interval=2000, tau=0.0):
    from pingpong_tpu_torch.models.qnet_rnn import (
        qnet_rnn_sample_noise,
        qnet_rnn_to_flat,
    )
    from pingpong_tpu_torch.ops.drqn_update import flat_noise, kernel_inputs

    c = RNN_CFG
    K, bs, T = c.updates_per_iteration, c.batch_size, c.trace_length
    gen = torch.Generator().manual_seed(seed)
    net, tgt = rnn_nets(gen, 2, dev)
    g = torch.Generator(dev).manual_seed(seed)
    lo = torch.tensor([0, 0, -0.06, -0.06, 0, 0, -5], device=dev)
    hi = torch.tensor([1, 1, 0.06, 0.06, 1, 1, 5], device=dev)
    obs = lo + (hi - lo) * torch.rand((K, bs, T + 1, 7), generator=g,
                                      device=dev)
    xt, nextt, meta = kernel_inputs(
        obs[:, :, :T].contiguous(), obs[:, :, 1:].contiguous(),
        torch.randint(0, 3, (K, bs), generator=g, device=dev),
        torch.randn((K, bs), generator=g, device=dev),
        torch.rand((K, bs), generator=g, device=dev) < 0.2,
        torch.rand((K, bs), generator=g, device=dev) < 0.9)
    params = qnet_rnn_to_flat(net)
    return dict(ts0=ts0, count0=ts0, xt=xt, nextt=nextt, meta=meta,
                noise=flat_noise(qnet_rnn_sample_noise(gen, net, batch=(K,)))
                .to(dev), params=params, target=qnet_rnn_to_flat(tgt),
                m=torch.zeros_like(params), v=torch.zeros_like(params),
                dims=(c.feature_dim // 2, c.feature_dim, c.lstm_hidden_dim,
                      c.head_hidden_dim), K=K, bs=bs, T=T, lr=c.lr,
                clip=c.grad_clip_norm, gamma=c.gamma, interval=interval,
                tau=tau)


def fresh(kw):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items()}


def compare_drqn_update(name, kw):
    """Losses within rtol 1e-4. Parameters and target: >= 99.9 % of
    entries within 1e-6 + 1e-4 |x|, and every entry within 2 lr K: Adam's
    first steps normalise each gradient entry to about +-1, so an entry
    whose gradient is near zero (its sign set by summation order) may move
    by up to lr a step the other way. Moments: >= 99.9 % within rtol 1e-3."""
    from pingpong_tpu_torch.ops.drqn_update import (
        drqn_update_cuda,
        drqn_update_plain,
    )

    kk, kp = fresh(kw), fresh(kw)
    lk = drqn_update_cuda(**kk)
    lp = drqn_update_plain(**kp)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lk).all()), f"update {name}: losses finite")
    check(torch.allclose(lk, lp, rtol=1e-4, atol=1e-6),
          f"update {name}: losses differ beyond rtol 1e-4")
    err = float((lk - lp).abs().max())
    fracs = {}
    for key, atol, rtol in (("params", 1e-6, 1e-4), ("target", 1e-6, 1e-4),
                            ("m", 1e-9, 1e-3), ("v", 1e-12, 1e-3)):
        d = (kk[key] - kp[key]).abs()
        fracs[key] = float((d <= atol + rtol * kp[key].abs()).float().mean())
        check(fracs[key] >= 0.999, f"update {name}: {key} close on "
              f"{fracs[key]:.5f} < 0.999 of entries")
        if key in ("params", "target"):
            err = max(err, float(d.max()))
    bound = 2 * kw["lr"] * kw["K"]
    check(err <= bound, f"update {name}: max param error {err} > 2 lr K")
    print(f"[drqn_update:{name}] loss[0] {float(lk[0]):.6g}/"
          f"{float(lp[0]):.6g}, max abs err {err:.3g} (limit {bound:.3g}), "
          f"close fractions {fracs} | {CARD}", flush=True)
    return err


def drqn_update_bound_ms(kw, stale):
    """Kernel 4's least time: per update the online forward over obs||next
    and the backward over the obs half (the next half's gradient is zero),
    Adam over every parameter; the target's wide pass at k = 0 and
    ``stale`` per-update target passes; bytes: inputs, noise, the four
    parameter vectors read and written once."""
    F1, F, H, HH = kw["dims"]
    K, bs, T = kw["K"], kw["bs"], kw["T"]
    P = kw["params"].numel()
    N, NB = T * 2 * bs, T * bs
    fwd = (2 * (7 * F1 + F1 * F + F * 4 * H + H * 4 * H) * N + 10 * H * N
           + 2 * (H * HH + 4 * HH) * 2 * bs)
    bwd = (2 * (2 * H * HH + 4 * HH) * bs + (T - 1) * 2 * 4 * H * H * bs
           + 2 * (H * 4 * H + 2 * F * 4 * H + 2 * F1 * F + 7 * F1) * NB
           + 20 * H * NB)
    tpass = 2 * (7 * F1 + F1 * F + F * 4 * H + H * 4 * H) * T \
        + 2 * (H * HH + 4 * HH)
    wide = 0 if kw["tau"] > 0 else K * bs * tpass
    flops = K * (fwd + bwd + 12 * P) + wide + stale * bs * tpass
    nbytes = 4 * (kw["xt"].numel() + kw["nextt"].numel() + kw["meta"].numel()
                  + kw["noise"].numel() + 8 * P + K)
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# ---------------------------------------------------------------------------
# kernel 5: env-only fused rollout (the headline bench)
# ---------------------------------------------------------------------------

PONG_B, PONG_TILE, PONG_STEPS = 32768, 64, 1024


def pong_inputs(seed, dev):
    from pingpong_tpu_torch.bench import rollout_env_cfg
    from pingpong_tpu_torch.env.pong import env_params_from_config, reset

    params = env_params_from_config(rollout_env_cfg())
    return params, reset(params, PONG_B, torch.Generator().manual_seed(seed),
                         dev)


def plain_chunk_events(params, state, steps, seed):
    """The plain version's chunk, step by step, counting the paddle hits
    and the ended episodes (the work the bound counts). Returns ``(state,
    reward sums, hits, ends)``."""
    from pingpong_tpu_torch.ops import pong_kernel as pk

    cells = pk.hash_cells(PONG_B, seed, PONG_TILE, state.ball_x.device)
    tol = float(torch.tensor(0.02, dtype=torch.float32))
    acc = torch.zeros_like(state.ball_x)
    hits = ends = 0
    for i in range(steps):
        state, reward_b, done, hit = pk.plain_step(params, state, i, cells,
                                                   tol)
        acc = acc + reward_b
        hits += int(hit.sum())
        ends += int(done.sum())
    return state, acc, hits, ends


def bit_equal_envs(sk, rk, sp, rp):
    """Per env: every field and the reward sum of the two results equal
    bit for bit."""
    same = rk.view(torch.int32) == rp.view(torch.int32)
    for a, b in zip(sk[:11], sp[:11]):
        same &= (a.view(torch.int32) == b.view(torch.int32)
                 if a.dtype == torch.float32 else a == b)
    return same


def compare_pong(dev):
    """Two seeds, a 64-step chunk at the bench's shape: scores, bounce
    count and step count equal on >= 99.9 % of envs, the seven floats within
    1e-5 and the reward sums equal on those envs; and every env bit-equal
    (the kernel rounds as the plain version does). One full 1024-step
    chunk: reward sums and the envs whose episode ended (the kernel reports
    no episode count) within 1 %. Returns (max abs err, hits, ends, bench
    inputs) of the full chunk's plain run."""
    from pingpong_tpu_torch.ops import pong_kernel as pk

    err = 0.0
    for seed in (1, 2):
        params, st = pong_inputs(600 + seed, dev)
        sk, rk = pk.pong_rollout_cuda(params, st, 64, seed,
                                      tile_rows=PONG_TILE)
        sp, rp = pk.pong_rollout_plain(params, st, 64, seed,
                                       tile_rows=PONG_TILE)
        torch.cuda.synchronize()
        ok = torch.ones(PONG_B, dtype=torch.bool, device=dev)
        for f in ("score_a", "score_b", "bounce_count", "t"):
            ok &= getattr(sk, f) == getattr(sp, f)
        frac = float(ok.float().mean())
        f32_err = max(float((getattr(sk, f) - getattr(sp, f)).abs()[ok].max())
                      for f in ("ball_x", "ball_y", "ball_vx", "ball_vy",
                                "spin", "top_paddle_x", "bottom_paddle_x"))
        rsum_eq = bool((rk == rp)[ok].all())
        bits = float(bit_equal_envs(sk, rk, sp, rp).float().mean())
        print(f"[pong:seed{seed}] 64 steps: discrete match {frac:.6f}, f32 "
              f"max err {f32_err:.3g}, reward sums equal on matching envs "
              f"{rsum_eq}, bit-equal envs {bits:.6f} | {CARD}", flush=True)
        check(frac >= 0.999, f"pong seed {seed}: discrete match {frac}")
        check(f32_err <= 1e-5, f"pong seed {seed}: f32 error {f32_err}")
        check(rsum_eq, f"pong seed {seed}: reward sums differ")
        check(bits == 1.0, f"pong seed {seed}: bit-equal envs {bits}")
        err = max(err, f32_err)
    params, st = pong_inputs(700, dev)
    sk, rk = pk.pong_rollout_cuda(params, st, PONG_STEPS, 5,
                                  tile_rows=PONG_TILE)
    sp, rp, hits, ends = plain_chunk_events(params, st, PONG_STEPS, 5)
    torch.cuda.synchronize()
    rk_sum, rp_sum = float(rk.sum()), float(rp.sum())
    ek, ep = int((sk.t < PONG_STEPS).sum()), int((sp.t < PONG_STEPS).sum())
    same = ((sk.score_a == sp.score_a) & (sk.score_b == sp.score_b)
            & (sk.t == sp.t) & (rk == rp))
    bits = float(bit_equal_envs(sk, rk, sp, rp).float().mean())
    print(f"[pong:chunk] {PONG_STEPS} steps: reward sum {rk_sum:.0f}/"
          f"{rp_sum:.0f}, envs that ended {ek}/{ep}, envs equal in scores, "
          f"t and reward {float(same.float().mean()):.6f}, bit-equal envs "
          f"{bits:.6f}; plain run: {hits} paddle hits, {ends} ended "
          f"episodes | {CARD}", flush=True)
    check(abs(rk_sum - rp_sum) <= 0.01 * max(abs(rp_sum), 1.0),
          "pong chunk: reward sums differ by more than 1 %")
    check(abs(ek - ep) <= 0.01 * max(ep, 1), "pong chunk: ended envs")
    return err, hits, ends, (params, st)


def check_pong_exactness(dev):
    """Kernel 5's shortcuts against the card's own functions on every
    float they can take (``pong_exactness_check``): division by m and by
    inertia, sine and cosine; at the bench's env and the default one."""
    from pingpong_tpu_torch.bench import rollout_env_cfg
    from pingpong_tpu_torch.config import EnvConfig
    from pingpong_tpu_torch.env.pong import env_params_from_config
    from pingpong_tpu_torch.ops.pong_kernel import pong_exactness_check

    for name, cfg in (("bench", rollout_env_cfg()), ("default", EnvConfig())):
        c = pong_exactness_check(env_params_from_config(cfg), dev)
        print(f"[pong:exact] {name} env: results that differ from "
              f"__fdiv_rn by m {c[0]}, by inertia {c[1]} (every float where "
              f"the kernel divides by Markstein; elsewhere, where it takes "
              f"__fdiv_rn, the product would differ on {c[2]} and {c[3]}), "
              f"from sinf {c[4]}, cosf {c[5]} (every float below 105615) "
              f"| {CARD}", flush=True)
        check(c[0] == c[1] == c[4] == c[5] == 0,
              f"pong shortcuts differ at the {name} env")


def sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def pong_bound_ms(B, steps, hits, ends):
    """Kernel 5's least time. Bytes: 11 fields read, 7 + 4 fields and the
    reward sums written, once each. Operations, as the function needs them
    (none is an FMA: the step rounds every product and sum on its own).
    Float (one a lane a cycle, 128 an SM, at the card's maximum SM clock):
    per env-step the two bots (8), the paddles (8), Magnus and the
    integration (5), the walls (4), the paddle lines (10) and the reward
    and its sum (2); per paddle hit the collision (17) and the speed-up
    (2); per ended episode the serve's conversions, scalings, angle, sine,
    cosine and products (20, a sine or cosine counted 1). Integer (the
    INT32 lanes, 64 an SM a cycle): per env-step the scores, the end test
    and the step count (5); per hit the bounce count and the speed-up test
    (2); per ended episode the four hashes (4 x 20). Every operation takes
    a lane's issue slot, so the time is the larger of all operations at
    the lane rate and the integer ones at the INT32 rate."""
    fops = 37 * B * steps + 19 * hits + 20 * ends
    iops = 5 * B * steps + 2 * hits + 80 * ends
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * \
        sm_clock_hz()
    t_ops = max((fops + iops) / (128 * lanes), iops / (64 * lanes))
    t_bytes = (11 + 12) * 4 * B / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def drive_bench(cli, kernels):
    """The bench path: ``cli bench`` in-process at the JAX bench's shapes
    with fewer timing windows, the launch counters set to 0 just before
    and read just after. Returns the launches and the JSON line."""
    import contextlib
    import io

    for k in kernels:
        k.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["bench", "--rollout-windows", "1", "3",
                       "--iteration-windows", "1", "3", "--trials", "2"])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    sys.stderr.write(err.getvalue())
    lines = out.getvalue().strip().splitlines()
    print(f"[main:bench] cli bench rc={rc} in {time.time() - t0:.1f} s; "
          f"launches {launches} | {CARD}", flush=True)
    check(rc == 0 and lines, "cli bench failed")
    result = json.loads(lines[-1])
    value = result.get("value")
    check(isinstance(value, (int, float)) and math.isfinite(value)
          and value > 0, f"bench value {value!r} is not finite and positive")
    check(result.get("device") == torch.cuda.get_device_name(0),
          "the bench line does not name the card")
    drqn_line = [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("[bench] DRQN")]
    m = re.search(r"updates_run (\d+)", drqn_line[-1]) if drqn_line else None
    check(m is not None, "the DRQN bench printed no updates_run")
    for name, n in launches.items():
        if name == "drqn_update" and int(m.group(1)) == 0:
            continue
        check(n > 0, f"{name} kernel never launched on the bench path")
    print(f"[main:bench] {json.dumps(result)}", flush=True)
    return launches


def device_rows(events, n):
    """``(ms per call, name)`` of each kernel and copy the card ran over
    ``n`` calls, largest first. Only device events count: the row of a
    PyTorch op repeats the device time of the kernels it launched."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / 1e3 / n, e.key)
                   for e in events if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)


def profile_calls(name, fn, n, what="iteration"):
    """Where a call's time goes: ``torch.profiler`` over ``n`` warm calls
    of ``fn``; device time per kernel or op and the device's busy share of
    the wall time (kernels may overlap, so it can exceed 1)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = device_rows(prof.key_averages(), n)
    dev_ms = sum(ms for ms, _ in rows)
    check(dev_ms > 0, "profiler recorded no device time")
    print(f"[profile:{name}] per {what} (profiled): wall {wall_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f} | "
          f"{CARD}")
    for ms, key in rows[:8]:
        print(f"[profile:{name}]   {ms:9.4f} ms  {key[:90]}")


def profile_iterations(name, learner, state, opp, n, pool_size=1):
    profile_calls(name, lambda: learner.train_iteration(state, opp,
                                                        pool_size), n)


def profile_bench(dev):
    """Where the bench's time goes: 16 steps of the eager env-only
    rollout, and 3 iterations of the DQN (pool 16) and DRQN benches once
    their update blocks run."""
    from pingpong_tpu_torch import bench

    params, st = pong_inputs(800, dev)
    gen = torch.Generator(dev).manual_seed(0)
    bench.env_only_chunk(params, st, gen, 16)
    profile_calls("bench_env_only", lambda: bench.env_only_chunk(
        params, st, gen, 16), 1, what="16 steps")
    for name, setup in (("bench_dqn_pool16", lambda: bench.dqn_setup(16, dev)),
                        ("bench_drqn", lambda: bench.drqn_setup(dev))):
        learner, state, opp, n = setup()
        for _ in range(3):
            _, m = learner.train_iteration(state, opp, n)
        check(m.updates_run > 0, f"{name}: the update block never ran")
        profile_iterations(name, learner, state, opp, 3, n)


def time_iterations(name, learner, state, opp, n_it=5):
    """Host-clock ms of a warm train iteration (ends in a synchronize),
    once the update block runs."""
    for _ in range(12):
        _, metrics = learner.train_iteration(state, opp, 1)
        if metrics.updates_run > 0:
            break
    check(metrics.updates_run > 0, f"{name}: the update block never ran")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_it):
        _, metrics = learner.train_iteration(state, opp, 1)
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t0) / n_it * 1e3
    check(metrics.updates_run > 0 and metrics.mean_loss == metrics.mean_loss,
          f"{name}: timed iterations ran no finite update")
    c = learner.cfg
    steps = c.num_envs * c.rollout_length
    print(f"[main:{name}] train iteration {it_ms:.3f} ms, "
          f"{steps / it_ms * 1e3:.4g} env-steps/s (num_envs {c.num_envs}, "
          f"rollout {c.rollout_length}, {c.updates_per_iteration} updates "
          f"of {c.batch_size}) | {CARD}", flush=True)
    profile_iterations(name, learner, state, opp, 3)


def train_args(workdir, generations=1, *extra):
    """``configs/qnet.yaml`` with the gate sizes cut (``generations``
    generations of 1 training episode, 2000 eval episodes, thresholds 0);
    the autosave at the shipped interval."""
    return ["train", "--config", str(ROOT / "configs" / "qnet.yaml"),
            "--workdir", str(workdir),
            f"dqn.selfplay.max_generations={generations}",
            "dqn.selfplay.episodes_per_generation=1",
            "dqn.selfplay.eval_episodes=2000",
            "dqn.selfplay.curr_win_threshold=0.0",
            "dqn.selfplay.pool_win_threshold=0.0", *extra]


def train_rnn_args(workdir, generations=1):
    """``configs/rnn.yaml`` with the gate sizes cut (``generations``
    generations of 4000 training episodes, so that update blocks run once
    the buffer gate of 640 admitted episodes opens, 2000 eval episodes,
    thresholds 0); the autosave at the shipped interval."""
    return ["train-rnn", "--config", str(ROOT / "configs" / "rnn.yaml"),
            "--workdir", str(workdir),
            f"drqn.selfplay.max_generations={generations}",
            "drqn.selfplay.episodes_per_generation=4000",
            "drqn.selfplay.eval_episodes=2000",
            "drqn.selfplay.curr_win_threshold=0.0",
            "drqn.selfplay.pool_win_threshold=0.0"]


def metrics_events(path):
    return [json.loads(x) for x in Path(path).read_text().splitlines() if x]


def drive(name, cli, args_fn, kernels, ckpt_sub, promoted_names, log,
          tier):
    """A path's main run: ``cli`` twice in one workdir, the launch
    counters set to 0 just before and read just after. Run 1 trains
    generation 1 and autosaves the full state at the end; run 2 asks for
    two generations, restores it (``tier``) and trains generation 2."""
    from pingpong_tpu_torch.checkpoint.store import list_checkpoints
    from pingpong_tpu_torch.selfplay.pool import load_pool

    workdir = ROOT / "build" / f"chip_smoke_{name}"
    shutil.rmtree(workdir, ignore_errors=True)
    for k in kernels:
        k.launches = 0
    t0 = time.time()
    rc1 = cli.main(args_fn(workdir, 1))
    n_run1 = len(metrics_events(workdir / log))
    kind = "qnet_rnn" if name == "drqn" else "qnet"
    pool = load_pool(workdir / ckpt_sub, kind=kind)
    rc2 = cli.main(args_fn(workdir, 2))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    ckpts = [p.name for p in list_checkpoints(workdir / ckpt_sub)]
    run2 = metrics_events(workdir / log)[n_run1:]
    restore = [e for e in run2 if e["event"] in ("restore",
                                                 "restore_failed")][:1]
    print(f"[main:{name}] cli x2 rc={rc1},{rc2} in {time.time() - t0:.1f} s; "
          f"pool for run 2: {len(pool)} member(s); run 2 first restore event "
          f"{restore}; checkpoints {ckpts}; launches {launches} | {CARD}",
          flush=True)
    check(rc1 == 0 and rc2 == 0, f"cli {name} failed")
    check(len(pool) == 1, f"{name}: run 2 did not load run 1's checkpoint")
    check(restore and restore[0]["event"] == "restore"
          and restore[0]["tier"] == tier,
          f"{name}: run 2 did not restore the autosave (tier {tier})")
    for promoted in promoted_names:
        check(promoted in ckpts, f"no promoted {promoted} checkpoint")
    for k, n in launches.items():
        check(n > 0, f"{k} kernel never launched on the {name} path")
    return launches, workdir


def flat_state(d):
    """Every leaf a resume must reproduce: the train state, frozen A and
    the loop's generator (generators as their state bytes)."""
    from pingpong_tpu_torch.checkpoint.full_state import flatten_tree

    out = {}
    for k, v in flatten_tree({"state": d.state,
                              "a": list(d.params_a.parameters()),
                              "host": d.gen}).items():
        if isinstance(v, torch.Generator):
            v = v.get_state()
        out[k] = v.detach().cpu() if isinstance(v, torch.Tensor) else v
    return out


def check_resume(name, make, block_updates, blocks=3, episodes=1):
    """At the shipped config's full width on the card: a straight run of
    2 x ``blocks`` training blocks against ``blocks`` blocks that autosave
    every update block (async, inside ``_train_block``), one more block
    with the autosave off, trained while the last write may still be in
    flight, then a new driver of another seed in the same workdir (tier
    0/1 restore) and ``blocks`` more. The restore must equal a host copy
    of the state taken at the last ``save()``, and the two runs must end
    equal. Kernels 1-4 are bit-identical run to run, so both comparisons
    are bit for bit."""
    from pingpong_tpu_torch.utils.metrics import MetricsLogger

    root = ROOT / "build" / f"chip_smoke_resume_{name}"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    straight = make(root / "straight", 0, MetricsLogger(echo=False))
    straight.current_generation = 1
    for _ in range(2 * blocks):
        straight._train_block(episodes)
    first_log = root / "first.jsonl"
    first = make(root / "resumed", 0,
                 MetricsLogger(str(first_log), echo=False), block_updates)
    first.current_generation = 1
    at_save = {}
    periodic_save = first.autosave

    def autosave(wait=False):
        check(not wait, f"resume {name}: a periodic autosave waited")
        at_save.clear()
        at_save.update(flat_state(first))   # what save() must snapshot
        return periodic_save(wait)

    first.autosave = autosave
    for _ in range(blocks):
        first._train_block(episodes)
    steps_saved = first.state.train_steps
    saves = [e["train_steps"] for e in metrics_events(first_log)
             if e["event"] == "autosave"]
    first.cfg = dataclasses.replace(
        first.cfg, save_latest_checkpoint_interval_steps=0)
    first._train_block(episodes)       # rewrites the replay in place
    steps_after = first.state.train_steps
    first.flush_autosave()
    del first
    log = root / "resume.jsonl"
    second = make(root / "resumed", 99, MetricsLogger(str(log), echo=False))
    restored = flat_state(second)
    differ_saved = [k for k in at_save if not (
        torch.equal(at_save[k], restored[k])
        if isinstance(at_save[k], torch.Tensor) else at_save[k] == restored[k])]
    for _ in range(blocks):
        second._train_block(episodes)
    torch.cuda.synchronize()
    a, b = flat_state(straight), flat_state(second)
    differ = [k for k in a if not (
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k])]
    nbytes = sum(v.numel() * v.element_size() for v in a.values()
                 if isinstance(v, torch.Tensor))
    event = metrics_events(log)[0]
    print(f"[resume:{name}] periodic async autosaves every {block_updates} "
          f"train steps inside the blocks at {saves}, the last one written "
          f"while training went on to {steps_after}: restore bit-equal to "
          f"the state at its save() {not differ_saved} {differ_saved[:5]}; "
          f"straight vs kill-and-resume at {straight.state.train_steps} "
          f"train steps (restore event {event}): {len(a)} leaves, "
          f"{nbytes / 2**20:.1f} MiB, bit-equal {not differ} {differ[:5]} "
          f"in {time.time() - t0:.1f} s | {CARD}", flush=True)
    check(event["event"] == "restore", f"resume {name}: no restore")
    check(len(saves) >= 2 and saves[-1] == steps_saved and all(
        y - x == block_updates for x, y in zip(saves, saves[1:])),
        f"resume {name}: autosaves at {saves}, not every {block_updates} "
        f"train steps up to {steps_saved}")
    check(steps_after > steps_saved,
          f"resume {name}: no training after the last autosave")
    check(at_save.keys() == restored.keys() and not differ_saved,
          f"resume {name}: the restore differs from the state at save() in "
          f"{differ_saved[:5]}")
    check(straight.state.train_steps > steps_saved > 0,
          f"resume {name}: the update blocks did not run on both sides")
    check(a.keys() == b.keys() and not differ,
          f"resume {name}: straight and resumed runs differ in {differ[:5]}")


def autosave_stalls(dev):
    """The stall bench at the bench's QNet shape and ``configs/rnn.yaml``,
    with the spread of the per-trial stalls beside their median."""
    from pingpong_tpu_torch.bench import dqn_setup
    from pingpong_tpu_torch.tools import autosave_stall_bench as sb

    out = {}
    for name, setup, warm in (("qnet", lambda: dqn_setup(0, dev), 0),
                              ("rnn", lambda: sb.rnn_setup(dev), 200)):
        workdir = ROOT / "build" / "chip_smoke_autosave"
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        r = sb.measure(*setup(), workdir, sb.ITERS[name], warm_iters=warm)
        shutil.rmtree(workdir, ignore_errors=True)
        plain, paired = r["window_plain_s"], sorted(r["stall_paired_s"])
        print(f"[autosave:{name}] state {r['state_bytes'] / 2**20:.1f} MiB: "
              f"sync_save_s {r['sync_save_s']:.4f}, async_call_s "
              f"{r['async_call_s']:.6f}, stall_per_autosave_s "
              f"{r['stall_per_autosave_s']:.6f} ({len(plain)} trials; paired "
              f"stalls min {paired[0]:.4f} quartiles "
              f"{paired[len(paired) // 4]:.4f}-"
              f"{paired[3 * len(paired) // 4]:.4f} max {paired[-1]:.4f} s; "
              f"window of {r['iterations_per_window']} iterations: plain "
              f"{[round(x, 4) for x in plain]}, with a save "
              f"{[round(x, 4) for x in r['window_with_save_s']]}; median "
              f"plain {sorted(plain)[len(plain) // 2]:.4f} s; "
              f"{r['updates_in_windows']} updates) | {CARD}", flush=True)
        check(r["updates_in_windows"] > 0, f"autosave {name}: no updates")
        out[name] = r
    return out


def eval_seconds(log):
    return [e["eval_s"] for e in metrics_events(log) if e["event"] == "eval"]


def gates_match(cli, fused_log, kernels):
    """``cli train`` with the match-runner gates (``use_pallas_eval=
    false``), single-seat and side-balanced, each in a fresh workdir; the
    gate's time beside the fused gate's of the main run (2000 games vs A,
    the pool empty, in both)."""
    fused = eval_seconds(fused_log)[0]
    for tag, extra in (("single", []),
                       ("balanced", ["dqn.selfplay.swap_sides_eval=true"])):
        workdir = ROOT / "build" / f"chip_smoke_gates_{tag}"
        shutil.rmtree(workdir, ignore_errors=True)
        for k in kernels:
            k.launches = 0
        rc = cli.main(train_args(workdir, 1, "dqn.use_pallas_eval=false",
                                 *extra))
        torch.cuda.synchronize()
        ev = metrics_events(workdir / "train_qnet_metrics.jsonl")
        evals = [e for e in ev if e["event"] == "eval"] or [{}]
        seats = [e for e in ev if e["event"] == "eval_seats"]
        print(f"[gates:match] {tag}: cli train rc={rc}, gate "
              f"{evals[0].get('eval_s')} s (win_vs_A "
              f"{evals[0].get('win_vs_A')}; seats {seats[:1]}) against the "
              f"fused gate's {fused:.4f} s of the main run; launches "
              f"{({k.name: k.launches for k in kernels})} | {CARD}",
              flush=True)
        check(rc == 0 and "eval_s" in evals[0]
              and (seats or tag == "single"), f"gates:match {tag} failed")
        check(any(e["event"] == "promoted" for e in ev),
              f"gates:match {tag}: no promotion")


def tournaments(cli, qnet_ckpts, rnn_ckpts, episodes=200):
    """``cli round-robin`` over the QNet checkpoints and the bot, and
    ``cli arena`` twice over the DRQN checkpoints and the bot (the second
    run must plan 0 pairings); games/s of each."""
    import contextlib
    import io

    out_dir = ROOT / "build" / "chip_smoke_tournament"
    shutil.rmtree(out_dir, ignore_errors=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["round-robin", "--ckpt-dir", str(qnet_ckpts),
                       "--out", str(out_dir / "rr"), "--episodes",
                       str(episodes)])
    rr_s = time.perf_counter() - t0
    line = [ln for ln in buf.getvalue().splitlines() if "games in" in ln]
    print(f"[tournament] round-robin rc={rc} {line} ({rr_s:.2f} s with "
          f"loading and files) | {CARD}", flush=True)
    check(rc == 0 and line, "cli round-robin failed")
    db = out_dir / "arena_db.json"
    outs = []
    for _ in range(2):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["arena", "--ckpt-dir", str(rnn_ckpts), "--db",
                           str(db), "--out", str(out_dir / "arena"),
                           "--episodes", str(episodes)])
        outs.append((rc, time.perf_counter() - t0, buf.getvalue()))
    games = len(json.loads(db.read_text())["match_history"])
    plans = [[ln for ln in o.splitlines() if "pairings" in ln][:1]
             for _, _, o in outs]
    print(f"[tournament] arena x2 rc={[o[0] for o in outs]}: {games} games "
          f"in {outs[0][1]:.2f} s ({games / outs[0][1]:.0f} games/s with "
          f"loading and files); plans {plans}; rerun "
          f"{outs[1][1]:.2f} s | {CARD}", flush=True)
    check(all(o[0] == 0 for o in outs), "cli arena failed")
    check(plans[1] and " 0 pairings" in plans[1][0],
          "the second arena run planned pairings")


# ---------------------------------------------------------------------------
# the viewer, the C++ engine and the checkpoint importer
# ---------------------------------------------------------------------------

def engine_states(n, seed):
    """``n`` random mid-rally states on the host, as
    ``tests/test_native_engine.py`` draws them."""
    from pingpong_tpu_torch.native.engine import SoAState

    rng = np.random.default_rng(seed)
    s = SoAState.zeros(n)
    s.ball_x[:] = rng.uniform(0.05, 0.95, n)
    s.ball_y[:] = rng.uniform(0.05, 0.95, n)
    ang = (rng.uniform(np.deg2rad(20), np.deg2rad(70), n)
           * rng.choice([-1, 1], n))
    speed = rng.uniform(0.01, 0.05, n)
    s.ball_vx[:] = speed * np.cos(ang)
    s.ball_vy[:] = speed * np.sin(ang)
    s.spin[:] = rng.uniform(-10, 10, n)
    s.top_x[:] = rng.uniform(0.2, 0.8, n)
    s.bottom_x[:] = rng.uniform(0.2, 0.8, n)
    return s


def view_engine(env_cfg, n=4096, steps=200):
    """``[view:engine]``: the port's C++ engine, built here with ``g++``
    (a failed build fails the smoke), steps ``n`` random states ``steps``
    times on the host, and the port's ``env.pong.step`` steps the same
    states with the same random actions on the card. An env agrees while
    ball_x and ball_vy are within 2e-5, spin within 2e-3 and the scores
    and the reward are equal; more than 97 % must agree at the end."""
    from pingpong_tpu_torch.env.pong import (
        EnvState,
        env_params_from_config,
        step,
    )
    from pingpong_tpu_torch.native.engine import NativeEngine, build_engine

    t0 = time.perf_counter()
    build_engine(force=True)
    build_s = time.perf_counter() - t0
    native = NativeEngine(env_cfg)
    params = env_params_from_config(env_cfg)
    s = engine_states(n, 1)
    dev = lambda a: torch.from_numpy(np.copy(a)).to(DEV)
    state = EnvState(
        ball_x=dev(s.ball_x), ball_y=dev(s.ball_y), ball_vx=dev(s.ball_vx),
        ball_vy=dev(s.ball_vy), spin=dev(s.spin), top_paddle_x=dev(s.top_x),
        bottom_paddle_x=dev(s.bottom_x), score_a=dev(s.score_a),
        score_b=dev(s.score_b), bounce_count=dev(s.bounce), t=dev(s.t),
        done=torch.zeros((n,), dtype=torch.bool, device=DEV))
    rng = np.random.default_rng(2)
    agree = np.ones(n, bool)
    host_s = 0.0
    for _ in range(steps):
        aa, ab = rng.integers(0, 3, (2, n)).astype(np.int32)
        t0 = time.perf_counter()
        rb, _ = native.step(s, aa, ab)
        host_s += time.perf_counter() - t0
        state, out = step(params, state, dev(aa), dev(ab))
        x, vy, spin, rb_c = torch.stack([
            state.ball_x, state.ball_vy, state.spin,
            out.reward_b]).cpu().numpy()
        sa, sb = torch.stack([state.score_a, state.score_b]).cpu().numpy()
        agree &= ((np.abs(s.ball_x - x) <= 2e-5)
                  & (np.abs(s.ball_vy - vy) <= 2e-5)
                  & (np.abs(s.spin - spin) <= 2e-3) & (s.score_a == sa)
                  & (s.score_b == sb) & (rb == rb_c))
    rate = n * steps / host_s
    print(f"[view:engine] g++ build {build_s:.2f} s; {n} envs x {steps} steps "
          f"(configs/qnet.yaml env): agreement {agree.mean():.4f}, fork rate "
          f"{1 - agree.mean():.4f}; engine {rate:.4g} env-steps/s on the "
          f"host ({host_s:.3f} s in pong_step_batch) | {CARD}", flush=True)
    check(agree.mean() > 0.97,
          f"the port's env on the card forks from the C++ engine on "
          f"{1 - agree.mean():.2%} of envs")


def first_fork(a, b):
    """The first step at which two recordings differ in a discrete field
    (actions, scores, done), or None."""
    n = min(a.length, b.length)
    diff = np.zeros(n, bool)
    for f in ("action_a", "action_b", "score_a", "score_b", "done"):
        diff |= getattr(a, f)[:n] != getattr(b, f)[:n]
    return int(diff.argmax()) if diff.any() else None


def view_record(entries, max_steps=5000, seed=0):
    """``[view:record]``: ``record_episode`` on the card and on the CPU
    from the same seed, at most ``max_steps`` steps (the JAX default),
    for each seating. Bot vs bot must be bit-equal; with nets, the
    discrete fields must be equal and the floats within 1e-5 up to the
    first fork (an argmax tie that cuBLAS and the CPU break apart), and
    the lengths equal when nothing forks."""
    from pingpong_tpu_torch.viewer.record import _FLOATS, record_episode

    for name, a, b in entries:
        record_episode(ENV_PARAMS, a, b, torch.Generator().manual_seed(seed),
                       max_steps=32, device=DEV)       # warm the card

        def timed(dev):
            t0 = time.perf_counter()
            traj = record_episode(ENV_PARAMS, a, b,
                                  torch.Generator().manual_seed(seed),
                                  max_steps=max_steps, device=dev)
            return traj, time.perf_counter() - t0

        (card, card_s), (cpu, cpu_s) = timed(DEV), timed("cpu")
        fork = first_fork(card, cpu)
        upto = min(card.length, cpu.length) if fork is None else fork
        err = max(float(np.abs(getattr(card, f)[:upto]
                               - getattr(cpu, f)[:upto]).max(initial=0.0))
                  for f in _FLOATS)
        print(f"[view:record] {name}: {card.length} steps on the card, "
              f"{cpu.length} on the CPU (A {int(card.score_a[-1])} : "
              f"{int(card.score_b[-1])} B); first fork "
              f"{'none' if fork is None else f'at step {fork}'}; float max "
              f"abs err {err:.3g} before it; {card_s:.3f} s an episode on "
              f"the card ({card.length / card_s:.0f} steps/s), {cpu_s:.3f} s "
              f"on the CPU ({cpu.length / cpu_s:.0f} steps/s) | {CARD}",
              flush=True)
        if name == "bot_vs_bot":
            for f in dataclasses.fields(card):
                check(np.array_equal(getattr(card, f.name),
                                     getattr(cpu, f.name)),
                      f"view:record bot vs bot: {f.name} differs between "
                      f"the card and the CPU")
        check(err <= 1e-5, f"view:record {name}: floats differ by {err} "
                           f"before the first fork")
        check(fork is not None or card.length == cpu.length,
              f"view:record {name}: lengths differ without a fork")


def view_cli(qnet_ckpt, rnn_ckpt, env_cfg):
    """``[view:cli]``: ``cli view`` on the card, QNet (A) vs DRQN (B), two
    episodes to GIFs whose frame counts must equal the logged lengths;
    then ``run_live`` headless for one episode of the same pair through
    the host policies, which must leave the card untouched. Both need
    PIL; without it the phase says so on a line of its own."""
    import subprocess

    try:
        from PIL import Image
    except ImportError:
        print("[view:cli] not run: PIL is not installed", flush=True)
        return
    from pingpong_tpu_torch.selfplay.pool import load_params_any
    from pingpong_tpu_torch.viewer.live import run_live

    out_dir = ROOT / "build" / "chip_smoke_view"
    shutil.rmtree(out_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "pingpong_tpu_torch.cli", "view",
           "--device", DEV.type, "--config",
           str(ROOT / "configs" / "qnet.yaml"), "--model-a", str(qnet_ckpt),
           "--model-b", str(rnn_ckpt), "--episodes", "2", "--out",
           str(out_dir / "view.gif")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    lengths = [int(m) for m in re.findall(r"\[view\] episode \d+: (\d+) steps",
                                          proc.stdout)]
    frames = [Image.open(out_dir / f"view_{i}.gif").n_frames
              if (out_dir / f"view_{i}.gif").exists() else None
              for i in (1, 2)]
    print(f"[view:cli] cli view rc={proc.returncode} in {wall:.2f} s (wall, "
          f"a new process): episodes {lengths} steps, GIF frames {frames} | "
          f"{CARD}", flush=True)
    check(proc.returncode == 0, f"cli view failed: {proc.stderr[-2000:]}")
    check(len(lengths) == 2 and frames == lengths,
          "cli view: the GIFs' frame counts are not the logged lengths")

    pa, pb = load_params_any(qnet_ckpt), load_params_any(rnn_ckpt)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    n = 0
    for frame in run_live(env_cfg, pa, pb, episodes=1, seed=0,
                          size=env_cfg.render_size):
        n += 1
        check(frame.shape == (env_cfg.render_size, env_cfg.render_size, 3),
              "run_live: bad frame")
    live_s = time.perf_counter() - t0
    print(f"[view:cli] run_live (C++ engine, host numpy policies, "
          f"{env_cfg.render_size} px): {n} frames in {live_s:.3f} s, "
          f"{n / live_s:.1f} frames/s; card memory "
          f"{torch.cuda.memory_allocated() - before} bytes more | {CARD}",
          flush=True)
    check(n > 0, "run_live yielded no frame")
    check(torch.cuda.memory_allocated() == before,
          "run_live put a tensor on the card")


def reference_state_dict(p):
    """A QNet's tensors under the reference's dueling NoisyNet key names
    (torch layout: weights ``(out, in)``)."""
    sd = {}
    for ref, layer in (("features.0", p.feat1), ("features.2", p.feat2)):
        sd[f"{ref}.weight"] = layer.w.detach().T.contiguous()
        sd[f"{ref}.bias"] = layer.b.detach().clone()
    for ref, layer in (("fc_V", p.fc_v), ("fc_A", p.fc_a)):
        sd[f"{ref}.weight_mu"] = layer.w_mu.detach().T.contiguous()
        sd[f"{ref}.weight_sigma"] = layer.w_sigma.detach().T.contiguous()
        sd[f"{ref}.bias_mu"] = layer.b_mu.detach().clone()
        sd[f"{ref}.bias_sigma"] = layer.b_sigma.detach().clone()
    return sd


def import_check(cli, qnet_ckpt, n=4096):
    """``[import]``: ``model5-1`` written as a reference ``.pth``
    (``modelB_state``), converted by ``cli import-torch``, loaded on the
    card: its Q-values on ``n`` observations must equal the original's."""
    from pingpong_tpu_torch.models.qnet import qnet_apply
    from pingpong_tpu_torch.selfplay.pool import load_params_any

    out_dir = ROOT / "build" / "chip_smoke_import"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    orig = load_params_any(qnet_ckpt, device=DEV)
    torch.save({"modelB_state": reference_state_dict(
        load_params_any(qnet_ckpt)), "episode": 1}, out_dir / "model5-1.pth")
    rc = cli.main(["import-torch", str(out_dir / "model5-1.pth"),
                   str(out_dir / "model5-1")])
    imported = load_params_any(out_dir / "model5-1", device=DEV)
    g = torch.Generator().manual_seed(5)
    obs = (torch.rand((n, 7), generator=g) * 2.0 - 1.0).to(DEV)
    q0, q1 = qnet_apply(orig, obs), qnet_apply(imported, obs)
    err = float((q0 - q1).abs().max())
    print(f"[import] cli import-torch rc={rc}; Q of the imported model5-1 "
          f"on {n} observations on the card: max abs err {err} | {CARD}",
          flush=True)
    check(rc == 0 and torch.equal(q0, q1),
          "the imported checkpoint's Q-values differ from the original's")


def rnn_time_rows():
    """Kernel 3's timed shapes: ``configs/rnn.yaml``'s train chunk (2
    slots), its 256-step gate chunk (1 slot, no transitions), the DRQN
    bench's 4096 envs, and the train chunk against a full pool (``pool_max``
    + 1 slots) in contiguous buckets and in the binding a pool change
    leaves (``rebind_opp_idx``)."""
    RT, slots = RNN_CFG.rollout_length, RNN_CFG.pool_max + 1
    return [
        ("recurrent_rollout:train", rnn_inputs(500, 2, False, DEV), RT, 10),
        ("recurrent_rollout:gate", rnn_inputs(501, 1, True, DEV), 256, 5),
        ("recurrent_rollout:bench", rnn_inputs(502, 1, False, DEV, 4096), RT,
         5),
        ("recurrent_rollout:train_pool16", rnn_inputs(503, slots, False, DEV),
         RT, 10),
        ("recurrent_rollout:train_rebind", rnn_inputs(
            504, slots, False, DEV, rebind=True), RT, 10),
    ]


def report_rnn_stream(name, inp, steps, ms, resident_check):
    """Print kernel 3's L2 weight bytes of a chunk, and the rate they
    imply at this time, under the parent's and the one-member stream
    counts (``rnn_weight_bytes``), with the launch plan; fail if a block
    holds two opponents, or (``resident_check``) if the blocks do not all
    fit at once."""
    parent, pmax, one = rnn_weight_bytes(inp["opp_idx"], steps)
    line = (f"[stream:{name}] {ms:.4f} ms; L2 weight bytes a chunk: 8-env "
            f"blocks with a member loop (up to {pmax} opponent passes a "
            f"block-step) {parent / 1e9:.4f} GB, {parent / ms / 1e9:.3f} "
            f"TB/s at this time")
    if one is not None:
        change, plan = one["bytes"], one["plan"]
        n_blocks, rounds = one["n_blocks"], one["rounds"]
        idle = check_one_member_blocks(inp["opp_idx"], plan.table, n_blocks)
        cfg = plan.config
        line += (f"; blocks of one member (1 opponent pass a block-step) "
                 f"{change / 1e9:.4f} GB, {change / ms / 1e9:.3f} TB/s; "
                 f"{plan.envs} envs a block, {n_blocks} blocks "
                 f"({idle} idle lanes) in {plan.grid} launched, "
                 f"{rounds} round(s); {cfg.blocks_per_sm} block(s) an SM "
                 f"and {cfg.resident} resident at once, ring {cfg.stages} x "
                 f"{4 * cfg.stage_floats} B, {cfg.smem} B shared, "
                 f"{cfg.threads} threads")
        if resident_check:
            check(rounds == 1, f"{name}: blocks not all resident")
    print(line + f" | {CARD}", flush=True)


def time_rollouts(resident_check=False):
    """CUDA-event means (warm launches) of kernels 1, 3 and 5 at every
    shape their paths launch them at: kernel 1 at ``configs/qnet.yaml``'s
    train chunk (2 slots sharing a trunk, transitions), its 256-step gate
    chunk (1 slot, no transitions) and the bench's pool-16 chunk (8192 x
    128, 17 slots of one trunk); kernel 3 at ``rnn_time_rows``, each with
    its weight-stream report; kernel 5 at the bench's chunk (32768 x 1024,
    tile 64). Uses whichever checkout's package was imported first."""
    from pingpong_tpu_torch.ops import actor_rollout as ar
    from pingpong_tpu_torch.ops import pong_kernel as pk
    from pingpong_tpu_torch.ops import recurrent_rollout as rr

    T = MAX_ROLLOUT
    rows = [
        ("actor_rollout:train", actor_inputs(200, 2, True, False, QNET_B, DEV),
         T, 20),
        ("actor_rollout:gate", actor_inputs(201, 1, False, True, QNET_B, DEV),
         256, 10),
        ("actor_rollout:bench_pool16", actor_inputs(202, 17, True, False, 8192,
                                                    DEV), 128, 10),
    ]
    times = {name: cuda_ms(lambda: run_actor(ar.actor_rollout_cuda, inp,
                                             steps), reps)
             for name, inp, steps, reps in rows}
    for name, inp, steps, reps in rnn_time_rows():
        ms = cuda_ms(lambda: run_rnn(rr.recurrent_rollout_cuda, inp, steps),
                     reps)
        times[name] = ms
        report_rnn_stream(name, inp, steps, ms, resident_check)
    params, st = pong_inputs(700, DEV)
    times["pong_kernel:bench"] = cuda_ms(lambda: pk.pong_rollout_cuda(
        params, st, PONG_STEPS, 5, tile_rows=PONG_TILE), 20)
    return times


def kernel_row(name, source, replaces, launches, err, ms, plain, bound):
    """One entry of the ``kernels`` line. No single PyTorch call computes
    any of these fused functions, so ``library_ms`` is null."""
    return {"name": name, "route": "cuda",
            "source": f"pingpong_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None, "compare": "pass"}


def setup(root: Path):
    """Import the package of the checkout at ``root`` and set the globals
    from the card and that checkout's configs."""
    global CARD, DEV, ENV_PARAMS, TILE, MAX_EP_STEPS, MAX_ROLLOUT, QNET_B
    global RNN_ENV, RNN_CFG
    sys.path.insert(0, str(root))
    from pingpong_tpu_torch.bench import card_name
    from pingpong_tpu_torch.config import load_config
    from pingpong_tpu_torch.env.pong import env_params_from_config

    DEV = torch.device("cuda")
    CARD = card_name(DEV)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(root / "configs" / "qnet.yaml")
    ENV_PARAMS = env_params_from_config(cfg.env)
    QNET_B, MAX_ROLLOUT = cfg.dqn.num_envs, cfg.dqn.rollout_length
    TILE = min(cfg.dqn.pallas_tile_rows, QNET_B)
    MAX_EP_STEPS = cfg.env.max_episode_steps
    rcfg = load_config(root / "configs" / "rnn.yaml")
    RNN_ENV = env_params_from_config(rcfg.env)
    RNN_CFG = rcfg.drqn
    return cfg, rcfg


def rollout_times_only(root: Path) -> int:
    """``--rollout-times``: kernels 1, 3 and 5 of the checkout at
    ``root``."""
    setup(root)
    from pingpong_tpu_torch.ops import actor_rollout as ar
    from pingpong_tpu_torch.ops import pong_kernel as pk
    from pingpong_tpu_torch.ops import recurrent_rollout as rr
    from pingpong_tpu_torch.ops.build import build_all

    build_all([ar.KERNEL, rr.KERNEL, pk.KERNEL])
    times = time_rollouts()
    print(json.dumps({"rollout_times": str(root), "card": CARD, "ms": times}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rollout-times", type=Path, metavar="DIR")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if a.rollout_times is not None:
        return rollout_times_only(a.rollout_times.resolve())
    cfg, rcfg = setup(ROOT)
    from pingpong_tpu_torch import cli
    from pingpong_tpu_torch.models.policy import (
        qnet_act_greedy,
        rnn_act_greedy,
    )
    from pingpong_tpu_torch.models.qnet_rnn import init_hidden
    from pingpong_tpu_torch.ops import actor_rollout as ar
    from pingpong_tpu_torch.ops import dqn_update as du
    from pingpong_tpu_torch.ops import drqn_update as dru
    from pingpong_tpu_torch.ops import pong_kernel as pk
    from pingpong_tpu_torch.ops import recurrent_rollout as rr
    from pingpong_tpu_torch.ops.build import build_all
    from pingpong_tpu_torch.selfplay.pool import load_params_any
    from pingpong_tpu_torch.train.dqn import DQNLearner
    from pingpong_tpu_torch.train.drqn import DRQNLearner

    t_start = time.time()
    dev = DEV
    B, T = QNET_B, MAX_ROLLOUT

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    kernels = [ar.KERNEL, du.KERNEL, rr.KERNEL, dru.KERNEL, pk.KERNEL]
    logs = build_all(kernels)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build:{name}] {line.strip()}")
    print(f"[build] {len(kernels)} kernels built for sm_90a in "
          f"{time.time() - t0:.1f} s", flush=True)
    check_no_spills(logs, ("actor_rollout", "recurrent_rollout",
                           "pong_kernel"))
    check_no_stack_frame(logs["pong_kernel"], "pong_rollout_kernel")

    # ---- 2. kernel vs plain ------------------------------------------------
    actor_err = 0.0
    # the last case is the bench's pool-16 shape: 8192 envs, 17 slots
    for i, (name, n_slots, shared, eval_mode, n_envs) in enumerate([
            ("empty_pool", 1, False, False, B),
            ("3slot_shared_trunk", 3, True, False, B),
            ("3slot_full", 3, False, False, B),
            ("eval", 1, False, True, B),
            ("bench_17slot_shared_trunk", 17, True, False, 8192)]):
        inp = actor_inputs(100 + i, n_slots, shared, eval_mode, n_envs, dev)
        actor_err = max(actor_err, compare_actor(name, inp))
    upd_err = 0.0
    upd_inp = update_inputs(7, dev)
    upd_inp512 = update_inputs(8, dev, bs=512)
    for name, heads_only, tau, interval in [
            ("heads_only_hard_sync", True, 0.0, 16),
            ("full_backward", False, 0.0, 10_000),
            ("polyak", True, 0.005, 10_000)]:
        err, idx = compare_update(name, upd_inp, heads_only, tau, interval)
        upd_err = max(upd_err, err)
        if name == "heads_only_hard_sync":
            upd_idx = idx
    upd_err = max(upd_err, compare_update_stepwise(
        "bs512_heads_only_hard_sync", upd_inp512, True, 0.0, 16))
    rnn_err = 0.0
    # the last case is the DRQN bench's 4096 envs
    for i, (name, n_slots, eval_mode, n_envs, rebind) in enumerate([
            ("1slot", 1, False, None, False),
            ("3slot_bucketed", 3, False, None, False),
            ("eval", 1, True, None, False),
            ("bench_4096_envs", 1, False, 4096, False),
            ("rebind_17slot", RNN_CFG.pool_max + 1, False, None, True)]):
        rnn_err = max(rnn_err, compare_rnn(name, rnn_inputs(
            300 + i, n_slots, eval_mode, dev, n_envs, rebind)))
    drqn_err = 0.0
    interval = RNN_CFG.target_update_interval
    for name, ts0, tau in [("no_sync", 0, 0.0),
                           ("hard_sync_mid_block", interval - 10, 0.0),
                           ("polyak", 0, 0.005)]:
        drqn_err = max(drqn_err, compare_drqn_update(
            name, drqn_update_inputs(400, dev, ts0=ts0, interval=interval,
                                     tau=tau)))
    pong_err, pong_hits, pong_ends, (pong_params, pong_st) = compare_pong(dev)
    check_pong_exactness(dev)
    check_bit_reproducible(upd_inp, drqn_update_inputs(400, dev))
    check_rollouts_reproducible(
        actor_inputs(150, 17, True, False, 8192, dev),
        rnn_inputs(350, 3, False, dev))
    check_pong_reproducible(pong_params, pong_st)

    # ---- 3. main paths: cli train and cli train-rnn, twice each ------------
    qnet_launches, qnet_dir = drive(
        "qnet", cli, train_args, [ar.KERNEL, du.KERNEL], "checkpoints",
        ("model5-1", "model5-2"), "train_qnet_metrics.jsonl", 0)
    promoted = load_params_any(qnet_dir / "checkpoints" / "model5-1")
    acts = qnet_act_greedy(promoted, torch.rand((1024, 7)))
    check(bool(((acts >= 0) & (acts <= 2)).all())
          and all(bool(torch.isfinite(p).all())
                  for p in promoted.parameters()),
          "promoted checkpoint is not a finite QNet")
    rnn_launches, rnn_dir = drive(
        "drqn", cli, train_rnn_args, [rr.KERNEL, dru.KERNEL],
        "checkpoints_rnn", ("rnn_pong_soul_1", "rnn_pong_soul_2"),
        "train_rnn_metrics.jsonl", 1)
    rnn_promoted = load_params_any(rnn_dir / "checkpoints_rnn" /
                                   "rnn_pong_soul_2")
    ra, _ = rnn_act_greedy(rnn_promoted, torch.rand((1024, 7)),
                           init_hidden(rnn_promoted, (1024,)))
    check(type(rnn_promoted).__name__ == "QNetRNN"
          and bool(((ra >= 0) & (ra <= 2)).all())
          and all(bool(torch.isfinite(p).all())
                  for p in rnn_promoted.parameters()),
          "promoted rnn_pong_soul_2 is not a finite QNetRNN")
    bench_launches = drive_bench(cli, kernels)

    # ---- 3b. resume, autosave stall, match gates, tournaments ------------
    from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
    from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay

    def maker(cls, env, c):
        """A driver at ``c``, the autosave interval replaceable."""
        return lambda w, seed, log, interval=(
            c.save_latest_checkpoint_interval_steps): cls(
                env, dataclasses.replace(
                    c, save_latest_checkpoint_interval_steps=interval),
                workdir=str(w), seed=seed, logger=log, device="cuda")

    check_resume("qnet", maker(QNetSelfPlay, cfg.env, cfg.dqn),
                 cfg.dqn.updates_per_iteration)
    check_resume("drqn", maker(DRQNSelfPlay, rcfg.env, rcfg.drqn),
                 rcfg.drqn.updates_per_iteration)
    autosave_stalls(dev)
    gates_match(cli, qnet_dir / "train_qnet_metrics.jsonl",
                [ar.KERNEL, du.KERNEL])
    tournaments(cli, qnet_dir / "checkpoints", rnn_dir / "checkpoints_rnn")

    # ---- 3c. viewer, C++ engine, checkpoint import (no kernel) ----------
    from pingpong_tpu_torch.evaluation.match import BOT, QNET, RNN
    from pingpong_tpu_torch.evaluation.registry import BOT_ID, ModelEntry

    qnet_ckpt = qnet_dir / "checkpoints" / "model5-1"
    rnn_ckpt = rnn_dir / "checkpoints_rnn" / "rnn_pong_soul_1"
    for k in kernels:
        k.launches = 0
    view_engine(cfg.env)
    bot = ModelEntry(BOT_ID, BOT, None)
    q1 = ModelEntry("model5-1", QNET, str(qnet_ckpt))
    r1 = ModelEntry("rnn_pong_soul_1", RNN, str(rnn_ckpt))
    view_record([("bot_vs_bot", bot, bot), ("model5-1_vs_bot", q1, bot),
                 ("rnn_pong_soul_1_vs_model5-1", r1, q1)])
    view_cli(qnet_ckpt, rnn_ckpt, cfg.env)
    import_check(cli, qnet_ckpt)
    print(f"[view] kernel launches over the view phases "
          f"{ {k.name: k.launches for k in kernels} } (the viewer's path "
          f"runs no kernel) | {CARD}", flush=True)

    # ---- 4. timings -------------------------------------------------------
    learner = DQNLearner(cfg.env, cfg.dqn, device="cuda")
    state = learner.init_state(3)
    opp = learner.prepare_opponents([learner.params_b(state), promoted])
    time_iterations("qnet", learner, state, opp)
    rlearner = DRQNLearner(rcfg.env, RNN_CFG, device="cuda")
    rstate = rlearner.init_state(3)
    ropp = rlearner.prepare_opponents([rlearner.params_b(rstate),
                                       rnn_promoted])
    time_iterations("drqn", rlearner, rstate, ropp)
    profile_bench(dev)

    ro = time_rollouts(resident_check=True)
    a_ms = ro["actor_rollout:train"]
    inp = actor_inputs(200, 2, True, False, B, dev)
    a_plain = cuda_ms(lambda: run_actor(ar.actor_rollout_plain, inp, T), 3, 1)
    ae_bound = actor_bound_ms(B, 256, 1, emit=False)
    ab_bound = actor_bound_ms(8192, 128, 17)
    ukw = update_kwargs(upd_inp, True, 0.0, 1000)
    u_ms = cuda_ms(lambda: du.dqn_update_cuda(**ukw), 10)
    u_plain = cuda_ms(lambda: du.dqn_update_plain(**ukw), 2, 1)
    ukw512 = update_kwargs(upd_inp512, True, 0.0, 1000)
    u512_ms = cuda_ms(lambda: du.dqn_update_cuda(**ukw512), 10)
    RB, RT = RNN_CFG.num_envs, RNN_CFG.rollout_length
    rtile = min(RNN_CFG.pallas_tile_rows, RB)
    r_ms = ro["recurrent_rollout:train"]
    rinp = rnn_inputs(500, 2, False, dev)
    r_plain = cuda_ms(lambda: run_rnn(rr.recurrent_rollout_plain, rinp, RT),
                      1, 1)
    b_bound = rnn_bound_ms(4096, RT, 1, 4096 // rtile)
    dkw = drqn_update_inputs(600, dev)
    d_ms = cuda_ms(lambda: dru.drqn_update_cuda(**fresh(dkw)), 10)
    d_plain = cuda_ms(lambda: dru.drqn_update_plain(**fresh(dkw)), 1, 1)
    p_ms = ro["pong_kernel:bench"]
    p_plain = cuda_ms(lambda: pk.pong_rollout_plain(
        pong_params, pong_st, PONG_STEPS, 5, tile_rows=PONG_TILE), 1, 1)
    bounds = {
        "actor_rollout": actor_bound_ms(B, T, 2),
        "dqn_update": update_bound_ms(256, 64, (1 << 20) // 128, True,
                                      upd_idx),
        "recurrent_rollout": rnn_bound_ms(RB, RT, 2, RB // rtile),
        "drqn_update": drqn_update_bound_ms(dkw, 0),
        "pong_kernel": pong_bound_ms(PONG_B, PONG_STEPS, pong_hits,
                                     pong_ends),
    }
    e_bound = rnn_bound_ms(RB, 256, 1, RB // rtile, emit=False)
    print(f"[time] actor_rollout {a_ms:.4f} ms (plain {a_plain:.2f} ms), "
          f"eval chunk ({B} x 256, no transitions) "
          f"{ro['actor_rollout:gate']:.4f} ms (bound {ae_bound[0]:.4f} ms by "
          f"{ae_bound[1]}), bench pool-16 chunk (8192 x 128, 17 slots) "
          f"{ro['actor_rollout:bench_pool16']:.4f} ms (bound "
          f"{ab_bound[0]:.4f} ms by {ab_bound[1]}); "
          f"dqn_update {u_ms:.4f} ms (plain {u_plain:.2f} ms; bs 512 "
          f"{u512_ms:.4f} ms); "
          f"recurrent_rollout {r_ms:.4f} ms (plain {r_plain:.2f} ms), eval "
          f"chunk (T 256, no transitions) {ro['recurrent_rollout:gate']:.4f} "
          f"ms (bound {e_bound[0]:.4f} ms by {e_bound[1]}), B 4096 chunk "
          f"{ro['recurrent_rollout:bench']:.4f} ms (bound {b_bound[0]:.4f} ms "
          f"by {b_bound[1]}), train chunk at {RNN_CFG.pool_max + 1} slots "
          f"{ro['recurrent_rollout:train_pool16']:.4f} ms, after a pool "
          f"change {ro['recurrent_rollout:train_rebind']:.4f} ms; "
          f"drqn_update {d_ms:.4f} ms "
          f"(plain {d_plain:.2f} ms); pong_kernel {p_ms:.4f} ms (plain "
          f"{p_plain:.2f} ms, {PONG_B * PONG_STEPS / p_ms * 1e3:.4g} "
          f"env-steps/s); bounds "
          f"{ {k: round(v[0], 5) for k, v in bounds.items()} } | {CARD}",
          flush=True)

    kernels = [
        kernel_row("actor_rollout", "actor_rollout.cu",
                   "pingpong_tpu/ops/actor_rollout.py:658",
                   qnet_launches["actor_rollout"], actor_err, a_ms, a_plain,
                   bounds["actor_rollout"]),
        kernel_row("dqn_update", "dqn_update.cu",
                   "pingpong_tpu/ops/dqn_update.py:599",
                   qnet_launches["dqn_update"], upd_err, u_ms, u_plain,
                   bounds["dqn_update"]),
        kernel_row("recurrent_rollout", "recurrent_rollout.cu",
                   "pingpong_tpu/ops/recurrent_rollout.py:652",
                   rnn_launches["recurrent_rollout"], rnn_err, r_ms, r_plain,
                   bounds["recurrent_rollout"]),
        kernel_row("drqn_update", "drqn_update.cu",
                   "pingpong_tpu/ops/drqn_update.py:609",
                   rnn_launches["drqn_update"], drqn_err, d_ms, d_plain,
                   bounds["drqn_update"]),
        kernel_row("pong_kernel", "pong_kernel.cu",
                   "pingpong_tpu/ops/pong_kernel.py:216",
                   bench_launches["pong_kernel"], pong_err, p_ms, p_plain,
                   bounds["pong_kernel"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"[done] smoke took {time.time() - t_start:.0f} s")
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
