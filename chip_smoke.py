"""Chip smoke test of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py

1. builds both CUDA kernels from ``pingpong_tpu_torch/csrc`` (one ``nvcc``
   per source, started together) and prints ptxas' register/smem lines;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with the stated tolerances;
3. drives the main path, ``cli train`` at ``configs/qnet.yaml``'s widths and
   batch, twice in one workdir (the second run loads the first run's
   checkpoint into the pool), with the kernels' launch counters reset just
   before and read just after;
4. times each kernel (CUDA events, warm) beside its plain version, and a
   train iteration end to end, and profiles where an iteration's device
   time goes (``torch.profiler``);
5. prints the ``kernels`` JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA card
it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12        # H100 SXM float32 (non-tensor-core) FLOP/s
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
# set in main() from the card and configs/qnet.yaml
CARD = ENV_PARAMS = TILE = MAX_EP_STEPS = None


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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

def profile_iterations(learner, state, opp, n):
    """Where a train iteration's time goes: ``torch.profiler`` over ``n``
    warm iterations; device time per kernel or op and the device's busy
    share of the wall time (kernels may overlap, so it can exceed 1)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            learner.train_iteration(state, opp, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    dev_ms = sum(ms for ms, _ in rows)
    check(dev_ms > 0, "profiler recorded no device time")
    print(f"[profile] per iteration (profiled): wall {wall_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f} | "
          f"{CARD}")
    for ms, key in rows[:8]:
        print(f"[profile]   {ms:9.4f} ms  {key[:90]}")

def train_args(workdir):
    return ["train", "--config", str(ROOT / "configs" / "qnet.yaml"),
            "--workdir", str(workdir),
            "dqn.selfplay.max_generations=1",
            "dqn.selfplay.episodes_per_generation=1",
            "dqn.selfplay.eval_episodes=2000",
            "dqn.selfplay.curr_win_threshold=0.0",
            "dqn.selfplay.pool_win_threshold=0.0",
            "dqn.save_latest_checkpoint_interval_steps=0"]


def main() -> int:
    global CARD, ENV_PARAMS, TILE, MAX_EP_STEPS
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pingpong_tpu_torch import cli
    from pingpong_tpu_torch.checkpoint.store import list_checkpoints
    from pingpong_tpu_torch.config import load_config
    from pingpong_tpu_torch.env.pong import env_params_from_config
    from pingpong_tpu_torch.models.policy import qnet_act_greedy
    from pingpong_tpu_torch.ops import actor_rollout as ar
    from pingpong_tpu_torch.ops import dqn_update as du
    from pingpong_tpu_torch.ops.build import build_all
    from pingpong_tpu_torch.selfplay.pool import load_params_any, load_pool
    from pingpong_tpu_torch.train.dqn import DQNLearner

    t_start = time.time()
    CARD = card()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(ROOT / "configs" / "qnet.yaml")
    ENV_PARAMS = env_params_from_config(cfg.env)
    B, T = cfg.dqn.num_envs, cfg.dqn.rollout_length
    TILE = min(cfg.dqn.pallas_tile_rows, B)
    MAX_EP_STEPS = cfg.env.max_episode_steps

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    logs = build_all([ar.KERNEL, du.KERNEL])
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build:{name}] {line.strip()}")
    print(f"[build] both kernels built for sm_90a in {time.time() - t0:.1f} s",
          flush=True)

    # ---- 2. kernel vs plain ------------------------------------------------
    actor_err = 0.0
    for i, (name, n_slots, shared, eval_mode) in enumerate([
            ("empty_pool", 1, False, False),
            ("3slot_shared_trunk", 3, True, False),
            ("3slot_full", 3, False, False),
            ("eval", 1, False, True)]):
        inp = actor_inputs(100 + i, n_slots, shared, eval_mode, B, dev)
        actor_err = max(actor_err, compare_actor(name, inp))
    upd_err = 0.0
    upd_inp = update_inputs(7, dev)
    for name, heads_only, tau, interval in [
            ("heads_only_hard_sync", True, 0.0, 16),
            ("full_backward", False, 0.0, 10_000),
            ("polyak", True, 0.005, 10_000)]:
        err, idx = compare_update(name, upd_inp, heads_only, tau, interval)
        upd_err = max(upd_err, err)
        if name == "heads_only_hard_sync":
            upd_idx = idx

    # ---- 3. main path: cli train, twice in one workdir ---------------------
    workdir = ROOT / "build" / "chip_smoke_run"
    shutil.rmtree(workdir, ignore_errors=True)
    ar.KERNEL.launches = 0
    du.KERNEL.launches = 0
    t0 = time.time()
    rc1 = cli.main(train_args(workdir))
    pool = load_pool(workdir / "checkpoints")
    rc2 = cli.main(train_args(workdir))
    torch.cuda.synchronize()
    launches = {"actor_rollout": ar.KERNEL.launches,
                "dqn_update": du.KERNEL.launches}
    t_main = time.time() - t0
    ckpts = [p.name for p in list_checkpoints(workdir / "checkpoints")]
    print(f"[main] cli train x2 rc={rc1},{rc2} in {t_main:.1f} s; pool for "
          f"run 2: {len(pool)} member(s); checkpoints {ckpts}; launches "
          f"{launches} | {CARD}", flush=True)
    check(rc1 == 0 and rc2 == 0, "cli train failed")
    check(len(pool) == 1, "run 2 did not load run 1's checkpoint as pool")
    check("model5-1" in ckpts, "no promoted model5-1 checkpoint")
    check(launches["actor_rollout"] > 0, "actor kernel never launched")
    check(launches["dqn_update"] > 0, "update kernel never launched")
    promoted = load_params_any(workdir / "checkpoints" / "model5-1")
    acts = qnet_act_greedy(promoted, torch.rand((1024, 7)))
    check(bool(((acts >= 0) & (acts <= 2)).all())
          and all(bool(torch.isfinite(p).all())
                  for p in promoted.parameters()),
          "promoted checkpoint is not a finite QNet")

    # ---- 4. timings -------------------------------------------------------
    learner = DQNLearner(cfg.env, cfg.dqn, device="cuda")
    state = learner.init_state(3)
    opp = learner.prepare_opponents([learner.params_b(state), promoted])
    for _ in range(2):
        learner.train_iteration(state, opp, 1)
    torch.cuda.synchronize()
    n_it = 5
    t0 = time.perf_counter()
    for _ in range(n_it):
        _, metrics = learner.train_iteration(state, opp, 1)
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t0) / n_it * 1e3
    check(metrics.updates_run > 0 and metrics.mean_loss == metrics.mean_loss,
          "timed iterations ran no finite update")
    print(f"[main] train iteration {it_ms:.3f} ms, "
          f"{B * T / it_ms * 1e3:.4g} env-steps/s (num_envs {B}, rollout "
          f"{T}, {cfg.dqn.updates_per_iteration} updates of "
          f"{cfg.dqn.batch_size}) | {CARD}", flush=True)
    profile_iterations(learner, state, opp, 3)

    inp = actor_inputs(200, 2, True, False, B, dev)
    a_ms = cuda_ms(lambda: run_actor(ar.actor_rollout_cuda, inp, T), 20)
    a_plain = cuda_ms(lambda: run_actor(ar.actor_rollout_plain, inp, T), 3, 1)
    a_bound, a_by = actor_bound_ms(B, T, 2)
    ukw = update_kwargs(upd_inp, True, 0.0, 1000)
    u_ms = cuda_ms(lambda: du.dqn_update_cuda(**ukw), 10)
    u_plain = cuda_ms(lambda: du.dqn_update_plain(**ukw), 2, 1)
    u_bound, u_by = update_bound_ms(256, 64, (1 << 20) // 128, True, upd_idx)
    print(f"[time] actor_rollout {a_ms:.4f} ms (plain {a_plain:.2f} ms, bound "
          f"{a_bound:.4f} ms by {a_by}); dqn_update {u_ms:.4f} ms (plain "
          f"{u_plain:.2f} ms, bound {u_bound:.4f} ms by {u_by}) | {CARD}",
          flush=True)

    kernels = [
        {"name": "actor_rollout", "route": "cuda",
         "source": "pingpong_tpu_torch/csrc/actor_rollout.cu",
         "replaces": "pingpong_tpu/ops/actor_rollout.py:658",
         "launches": launches["actor_rollout"], "max_abs_err": actor_err,
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None, "compare": "pass"},
        {"name": "dqn_update", "route": "cuda",
         "source": "pingpong_tpu_torch/csrc/dqn_update.cu",
         "replaces": "pingpong_tpu/ops/dqn_update.py:599",
         "launches": launches["dqn_update"], "max_abs_err": upd_err,
         "ms": u_ms, "plain_ms": u_plain, "bound_ms": u_bound,
         "bound_by": u_by, "library_ms": None, "compare": "pass"},
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
