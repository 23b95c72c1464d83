"""DQN roofline of the port: the headline DQN train iteration split into
its stages, beside kernel 2's FLOP and byte accounting at the card's rates.

    python -m pingpong_tpu_torch.tools.dqn_roofline_bench [--device cuda]

Counterpart of ``pingpong_tpu/tools/dqn_roofline_bench.py`` at its shapes
(8192 envs x 128 steps, 64 updates of 256 from a 2^20 replay, the bench
env, A alone). Times with ``bench.slope_time`` (floor-difference slope,
every window ended by a synchronize):

* the full train iteration;
* the update block alone: ``DQNLearner._update_kernel`` (kernel 2 and the
  last-writer-wins priority replay) on pre-drawn uniforms and noise;
* the rollout with its PER push: ``DQNLearner._rollout`` (kernel 1);
* glue = full - update - rollout (the host draws, launches and syncs).

The accounting is the port's kernel 2 (``update_accounting``): the
operations of its forwards, backward, sampler and Adam, and the bytes it
must move, counting the replay chunks and slots this run's samples touch,
over the H100's float32 rate without tensor cores (67 TFLOP/s) and its
HBM rate (3.35 TB/s). ``chip_smoke.py`` takes kernel 2's bound from here.
The numbers go to stderr with the card's name and power limit, one JSON
line to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Tuple

import torch

from pingpong_tpu_torch import bench
from pingpong_tpu_torch.utils.device import resolve_device

F32_PEAK = 67e12        # H100 SXM float32 (non-tensor-core) FLOP/s
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
PARAMS = 5192           # floats of the QNet's raveled parameter vector
NOISE = 260             # floats of one update's head noise


def update_accounting(bs: int, K: int, nc: int, heads_only: bool,
                      idx: torch.Tensor) -> dict:
    """Kernel 2's work for K updates of ``bs`` from ``nc`` replay chunks of
    128: float operations (three forwards of a sample, the heads' backward,
    the full backward unless ``heads_only``, the two-level sampler, Adam)
    and bytes (uniforms, noise, parameters and moments in and out, the
    chunk sums, each touched chunk's priorities and each touched slot's
    fields, the emitted priorities and indices, the losses). ``idx (K,
    bs)`` are the sampled slots, which set the touched chunks and slots.
    Returns ``flops``, ``bytes``, ``bound_ms`` (the larger of the two
    times) and ``bound_by``."""
    fwd = 2 * (7 * 64 + 64 * 64) + 2 * 4 * 64
    flops = 3 * bs * fwd + 2 * bs * 4 * 64 + nc + bs * 128
    if not heads_only:
        flops += bs * 2 * (4 * 64 + 2 * 64 * 64 + 7 * 64)
    flops = (flops + 12 * PARAMS) * K
    chunks = int(torch.unique(idx.long() // 128).numel())
    slots = int(torch.unique(idx.long()).numel())
    nbytes = (4 * K * bs + 4 * K * NOISE + 8 * 4 * PARAMS + 4 * nc
              + 512 * chunks + 64 * slots + 4 * slots + 4 * chunks
              + 8 * K * bs + 4 * K)
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return dict(flops=flops, bytes=nbytes,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def update_bound_ms(bs, K, nc, heads_only, idx) -> Tuple[float, str]:
    """Kernel 2's bound: ``(ms, "operations" or "bytes")``."""
    a = update_accounting(bs, K, nc, heads_only, idx)
    return a["bound_ms"], a["bound_by"]


def measure(device="cuda", num_envs: int = 8192, rollout_length: int = 128,
            updates: int = 64, batch_size: int = 256,
            memory_size: int = 1 << 20, windows: Tuple[int, int] = (10, 50),
            trials: int = 5, warm: int = 4) -> dict:
    """The three stage times and glue (seconds) and the accounting of the
    update block, after ``warm`` iterations that fill the replay."""
    dev = resolve_device(device)
    learner, state, opp, n = bench.dqn_setup(
        0, dev, num_envs=num_envs, rollout_length=rollout_length,
        updates=updates, batch_size=batch_size, memory_size=memory_size)
    if learner.route.update != "kernel":
        raise ValueError("the shapes are not kernel 2's "
                         "(ops/dqn_update.py::supports_fused_update)")
    for _ in range(warm):
        learner.train_iteration(state, opp, n)

    def timed(step):
        def run_n(k):
            bench._sync(dev)
            t0 = time.perf_counter()
            for _ in range(k):
                step()
            bench._sync(dev)
            return time.perf_counter() - t0
        step()                                           # warm
        return bench.slope_time(run_n, *windows, trials)

    t_full = timed(lambda: learner.train_iteration(state, opp, n))
    gen = torch.Generator().manual_seed(1)
    u01 = torch.rand((updates, batch_size), generator=gen).to(dev)
    noise = torch.randn((updates, NOISE), generator=gen).to(dev)
    sampled = {}

    def update():
        sampled["idx"] = learner._update_kernel(state, u01, noise)[1]

    t_upd = timed(update)
    t_roll = timed(lambda: learner._rollout(state, opp, n))
    acc = update_accounting(batch_size, updates, memory_size // 128,
                            learner.cfg.train_heads_only, sampled["idx"])
    return dict(full_s=t_full, update_s=t_upd, rollout_s=t_roll,
                glue_s=t_full - t_upd - t_roll,
                env_steps=num_envs * rollout_length, updates=updates, **acc)


def report(r: dict, card: str) -> dict:
    """Print the stage lines and the accounting to stderr; returns the
    JSON summary (milliseconds and rates)."""
    ms = {k: r[f"{k}_s"] * 1e3 for k in ("full", "update", "rollout",
                                         "glue")}
    out = lambda s: print(f"[roofline] {s} | {card}", file=sys.stderr,
                          flush=True)
    out(f"full iteration: {ms['full']:.4f} ms "
        f"({r['env_steps'] / r['full_s']:.4e} env-steps/s)")
    out(f"update block ({r['updates']} updates, kernel 2): "
        f"{ms['update']:.4f} ms ({r['update_s'] / r['updates'] * 1e6:.2f} "
        "us/update)")
    out(f"rollout (+PER push, kernel 1): {ms['rollout']:.4f} ms")
    out(f"glue (full - update - rollout): {ms['glue']:.4f} ms")
    flop_rate = r["flops"] / r["update_s"]
    byte_rate = r["bytes"] / r["update_s"]
    out(f"kernel 2 accounting: {r['flops'] / 1e9:.4f} GFLOP, "
        f"{r['bytes'] / 1e6:.4f} MB a block; bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")
    out(f"update block at {flop_rate / 1e12:.4f} TFLOP/s "
        f"({100 * flop_rate / F32_PEAK:.3f}% of the f32 rate, 67 TFLOP/s) "
        f"and {byte_rate / 1e9:.3f} GB/s ({100 * byte_rate / HBM_RATE:.3f}% "
        "of the HBM rate, 3.35 TB/s)")
    return dict(**{f"{k}_ms": v for k, v in ms.items()},
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                flops=r["flops"], bytes=r["bytes"],
                pct_f32=100 * flop_rate / F32_PEAK,
                pct_hbm=100 * byte_rate / HBM_RATE, card=card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--windows", type=int, nargs=2, default=(10, 50),
                    metavar=("N1", "N2"), help="calls in the short and long "
                    "timing windows (default %(default)s)")
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    r = measure(dev, windows=tuple(args.windows), trials=args.trials)
    print(json.dumps(report(r, bench.card_name(dev))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
