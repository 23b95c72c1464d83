"""Headline bench of the PyTorch port: env-steps/s on one card.

    python -m pingpong_tpu_torch.bench [--device cuda|cpu]
    python -m pingpong_tpu_torch.cli bench [--device cuda|cpu]

The counterpart of the JAX package's ``bench.py``, at its shapes and with
its semantics:

* ``bench_env_steps``: the env-only rollout of eager PyTorch ops (the JAX
  package's XLA scan), both seats played by the ball-follower bot, with
  auto-reset, 32768 envs x 1024-step chunks;
* ``bench_fused_rollout``: the same work in one launch of the env-only
  kernel (``ops/pong_kernel.py``), seed ``i + 1`` for the i-th call;
* ``bench_train_iteration(pool_n)``: a DQN train iteration, 8192 envs x
  128 steps and 64 updates of 256 from a 2^20 replay, against A alone
  (``pool_n`` 0) or a heads-only pool of 16 sharing A's trunk;
* ``bench_drqn_iteration``: a DRQN train iteration, 4096 envs x 128 steps
  and 32 updates of 64 traces, ring of 2048 steps.

Each number is the floor-difference slope of windows of ``n1`` and ``n2``
calls, every window ending in a device synchronize. Each goes to stderr
beside the card's name and power limit (the iteration benches also give
how many updates the timed windows ran); stdout gets one JSON line, the
larger env-only rate, with the device it ran on. No band is checked and no
TPU figure is a baseline. Runs on the card unless ``--device cpu`` asks for
the plain versions; a failed measurement exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Tuple

import torch

from pingpong_tpu_torch.config import DQNConfig, DRQNConfig, EnvConfig
from pingpong_tpu_torch.env.pong import (
    env_params_from_config,
    observe,
    reset,
    step_autoreset_batch,
)
from pingpong_tpu_torch.models.policy import ball_follower_action
from pingpong_tpu_torch.models.qnet import QNet, qnet_init
from pingpong_tpu_torch.ops.pong_kernel import pong_rollout
from pingpong_tpu_torch.train.dqn import DQNLearner, stack_opponents
from pingpong_tpu_torch.train.drqn import DRQNLearner, stack_rnn_opponents
from pingpong_tpu_torch.utils.device import resolve_device

BATCH = 32768
CHUNK = 1024        # env steps per rollout call
REPEATS = 5
ROLLOUT_WINDOWS = (5, 5 + 5 * REPEATS)
ITERATION_WINDOWS = (10, 50)
TRIALS = 4


class Rate(NamedTuple):
    steps_per_s: float
    updates_run: int = 0     # updates run by the timed iterations
    iterations: int = 0      # timed iterations


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def slope_time(run_n: Callable[[int], float], n1: int, n2: int,
               trials: int) -> float:
    """Seconds per call: ``(min t(n2) - min t(n1)) / (n2 - n1)`` over
    ``trials`` pairs of windows. Each window's minimum is a floor of its
    own distribution (run time plus non-negative noise), so the difference
    cancels the fixed cost of a window without admitting a hiccup from
    either side."""
    t1s, t2s = [], []
    for _ in range(trials):
        t1s.append(run_n(n1))
        t2s.append(run_n(n2))
    return (min(t2s) - min(t1s)) / (n2 - n1)


def rollout_env_cfg(max_episode_steps: int = 0) -> EnvConfig:
    return EnvConfig(
        paddle_speed=0.03, magnus_factor=0.025, restitution=1.0, friction=0.6,
        ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
        speed_scale_every=1, speed_increment=0.1,
        max_episode_steps=max_episode_steps)


def _bench_env_cfg() -> EnvConfig:
    """The iteration benches' env (``bench.py::_bench_env_cfg``)."""
    return rollout_env_cfg(max_episode_steps=4096)


def env_only_chunk(params, state, generator, steps: int):
    """``steps`` eager env steps: both observations, both bots, one
    batched step with auto-reset. Returns ``(state, reward_b sum)``."""
    rsum = torch.zeros((), device=state.ball_x.device)
    for _ in range(steps):
        obs_a, obs_b = observe(state)
        state, out = step_autoreset_batch(params, state, generator,
                                          ball_follower_action(obs_a),
                                          ball_follower_action(obs_b))
        rsum = rsum + out.reward_b.sum()
    return state, rsum


def bench_env_steps(device="cuda", batch: int = BATCH, chunk: int = CHUNK,
                    windows: Tuple[int, int] = ROLLOUT_WINDOWS,
                    trials: int = TRIALS) -> Rate:
    """Env-only rollout of eager ops (:func:`env_only_chunk`), serves from
    a generator on the device."""
    dev = resolve_device(device)
    params = env_params_from_config(rollout_env_cfg())
    state = reset(params, batch, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator(dev).manual_seed(0)
    state, _ = env_only_chunk(params, state, gen, chunk)    # warm-up
    _sync(dev)

    def run_n(n):
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = env_only_chunk(params, state, gen, chunk)
        _sync(dev)
        return time.perf_counter() - t0

    return Rate(batch * chunk / slope_time(run_n, *windows, trials))


def bench_fused_rollout(device="cuda", batch: int = BATCH,
                        chunk: int = CHUNK,
                        windows: Tuple[int, int] = ROLLOUT_WINDOWS,
                        trials: int = TRIALS) -> Rate:
    """The env-only kernel: one launch per chunk, seed ``i + 1`` for the
    i-th call of a window."""
    dev = resolve_device(device)
    params = env_params_from_config(rollout_env_cfg())
    tile = min(64, batch // 128)
    state = reset(params, batch, torch.Generator().manual_seed(0), dev)
    state, _ = pong_rollout(params, state, chunk, 0, tile_rows=tile)
    _sync(dev)

    def run_n(n):
        nonlocal state
        t0 = time.perf_counter()
        for i in range(n):
            state, _ = pong_rollout(params, state, chunk, i + 1,
                                    tile_rows=tile)
        _sync(dev)
        return time.perf_counter() - t0

    return Rate(batch * chunk / slope_time(run_n, *windows, trials))


def _time_iterations(learner, state, opp, pool_size, windows, trials,
                     dev) -> Rate:
    """Floor-difference slope of train iterations, counting the updates
    the timed windows ran."""
    learner.train_iteration(state, opp, pool_size)    # warm-up
    _sync(dev)
    ran = {"updates": 0, "iterations": 0}

    def run_n(n):
        t0 = time.perf_counter()
        for _ in range(n):
            _, m = learner.train_iteration(state, opp, pool_size)
            ran["updates"] += m.updates_run
        _sync(dev)
        ran["iterations"] += n
        return time.perf_counter() - t0

    c = learner.cfg
    sec = slope_time(run_n, *windows, trials)
    return Rate(c.num_envs * c.rollout_length / sec, ran["updates"],
                ran["iterations"])


def heads_only_pool(base: QNet, pool_n: int) -> list:
    """``pool_n`` members that share ``base``'s feature trunk and differ in
    the dueling heads (a heads-only lineage, as the reference freezes the
    trunk), which engages the rollout kernel's shared-trunk path."""
    pool = []
    for i in range(pool_n):
        heads = qnet_init(torch.Generator().manual_seed(10 + i))
        pool.append(QNet(base.feat1, base.feat2, heads.fc_v, heads.fc_a))
    return pool


def dqn_setup(pool_n: int = 0, device="cuda", num_envs: int = 8192,
              rollout_length: int = 128, updates: int = 64,
              batch_size: int = 256, memory_size: int = 1 << 20):
    """The DQN bench's learner, state and exactly sized opponent stack (A
    alone, or A and a heads-only pool of ``pool_n``), packed once as the
    loop does. Returns ``(learner, state, opponents, pool_size)``."""
    cfg = DQNConfig(num_envs=num_envs, rollout_length=rollout_length,
                    updates_per_iteration=updates, batch_size=batch_size,
                    memory_size=memory_size)
    learner = DQNLearner(_bench_env_cfg(), cfg, device=device)
    base = qnet_init(torch.Generator().manual_seed(1))
    stack, n = stack_opponents(base, heads_only_pool(base, pool_n), pool_n)
    return learner, learner.init_state(0), learner.prepare_opponents(stack), n


def bench_train_iteration(pool_n: int = 0, device="cuda",
                          windows: Tuple[int, int] = ITERATION_WINDOWS,
                          trials: int = TRIALS, **shape) -> Rate:
    """A DQN train iteration (``shape``: the keywords of
    :func:`dqn_setup`)."""
    dev = resolve_device(device)
    return _time_iterations(*dqn_setup(pool_n, dev, **shape), windows,
                            trials, dev)


def drqn_setup(device="cuda", num_envs: int = 4096,
               rollout_length: int = 128, updates: int = 32,
               batch_size: int = 64, ring_len: int = 2048):
    """The DRQN bench's learner, state and opponent stack (A alone), at
    the shipped architecture's widths. Returns ``(learner, state,
    opponents, pool_size)``."""
    cfg = DRQNConfig(num_envs=num_envs, rollout_length=rollout_length,
                     updates_per_iteration=updates, batch_size=batch_size,
                     ring_len=ring_len)
    learner = DRQNLearner(_bench_env_cfg(), cfg, device=device)
    params = learner.init_params(torch.Generator().manual_seed(0))
    stack, n = stack_rnn_opponents(params, [])
    return (learner, learner.init_state(1, params),
            learner.prepare_opponents(stack), n)


def bench_drqn_iteration(device="cuda",
                         windows: Tuple[int, int] = ITERATION_WINDOWS,
                         trials: int = TRIALS, **shape) -> Rate:
    """A DRQN train iteration (``shape``: the keywords of
    :func:`drqn_setup`)."""
    dev = resolve_device(device)
    return _time_iterations(*drqn_setup(dev, **shape), windows, trials, dev)


def card_name(dev: torch.device) -> str:
    """``name, power limit`` of the card as nvidia-smi gives them, or the
    CPU marker."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[dev.index or 0]


def run(device="cuda", rollout_windows=ROLLOUT_WINDOWS,
        iteration_windows=ITERATION_WINDOWS, trials: int = TRIALS) -> dict:
    """All four measurements (five numbers) at the JAX bench's shapes;
    fewer windows or trials make a quicker, noisier reading."""
    dev = resolve_device(device)
    card = card_name(dev)
    rw = dict(windows=tuple(rollout_windows), trials=trials)
    iw = dict(windows=tuple(iteration_windows), trials=trials)

    def report(what, rate: Rate):
        extra = (f" (updates_run {rate.updates_run} over {rate.iterations} "
                 f"timed iterations)" if rate.iterations else "")
        print(f"[bench] {what} env-steps/s: {rate.steps_per_s:,.0f}{extra}"
              f" | {card}", file=sys.stderr, flush=True)
        return rate

    rates = {
        "env_rollout": report("eager env-only rollout",
                              bench_env_steps(dev, **rw)),
        "fused_rollout": report("fused env-only rollout kernel",
                                bench_fused_rollout(dev, **rw)),
        "dqn_train": report("DQN train-iteration",
                            bench_train_iteration(0, dev, **iw)),
        "dqn_train_pool16": report("DQN train-iteration (pool=16)",
                                   bench_train_iteration(16, dev, **iw)),
        "drqn_train": report("DRQN train-iteration",
                             bench_drqn_iteration(dev, **iw)),
    }
    best = max(rates["env_rollout"].steps_per_s,
               rates["fused_rollout"].steps_per_s)
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    print(json.dumps({"metric": "env_steps_per_s", "value": round(best),
                      "unit": "steps/s", "device": device_name}), flush=True)
    return rates


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    parser.add_argument("--rollout-windows", type=int, nargs=2,
                        default=ROLLOUT_WINDOWS, metavar=("N1", "N2"),
                        help="calls in the short and long timing windows "
                        "of the rollout benches (default %(default)s)")
    parser.add_argument("--iteration-windows", type=int, nargs=2,
                        default=ITERATION_WINDOWS, metavar=("N1", "N2"),
                        help="the same for the train-iteration benches "
                        "(default %(default)s)")
    parser.add_argument("--trials", type=int, default=TRIALS,
                        help="pairs of windows per number "
                        "(default %(default)s)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pingpong_tpu_torch.bench")
    add_arguments(parser)
    args = parser.parse_args(argv)
    run(args.device, args.rollout_windows, args.iteration_windows,
        args.trials)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
