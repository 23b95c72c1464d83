"""The train-loop stall of a full-state autosave on the card (port of
``pingpong_tpu/tools/autosave_stall_bench.py``).

    python -m pingpong_tpu_torch.tools.autosave_stall_bench [--config qnet|rnn]

``--config qnet`` (the default) is the JAX tool's shape: the DQN bench's
state, 8192 envs x 128 steps, 64 updates of 256, PER 2^20 (72 MiB of
replay). ``--config rnn`` is the DRQN state at ``configs/rnn.yaml`` (1024
envs, ring 4096: 176 MiB of replay), timed once its update blocks run.
Three numbers:

1. ``sync_save_s``: wall time of one synchronous full-state save
   (``autosave_full_state``), what an autosave costs without the worker;
2. ``async_call_s``: host-blocking time of ``AsyncAutosaver.save()``
   (the device snapshot and the hand-off), median of 5 calls;
3. ``stall_per_autosave_s``: the median over trials of the extra wall
   time of a window of train iterations that fires one async save on its
   second iteration, against the same window without; the write is joined
   after the window's clock stops, as in the JAX tool. Beside it,
   ``stall_paired_s``: each trial's window with a save less the plain
   window run just before it, whose spread says how far the median is
   resolved from the windows' noise.

Every window ends in a device synchronize. The card's name and power limit
go to stderr and into the JSON line that ends stdout. ``--device cpu``
runs the plain versions (tiny shapes only, through :func:`measure`).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from pingpong_tpu_torch.bench import _sync, card_name, dqn_setup
from pingpong_tpu_torch.checkpoint.full_state import (
    AsyncAutosaver,
    autosave_full_state,
    full_state_tree,
)
from pingpong_tpu_torch.models.qnet import qnet_to_flat
from pingpong_tpu_torch.models.qnet_rnn import qnet_rnn_to_flat
from pingpong_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
ITERS = {"qnet": 60, "rnn": 30}


def rnn_setup(device, config=ROOT / "configs" / "rnn.yaml"):
    """The DRQN learner, state and A-only stack at ``config``."""
    from pingpong_tpu_torch.config import load_config
    from pingpong_tpu_torch.train.drqn import DRQNLearner, stack_rnn_opponents

    cfg = load_config(config)
    learner = DRQNLearner(cfg.env, cfg.drqn, device=device)
    params = learner.init_params(torch.Generator().manual_seed(0))
    stack, n = stack_rnn_opponents(params, [])
    return (learner, learner.init_state(1, params),
            learner.prepare_opponents(stack), n)


def state_bytes(tree) -> int:
    from pingpong_tpu_torch.checkpoint.full_state import flatten_tree

    return sum(v.numel() * v.element_size()
               for v in flatten_tree(tree).values()
               if isinstance(v, torch.Tensor))


def measure(learner, state, opp, pool_size, workdir: Path,
            n_iters: int, trials: int = 12, warm_iters: int = 0) -> dict:
    """The three numbers for this learner and state. ``warm_iters``:
    iterations run first, until an update block has run."""
    dev = learner.device
    net = learner.params_b(state)
    rnn = hasattr(net, "lstm")
    params_a = (qnet_rnn_to_flat if rnn else qnet_to_flat)(net)
    host = torch.Generator().manual_seed(1)
    meta = {"generation": 1, "done_generations": 0,
            "model_kind": "qnet_rnn" if rnn else "qnet"}
    for _ in range(max(warm_iters, 1)):
        state, m = learner.train_iteration(state, opp, pool_size)
        if warm_iters and m.updates_run:
            break
    _sync(dev)

    def tree():
        return full_state_tree(state, params_a, host)

    t0 = time.perf_counter()
    autosave_full_state(workdir / "sync_state", state, params_a, host, meta)
    sync_save_s = time.perf_counter() - t0

    saver = AsyncAutosaver()
    saver.save(workdir / "warm_state", tree(), meta)   # pinned buffers
    saver.wait()
    calls = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        saver.save(workdir / "async_state", tree(), meta)
        calls.append(time.perf_counter() - t0)
        saver.wait()

    updates = 0

    def window(save: bool) -> float:
        nonlocal state, updates
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(n_iters):
            state, m = learner.train_iteration(state, opp, pool_size)
            updates += m.updates_run
            if save and i == 1:
                saver.save(workdir / "bg_state", tree(), meta)
        _sync(dev)
        dt = time.perf_counter() - t0
        saver.wait()
        return dt

    window(False)
    plain, saved = [], []
    for _ in range(trials):
        plain.append(window(False))
        saved.append(window(True))
    saver.close()
    return {
        "sync_save_s": sync_save_s,
        "async_call_s": statistics.median(calls),
        "stall_per_autosave_s": (statistics.median(saved)
                                 - statistics.median(plain)),
        "stall_paired_s": [b - a for a, b in zip(plain, saved)],
        "window_plain_s": plain,
        "window_with_save_s": saved,
        "iterations_per_window": n_iters,
        "updates_in_windows": updates,
        "state_bytes": state_bytes(tree()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("qnet", "rnn"), default="qnet")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=None,
                    help="train iterations a window (qnet 60, rnn 30)")
    ap.add_argument("--trials", type=int, default=12)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    card = card_name(dev)
    if a.config == "qnet":
        setup, shape, warm = dqn_setup(0, dev), (
            "8192x128 envs, 64 updates of 256, PER 2^20 (bench shape)"), 0
    else:
        setup, shape, warm = rnn_setup(dev), "configs/rnn.yaml", 200
    workdir = Path(tempfile.mkdtemp(prefix="autosave_stall_"))
    try:
        out = measure(*setup, workdir, a.iters or ITERS[a.config], a.trials,
                      warm_iters=warm)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    out = {"metric": "autosave_stall", "config": shape, "card": card, **out}
    print(f"[autosave:{a.config}] sync_save_s {out['sync_save_s']:.4f} "
          f"async_call_s {out['async_call_s']:.6f} stall_per_autosave_s "
          f"{out['stall_per_autosave_s']:.6f} | {card}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
