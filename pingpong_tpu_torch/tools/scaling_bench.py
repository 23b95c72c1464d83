"""Weak-scaling bench of the data-parallel train iteration.

    python -m pingpong_tpu_torch.tools.scaling_bench            # every card
    python -m pingpong_tpu_torch.tools.scaling_bench --devices 1,2,4
    torchrun --nproc-per-node 4 -m pingpong_tpu_torch.tools.scaling_bench \\
        --distributed

Counterpart of ``pingpong_tpu/tools/scaling_bench.py``: env-steps/s of
``DQNLearner.train_iteration`` as the number of ranks grows with a FIXED
env batch a rank (weak scaling). A rung of ``n`` ranks starts ``n`` local
processes (one of them for a rung of one), one card each (NCCL), or CPU
processes over gloo with ``--device cpu``. Each reports rank 0's
rate of the whole batch, from the two-window slope of ``--n1`` and
``--n2`` iterations ended by a synchronize. ``--distributed`` measures
the world that torchrun launched, as one rung.

The replay holds one rollout chunk of the whole batch at least (the
smallest power of two, and 65536 at least); the JAX tool's ``64 * envs``
is smaller than its own default chunk of ``128 * envs``. CPU ranks share
the host's cores: a mechanism check, not a measurement of scaling.

Prints one JSON row a rung to stderr and the summary ``{"metric":
"weak_scaling_efficiency", "value", "unit", "ladder"}`` to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

from pingpong_tpu_torch import bench
from pingpong_tpu_torch.config import DQNConfig
from pingpong_tpu_torch.models.qnet import qnet_init
from pingpong_tpu_torch.parallel.mesh import (
    create_mesh,
    free_port,
    initialize_distributed,
    is_coordinator,
)
from pingpong_tpu_torch.train.dqn import DQNLearner, stack_opponents
from pingpong_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]


def bench_config(n: int, per_device_envs: int, rollout_length: int,
                 updates: int, use_pallas: bool,
                 learner_sharding: str) -> DQNConfig:
    """The rung of ``n`` ranks: the batch ``per_device_envs * n``, 256 a
    batch, a replay that holds one chunk."""
    envs = per_device_envs * n
    chunk = envs * rollout_length
    return DQNConfig(
        num_envs=envs, rollout_length=rollout_length,
        updates_per_iteration=updates, batch_size=256,
        memory_size=max(65536, 1 << (chunk - 1).bit_length()),
        use_pallas_rollout=use_pallas, use_pallas_eval=use_pallas,
        use_pallas_update=use_pallas, learner_sharding=learner_sharding)


def rate_here(cfg: DQNConfig, device, n1: int, n2: int) -> float:
    """env-steps/s of the whole batch on this process's rank of the world
    (a mesh over the process group when it has more than one rank)."""
    dev = resolve_device(device)
    mesh = create_mesh() if torch.distributed.is_initialized() else None
    learner = DQNLearner(bench._bench_env_cfg(), cfg, device=dev, mesh=mesh)
    state = learner.init_state(0)
    stack, n = stack_opponents(qnet_init(torch.Generator().manual_seed(1)),
                               [], 0)
    opp = learner.prepare_opponents(stack)
    learner.train_iteration(state, opp, n)              # warm

    def run(k):
        bench._sync(dev)
        t0 = time.perf_counter()
        for _ in range(k):
            learner.train_iteration(state, opp, n)
        bench._sync(dev)
        return time.perf_counter() - t0

    t1, t2 = run(n1), run(n2)
    dt = (t2 - t1) / (n2 - n1)
    if dt <= 0.0:
        # a loaded host can make the two-point slope non-positive; the
        # per-call mean is positive and still sane for a mechanism check
        dt = (t1 + t2) / (n1 + n2)
    return cfg.num_envs * cfg.rollout_length / dt


def measure_rate(n_ranks: int, per_device_envs: int,
                 rollout_length: int = 128, updates: int = 64, n1: int = 5,
                 n2: int = 15, use_pallas: Optional[bool] = None,
                 learner_sharding: str = "auto", device="cuda") -> float:
    """Rank 0's env-steps/s of the full train iteration on ``n_ranks``
    local processes (weak scaling: the batch is ``per_device_envs *
    n_ranks``). The kernels run on the card unless ``use_pallas`` says
    otherwise; on the CPU their plain versions are too slow, so the scan
    rollout and the autodiff update run there."""
    on_card = torch.device(device).type == "cuda"
    shape = dict(n=n_ranks, per_device_envs=per_device_envs,
                 rollout_length=rollout_length, updates=updates,
                 use_pallas=on_card if use_pallas is None else use_pallas,
                 learner_sharding=learner_sharding)
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "rate.json"
        spec = json.dumps(dict(shape=shape, device=str(device), n1=n1, n2=n2,
                               out=str(out)))
        port = free_port()
        procs = []
        for r in range(n_ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n_ranks),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), PYTHONPATH=os.pathsep.join(
                           [str(ROOT), os.environ.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pingpong_tpu_torch.tools.scaling_bench",
                 "--rank-worker", spec], env=env, cwd=str(ROOT)))
        codes = [p.wait() for p in procs]
        if any(codes):
            raise RuntimeError(f"scaling rung of {n_ranks} ranks failed: "
                               f"exit codes {codes}")
        return json.loads(out.read_text())["rate"]


def _rank_worker(spec: str) -> int:
    a = json.loads(spec)
    cpu = torch.device(a["device"]).type == "cpu"
    initialize_distributed(backend="gloo" if cpu else None)
    if cpu:
        torch.set_num_threads(1)
    rate = rate_here(bench_config(**a["shape"]), a["device"], a["n1"],
                     a["n2"])
    if is_coordinator():
        Path(a["out"]).write_text(json.dumps({"rate": rate}))
    torch.distributed.destroy_process_group()
    return 0


def run_ladder(device_counts: List[int], per_device_envs: int,
               **kw) -> List[dict]:
    rows = []
    base = None
    for n in device_counts:
        rate = measure_rate(n, per_device_envs, **kw)
        if base is None:
            base = rate
        eff = rate / (base * n / device_counts[0])
        rows.append({
            "devices": n,
            "global_envs": per_device_envs * n,
            "env_steps_per_s": round(rate),
            "scaling_efficiency": round(eff, 4),
        })
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-device-envs", type=int, default=4096)
    ap.add_argument("--rollout-length", type=int, default=128)
    ap.add_argument("--updates", type=int, default=64,
                    help="SGD updates per iteration")
    ap.add_argument("--learner-sharding", default="auto",
                    choices=("auto", "replicated", "sharded"),
                    help="multi-rank learner layout: auto switches to the "
                         "sharded-PER learner above 16 ranks")
    ap.add_argument("--n1", type=int, default=5)
    ap.add_argument("--n2", type=int, default=15,
                    help="iterations of the second timing window")
    ap.add_argument("--devices", type=str, default=None,
                    help="comma-separated ladder (default: 1,2,4,... up to "
                         "the cards present)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (gloo processes)")
    ap.add_argument("--distributed", action="store_true",
                    help="measure the world torchrun launched (one process "
                         "a card) as one rung")
    ap.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        return _rank_worker(args.rank_worker)
    kw = dict(rollout_length=args.rollout_length, updates=args.updates,
              n1=args.n1, n2=args.n2, learner_sharding=args.learner_sharding,
              device=args.device)
    if args.distributed:
        initialize_distributed(
            backend="gloo" if args.device == "cpu" else None)
        n = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
        cfg = bench_config(n, args.per_device_envs, args.rollout_length,
                           args.updates, args.device != "cpu",
                           args.learner_sharding)
        rate = rate_here(cfg, args.device, args.n1, args.n2)
        rows = [{"devices": n, "global_envs": cfg.num_envs,
                 "env_steps_per_s": round(rate), "scaling_efficiency": 1.0}]
        if not is_coordinator():
            return 0
        print(json.dumps(rows[0]), file=sys.stderr, flush=True)
    else:
        n_vis = (torch.cuda.device_count()
                 if torch.device(args.device).type == "cuda" else 1)
        ladder = ([int(x) for x in args.devices.split(",")] if args.devices
                  else [d for d in (1, 2, 4, 8, 16, 32) if d <= n_vis])
        rows = run_ladder(ladder, args.per_device_envs, **kw)
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": rows[-1]["scaling_efficiency"],
        "unit": "fraction",
        "ladder": rows,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
