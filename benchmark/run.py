"""Run one cell of the benchmark of ``pingpong_tpu_torch`` and print its
result line.

    python3 benchmark/run.py --workload qnet.ladder --seed 7 --seconds 20 \
        --trace 0

From the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for. Prints one JSON object as the last line of standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` the per-layer metrics and a ``breakdown``; ``checks`` last:
every number compared with the plain reference beside its limit, which
also close standard error). Exits non-zero, printing no result, without
enough cards, or when a JAX module was loaded. ``benchmark/harness.py``
says what a run does.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Build caches inside the checkout, at fixed paths; one thread for
    PyTorch's CPU operators (the host's cores are shared: more threads
    made the runs of a cell spread two or three times as wide); no JAX
    from any library."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _rank_main(rank: int, world: int, port: int, args, backend: str,
               overrides, queue) -> None:
    """One process a card under torch.distributed (NCCL; gloo and the CPU
    for the tests); rank 0 puts its result on ``queue``."""
    _environment()
    import torch
    from benchmark import harness

    device = "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_PROC0, device=device,
                               overrides=overrides, distributed=True,
                               rank=rank, world=world)
        if rank == 0:
            queue.put((out, harness.forbidden_modules()))
    finally:
        torch.distributed.destroy_process_group()


def launch(args, chips: int, backend: str = "nccl", overrides=None):
    """Run a cell on ``chips`` ranks, one process each; returns rank 0's
    result and the JAX modules any rank 0 process had loaded."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, chips, port, args, backend, overrides,
                               queue))
             for r in range(chips)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=3000)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    return out


def main(argv=None) -> int:
    args = _parse(argv)
    _environment()
    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)["cell"]
    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"error: {args.workload} needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    if chips > 1:
        out, rank_modules = launch(args, chips)
    else:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_PROC0)
        rank_modules = []
    bad = sorted(set(harness.forbidden_modules()) | set(rank_modules))
    if bad:
        print(f"error: JAX modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, row in out["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
