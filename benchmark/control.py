"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, for one cell on many seeds in one process.

    python3 benchmark/control.py --workload qnet.ladder --seeds 11 12 13 \
        --modes sound tf32 half token

For every seed the port's loop is driven through set-up (its first
iterations and its first gate) as a benchmark run drives it, with no
measured window, and the numbers a run compares are read:

* ``sound``: the program against the plain reference (what a run does);
* ``tf32``: the control, the reference computed with TF32 products (the
  precision below the configuration's float32) put in the program's place;
* ``half``, ``token``, ``unchanged``: the program with a fault planted
  where the timed path produces it (``PLANTS``): each update block on the
  first half of its batch, the mean taken over it; one action of the
  rollout's transitions altered where it is emitted; the update block
  leaving the parameters unchanged.

Prints one JSON line a seed and mode. The benchmark's own runs never run
this; ``benchmark/tests/test_bench_faults.py`` runs the plants at a small
size and sees ``correct`` come out false.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _half_dqn(original):
    """Kernel 2's block on the first half of each batch."""
    def run(**kw):
        bs = kw["bs"] // 2
        return original(**{**kw, "bs": bs,
                           "u01": kw["u01"][:, :bs].contiguous()})
    return run


def _half_drqn(original):
    """Kernel 4's block on the first half of each batch."""
    def run(**kw):
        bs = kw["obs"].shape[1] // 2
        return original(**{**kw, **{
            k: kw[k][:, :bs].contiguous()
            for k in ("obs", "next_obs", "action", "reward", "done",
                      "valid")}})
    return run


def _unchanged_update(original):
    """The update block run on copies: the state keeps its parameters."""
    def run(**kw):
        kw = {k: (v.clone() if k in ("params", "target", "m", "v") else v)
              for k, v in kw.items()}
        return original(**kw)
    return run


def _token_rollout(original):
    """One action of the emitted transitions altered (env 0, step 0)."""
    def run(*args, **kw):
        out = list(original(*args, **kw))
        for x in out:
            if isinstance(x, dict) and "action" in x:
                x["action"][0, 0] = (x["action"][0, 0] + 1) % 3
        return tuple(out)
    return run


PLANTS = {
    "qnet": {"half": ("pingpong_tpu_torch.train.dqn", "dqn_update_block",
                      _half_dqn),
             "unchanged": ("pingpong_tpu_torch.train.dqn", "dqn_update_block",
                           _unchanged_update),
             "token": ("pingpong_tpu_torch.train.dqn", "actor_rollout",
                       _token_rollout)},
    "drqn": {"half": ("pingpong_tpu_torch.train.drqn", "drqn_update_block",
                      _half_drqn),
             "unchanged": ("pingpong_tpu_torch.train.drqn",
                           "drqn_update_block", _unchanged_update),
             "token": ("pingpong_tpu_torch.train.drqn", "recurrent_rollout",
                       _token_rollout)},
}


@contextlib.contextmanager
def planted(family: str, mode: str):
    """The program with the fault ``mode`` planted (nothing for ``sound``
    and ``tf32``)."""
    if mode not in PLANTS[family]:
        yield
        return
    mod_name, attr, make = PLANTS[family][mode]
    module = importlib.import_module(mod_name)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def readings(workload: str, seed: int, modes, device="cuda",
             overrides=None):
    """The numbers compared for one seed, one dict a mode: the program
    sound (``sound``) and the control (``tf32``) from one drive of the
    sound program, each fault from a drive with it planted."""
    from benchmark import harness

    run = harness.load_cell(workload, overrides=overrides)
    family = run["config"]["reference"]
    drives = {}
    for mode in modes:
        key = mode if mode in PLANTS[family] else "sound"
        if key not in drives:
            with planted(family, key):
                drives[key] = harness.drive(run, seed, 0.0, False, T_PROC0,
                                            device)[0]
        values = harness.reference_checks(
            run, seed, drives[key], device,
            "tf32" if mode == "tf32" else "f32")
        correct, _, _ = harness.judge(values, run["limits"])
        yield dict(workload=workload, seed=seed, mode=mode, correct=correct,
                   values=values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["sound", "tf32"])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("error: the readings are taken on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for line in readings(args.workload, seed, args.modes):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
