"""The readings that ``benchmark/limits/rainbow.ladder.json`` is set from:
``benchmark/control.py`` for the ``rainbow`` configuration, whose plants
that script's ``PLANTS`` does not hold.

    python3 rainbow_control.py --seeds 11 12 13 --modes sound tf32 \
        tf32_update half unchanged token

For every seed the port's Rainbow loop is driven through set-up (its first
iterations and its first gate) as a benchmark run drives it, with no
measured window, and the numbers a run compares are read:

* ``sound``: the program against the plain reference (what a run does);
* ``tf32``: the control, the reference computed with TF32 products put in
  the program's place;
* ``tf32_update``: the control with TF32 products in the update block
  alone (the rollout and the gate in float32), which the update's own
  numbers must catch;
* ``half``: each update block on the first half of its batch;
* ``unchanged``: each update block leaving the parameters, the target and
  the Adam moments as they were;
* ``token``: one action of the rollout's transitions altered (env 0,
  step 0) before the n-step fold.

One JSON line a seed and mode. Needs a card, unless ``--device cpu`` (with
``--tiny``, the test sizes of ``benchmark/tests/test_bench_rainbow.py``).
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CELL = "rainbow.ladder"
MODULE = "pingpong_tpu_torch.train.rainbow"


def _half(original):
    def run(learner, state, *, u01, noise, bs):
        h = bs // 2
        return original(learner, state, u01=u01[:, :h].contiguous(),
                        noise=noise, bs=h)
    return run


def _unchanged(original):
    def run(learner, state, **kw):
        keep = {k: getattr(state, k).clone()
                for k in ("params", "target", "opt_mu", "opt_nu")}
        out = original(learner, state, **kw)
        for k, v in keep.items():
            setattr(state, k, v)
        return out
    return run


def _token(original):
    def run(*args, **kw):
        tally, tr = original(*args, **kw)
        tr["action"][0, 0] = (tr["action"][0, 0] + 1) % 3
        return tally, tr
    return run


PLANTS = {"half": ("rainbow_update_block", _half),
          "unchanged": ("rainbow_update_block", _unchanged),
          "token": ("rainbow_rollout", _token)}


@contextlib.contextmanager
def planted(mode: str):
    """The program with the fault ``mode`` planted (nothing for ``sound``
    and ``tf32``)."""
    if mode not in PLANTS:
        yield
        return
    import importlib

    module = importlib.import_module(MODULE)
    attr, make = PLANTS[mode]
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def readings(seed: int, modes, device="cuda", overrides=None):
    """The numbers compared for one seed, one dict a mode (``sound`` and
    the controls from one drive of the sound program)."""
    from benchmark import harness

    run = harness.load_cell(CELL, root=ROOT, overrides=overrides)
    drives = {}
    for mode in modes:
        key = mode if mode in PLANTS else "sound"
        if key not in drives:
            with planted(key):
                drives[key] = harness.drive(run, seed, 0.0, False, T_PROC0,
                                            device)[0]
        values = harness.reference_checks(
            run, seed, drives[key], device,
            mode if mode in ("tf32", "tf32_update") else "f32")
        correct, _, _ = harness.judge(values, run["limits"])
        yield dict(workload=CELL, seed=seed, mode=mode, correct=correct,
                   values=values)


TINY = {"dqn.num_envs": 16, "dqn.rollout_length": 8, "dqn.batch_size": 32,
        "dqn.memory_size": 4096, "dqn.updates_per_iteration": 4,
        "dqn.stream_hidden": 32, "dqn.num_atoms": 11,
        "dqn.selfplay.episodes_per_generation": 8,
        "dqn.selfplay.eval_episodes": 16, "env.max_episode_steps": 256}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["sound", "tf32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("error: the readings are taken on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for line in readings(seed, args.modes, args.device,
                             TINY if args.tiny else None):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
