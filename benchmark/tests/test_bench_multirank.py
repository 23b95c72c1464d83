"""The multi-card path, one process a rank under torch.distributed, on the
CPU with gloo at two ranks: the ranks agree on the window, rank 0 reports,
and the replicated learner's gathered state matches the reference."""

import argparse

from benchmark import run as bench_run
from benchmark.tests import tiny


def test_two_gloo_ranks_run_a_cell():
    args = argparse.Namespace(workload="qnet.ladder", seed=tiny.SEED,
                              seconds=0.5, trace=0)
    out, modules = bench_run.launch(args, 2, backend="gloo",
                                    overrides=tiny.overrides("qnet.ladder"))
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2
    assert not {m.split(".")[0] for m in modules} & {"jax", "pingpong_tpu"}
