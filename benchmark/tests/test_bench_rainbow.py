"""The cell ``rainbow.ladder``: kernel 6's and the Rainbow net's counts
against hand counts, the cell against its plain reference on the CPU at a
small size (and its planted faults caught there); and the QNet ladder's
replicated learner on four gloo ranks, the path a four-card cell runs."""

import argparse
import math

import pytest

from benchmark import harness
from benchmark import run as bench_run
from benchmark.kernels import k6
from benchmark.models import rainbow as mrainbow
from benchmark.peaks import bound_s
from benchmark.reference import rainbow as ref
from benchmark.tests import tiny

RAINBOW = {"dqn.num_envs": 16, "dqn.rollout_length": 8,
           "dqn.batch_size": 32, "dqn.memory_size": 4096,
           "dqn.updates_per_iteration": 4, "dqn.stream_hidden": 32,
           "dqn.num_atoms": 11, "dqn.selfplay.episodes_per_generation": 8,
           "dqn.selfplay.eval_episodes": 16, "env.max_episode_steps": 256}


def test_k6_by_hand():
    # 2 rows of 3 atoms, a target atom each: 6 to shift it onto the
    # grid, 8 to split its mass between its floor and ceiling atoms, 4 for
    # the log-sum-exp, 3 for the loss and 3 for the gradient
    flops, nbytes = k6.cost(2, 3)
    assert flops == 2 * 3 * (6 + 8 + 4 + 3 + 3)
    # logits, target, return, discount, weight in; loss and gradient out
    assert nbytes == 2 * 4 * (3 + 3 + 1 + 1 + 1) + 2 * 4 * (1 + 3)
    d = {"batch_size": 2, "num_atoms": 3}
    assert k6.bound_s(d, {}, "iteration") == bound_s(flops, nbytes)


def test_k6_is_found_by_name():
    assert k6.NAME == "c51_loss_kernel"
    spec = harness.benchmark_spec()
    entry = next(m for m in spec["per_layer"] if m["name"] == "k6_roofline")
    assert entry["workloads"] == ["rainbow.ladder"]


def test_rainbow_flops_by_hand():
    d = {"num_atoms": 3, "stream_hidden": 4, "train_heads_only": False}
    noisy = 64 * 4 + 4 * 3 + 64 * 4 + 4 * 9
    assert mrainbow.forward_flops(d) == 2 * (7 * 64 + 64 * 64 + 2 * noisy)
    # mu and sigma gradients, the streams' input gradients, the trunk's
    # weights and its second layer's input gradient (the full net)
    back = 2 * noisy + (4 * 3 + 4 * 9) + 2 * 64 * 4 \
        + 7 * 64 + 64 * 64 + 64 * 64
    assert mrainbow.row_flops(d) == 3 * mrainbow.forward_flops(d) \
        + 24 * 3 + 2 * back
    heads = mrainbow.row_flops({**d, "train_heads_only": True})
    assert mrainbow.row_flops(d) - heads == 2 * (2 * 64 * 4 + 7 * 64
                                                 + 2 * 64 * 64)
    # the configuration's widths: about 0.69 MFLOP a forward
    full = {"num_atoms": 51, "stream_hidden": 512}
    assert mrainbow.forward_flops(full) == 689024


def test_rainbow_weights_match_the_reference_net():
    """The noisy weights the counts assume are the reference net's."""
    d = {"num_atoms": 51, "stream_hidden": 512}
    mu = sum(math.prod(s) for n, s in ref.shapes(d)
             if n.endswith(".w_mu"))
    assert mu == mrainbow._noisy(d)
    assert sum(math.prod(s) for _, s in ref.shapes(d)) == 347096


def test_rainbow_cell_matches_its_reference_on_the_cpu():
    """The port's plain versions against the reference: every rollout
    and start number equal, the update's within float32 rounding."""
    out = harness.run_cell("rainbow.ladder", tiny.SEED, 0.5, False,
                           0.0, device="cpu", overrides=RAINBOW)
    assert out["correct"], out["checks"]
    assert all(row["value"] <= 1e-6 for row in out["checks"].values())
    spec = harness.benchmark_spec()
    assert set(out["metrics"]) == {"iter_ms_p95", "setup_s"} == {
        m["name"] for m in harness.cell_metrics(spec, "rainbow.ladder",
                                                "end_to_end")}
    assert out["attempted"] > 0


@pytest.mark.parametrize("mode", ["half", "unchanged", "token"])
def test_rainbow_plants_are_caught_on_the_cpu(mode):
    """Each fault ``rainbow_control.py`` plants fails a limit."""
    import rainbow_control

    (line,) = rainbow_control.readings(tiny.SEED, [mode], "cpu", RAINBOW)
    assert not line["correct"], line["values"]


def test_four_gloo_ranks_run_the_dist4_cell():
    """``qnet.ladder`` data-parallel on four gloo ranks at the tiny size,
    replicated, as a four-card cell of that ladder would run it: the
    gathered state and the gate match the reference within the ladder's
    limits."""
    args = argparse.Namespace(workload="qnet.ladder", seed=1232869926,
                              seconds=0.5, trace=0)
    out, modules = bench_run.launch(
        args, 4, backend="gloo",
        overrides={**tiny.overrides("qnet.ladder"),
                   "dqn.learner_sharding": "replicated"})
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert set(out["checks"]) == set(harness.load_cell("qnet.ladder")
                                      ["limits"])
    assert not {m.split(".")[0] for m in modules} & {"jax", "pingpong_tpu"}
