"""A run with the timed path broken underneath comes out not correct: each
update block on half its batch, the update leaving the parameters
unchanged, one action altered where the rollout emits it
(``benchmark/control.py``'s plants), for both families."""

import pytest

from benchmark import control
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["qnet.ladder", "drqn.ladder"])
def test_planted_faults_fail(cell):
    modes = ["sound", "half", "unchanged", "token"]
    out = {r["mode"]: r for r in control.readings(
        cell, tiny.SEED, modes, device="cpu",
        overrides=tiny.overrides(cell))}
    assert out["sound"]["correct"]
    for mode in modes[1:]:
        assert not out[mode]["correct"], (mode, out[mode]["values"])
