"""The probe opens and closes the measured window at ``train_iteration``
calls, hands the program its functions back, and leaves the loop's state
usable: the loop runs on to a promotion afterwards."""

import dataclasses
import importlib
import tempfile

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["qnet.ladder", "drqn.ladder"])
def test_window_ends_and_state_stays_usable(cell):
    run = harness.load_cell(cell, overrides=tiny.overrides(cell))
    logger = harness.recording_logger()
    with tempfile.TemporaryDirectory() as workdir:
        loop = harness.build_loop(run, tiny.SEED, workdir, logger, "cpu",
                                  False)
        inner = loop.learner.train_iteration
        probe = harness.Probe(loop, logger, 0.2,
                              update_probe=run["config"].get("update_probe"))
        with pytest.raises(harness.WindowEnd):
            loop.run()
        assert probe.t1 - probe.t0 >= 0.2
        assert probe.spans and all(probe.t0 <= s["t0"] <= s["t1"] <= probe.t1
                                   for s in probe.spans)
        assert len(probe.checks) == harness.N_CHECKED
        assert probe.gate is not None
        probe.release()
        assert loop.learner.train_iteration == inner
        if run["config"].get("update_probe"):
            mod, attr = run["config"]["update_probe"].split(":")
            fn = getattr(importlib.import_module(mod), attr)
            assert fn.__name__ == attr
        sp = dataclasses.replace(
            loop.cfg.selfplay, max_generations=loop.done_generations + 1,
            curr_win_threshold=0.0, pool_win_threshold=0.0)
        loop.cfg = dataclasses.replace(loop.cfg, selfplay=sp)
        records = loop.run()
        assert records and records[-1].promoted
