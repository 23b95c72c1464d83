"""The plain reference against the port on the CPU at a small size, for
every cell: the port runs its kernels' plain versions there, so every gap
is nought and the run is correct; the traced run reads its per-layer
metrics from the spans."""

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_reference_matches_the_port_on_the_cpu(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert all(row["value"] <= 1e-6 for row in out["checks"].values())
    assert list(out)[-1] == "checks"
    spec = harness.benchmark_spec()
    assert set(out["metrics"]) == {
        m["name"] for m in harness.cell_metrics(spec, cell, "end_to_end")}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_run_reports_per_layer_metrics_and_breakdown():
    out = tiny.run("qnet.ladder", seconds=1.0, trace=True)
    assert out["correct"]
    assert {"iter_ms_p50", "step_mfu", "iter_mfu"} <= set(out["metrics"])
    assert "breakdown" in out and out["device"]["window_s"] > 0
