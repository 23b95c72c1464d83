"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit file, metric reader and kernel count is found by name,
and the file keeps to the benchmark's contract."""

import importlib
import json
import re

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_is_found_by_name(cell):
    run = harness.load_cell(cell)
    w = run["cell"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert all(NAME.match(x) for x in (w["name"], w["config"], w["traffic"]))
    assert run["section"] in run["cfg"]
    importlib.import_module(
        f"benchmark.reference.{run['config']['reference']}")
    importlib.import_module(f"benchmark.models.{run['config']['reference']}")
    assert set(run["limits"]) >= {"start_gap", "rollout_mismatch",
                                  "action_gap", "loss_gap", "grad_gap",
                                  "gate_gap"}
    assert {"dparam_gap", "dparam_median_gap"} & set(run["limits"])
    for m in ("end_to_end", "per_layer"):
        assert harness.cell_metrics(SPEC, cell, m)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(conf["why"]) <= 200 and "\n" not in conf["why"]
    assert conf["file"].startswith("benchmark/configs/")
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert set(conf["reduced"]) == set(data["reduced"])
    assert all(NAME.match(k) for k in conf["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in conf["reduced"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in E2E and metric["layer"]
        moved = next(m for m in SPEC["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
        reader = importlib.import_module(f"benchmark.metrics.{metric['name']}")
        assert callable(reader.read)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
def test_kernel_count_is_found_by_name(kernel):
    k = importlib.import_module(f"benchmark.kernels.{kernel}")
    assert k.NAME and callable(k.bound_s)
    assert any(m["name"] == f"{kernel}_roofline" for m in SPEC["per_layer"])
