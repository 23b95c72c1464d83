"""PyTorch port: the DQN roofline tool (``tools/dqn_roofline_bench.py``):
its kernel-2 accounting reproduces the bound of the kernel table's row
(0.0073 ms at K 64, batch 256, replay 2^20, heads only: operations over
the H100's float32 rate), counts the bytes the samples touch, and its
stage timing runs on the CPU at tiny shapes."""

import math

import pytest
import torch

from pingpong_tpu_torch.tools import dqn_roofline_bench as rb


def test_bench_shape_bound_is_the_kernel_table_row():
    idx = torch.randint(0, 1 << 20, (64, 256),
                        generator=torch.Generator().manual_seed(0))
    acc = rb.update_accounting(256, 64, (1 << 20) // 128, True, idx)
    assert acc["bound_by"] == "operations"
    assert round(acc["bound_ms"], 4) == 0.0073
    assert acc["bound_ms"] == pytest.approx(acc["flops"] / 67e12 * 1e3)
    assert rb.update_bound_ms(256, 64, 8192, True, idx) == (
        acc["bound_ms"], "operations")
    # the full backward adds operations; repeated slots move fewer bytes
    full = rb.update_accounting(256, 64, 8192, False, idx)
    assert full["flops"] > acc["flops"]
    same = rb.update_accounting(256, 64, 8192, True, torch.zeros_like(idx))
    assert same["bytes"] < acc["bytes"] and same["flops"] == acc["flops"]


def test_stage_timing_runs_on_the_cpu(capsys):
    r = rb.measure("cpu", num_envs=256, rollout_length=16, updates=2,
                   batch_size=128, memory_size=16384, windows=(1, 2),
                   trials=1, warm=2)
    for k in ("full_s", "update_s", "rollout_s", "glue_s"):
        assert math.isfinite(r[k])
    assert r["full_s"] > 0 and r["update_s"] > 0 and r["rollout_s"] > 0
    assert r["glue_s"] == pytest.approx(
        r["full_s"] - r["update_s"] - r["rollout_s"])
    summary = rb.report(r, "cpu")
    err = capsys.readouterr().err
    assert "update block (2 updates, kernel 2)" in err and "| cpu" in err
    assert set(summary) >= {"full_ms", "update_ms", "rollout_ms", "glue_ms",
                            "bound_ms", "pct_f32", "pct_hbm"}
    with pytest.raises(ValueError):      # not kernel 2's shapes
        rb.measure("cpu", num_envs=64, rollout_length=8, updates=2,
                   batch_size=100, memory_size=16384, windows=(1, 2),
                   trials=1, warm=0)
