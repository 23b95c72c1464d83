"""PyTorch port: the weak-scaling bench (``tools/scaling_bench.py``) on gloo
CPU processes: the ladder [1, 2] runs, reports sane rates and the JSON
contract of ``tests/test_podrun_recipe.py``, and a rung's ranks really
split the batch. A mechanism check: CPU ranks share the host's cores."""

import json

import pytest

from pingpong_tpu_torch.tools import scaling_bench as sb

ROW_KEYS = {"devices", "global_envs", "env_steps_per_s", "scaling_efficiency"}


def test_ladder_cli_contract(capsys):
    rc = sb.main(["--per-device-envs", "8", "--rollout-length", "8",
                  "--updates", "2", "--n1", "1", "--n2", "2",
                  "--devices", "1,2", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["metric"] == "weak_scaling_efficiency"
    assert summary["unit"] == "fraction"
    assert 0.0 < summary["value"]
    ladder = summary["ladder"]
    assert [r["devices"] for r in ladder] == [1, 2]
    assert [r["global_envs"] for r in ladder] == [8, 16]
    assert ladder[0]["scaling_efficiency"] == 1.0
    assert all(set(r) == ROW_KEYS and r["env_steps_per_s"] > 0
               for r in ladder)
    assert summary["value"] == ladder[-1]["scaling_efficiency"]


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_rung_config_holds_a_chunk_and_splits(layout):
    """The replay of a rung holds one chunk of the whole batch (and
    divides into the sharded layout's rank rings); the batch splits
    into whole rank blocks."""
    for n in (1, 2, 4):
        cfg = sb.bench_config(n, 4096, 128, 64, True, layout)
        assert cfg.memory_size >= cfg.num_envs * cfg.rollout_length
        assert cfg.memory_size % (128 * n) == 0 and cfg.num_envs % n == 0
        assert cfg.batch_size % n == 0
    assert sb.bench_config(1, 8, 8, 2, False, layout).memory_size == 65536


def test_measure_rate_two_ranks_sharded():
    rate = sb.measure_rate(2, 8, rollout_length=8, updates=2, n1=1, n2=2,
                           learner_sharding="sharded", device="cpu")
    assert rate > 0
