"""PyTorch port: the data-parallel learner and loops on gloo CPU processes.

* the replicated layouts of both learners on n ranks are bit-equal to the
  port's single-process iteration, every leaf of the gathered state: the
  fused routes (kernels 1-4's plain versions) with a pool, sorted binding
  (the whole batch sorted, envs exchanged between ranks), the scan rollout
  with the autodiff update, and a rank block that does not split into
  whole tiles (every rank runs the whole batch);
* the self-play loops on 2 ranks promote the same generation on both, and
  only rank 0 writes checkpoints; a sharded kill-and-resume restores the
  saved whole state and continues bit-equal to the straight run;
* ``cli train --distributed`` on 2 ranks promotes, rank 0 alone writes,
  and the JAX package loads and plays its checkpoint."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.models.qnet import qnet_apply as japply
from pingpong_tpu.selfplay.pool import load_params_any as jload_params
from pingpong_tpu_torch.models.qnet import qnet_apply
from pingpong_tpu_torch.selfplay.pool import load_params_any
from tests.test_torch_learner import np_qnet
from tests.test_torch_seq_directory import np_rnn
from tests.torch_dist import (
    REPO,
    build_learner,
    free_port,
    host_tree,
    run_ranks,
    wait_all,
    worker_env,
)

DQN = dict(num_envs=128, rollout_length=16, updates_per_iteration=3,
           batch_size=128, memory_size=16384, pallas_tile_rows=32,
           target_update_interval=2, learner_sharding="replicated")
DRQN = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16,
            trace_length=4, num_envs=64, rollout_length=32,
            updates_per_iteration=4, batch_size=16,
            min_episodes_for_training_start=1, ring_len=512,
            pallas_tile_rows=16, max_episode_steps=128,
            target_update_interval=3, learner_sharding="replicated")
ENV = dict(max_episode_steps=64)


def single_process(payload):
    """The same iterations in this process, without a mesh."""
    learner, params, from_np = build_learner(payload, None)
    st = learner.init_global_state(payload["seed"], params)
    opp = learner.prepare_opponents([from_np(d) for d in payload["opp"]])
    metrics = []
    for _ in range(payload["iters"]):
        st, m = learner.train_iteration(st, opp, payload["pool_size"])
        metrics.append(m._asdict())
    return host_tree(st), metrics


def assert_bit_equal(res, payload):
    want, wm = single_process(payload)
    got = res[0]["global"]
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    for r in res:
        assert not r["sharded"]
        for k in ("params", "target", "opt_mu", "opt_nu"):
            assert torch.equal(r["local"][k], want[k]), k
        for m, w in zip(r["metrics"], wm):
            # the return sum adds the ranks' partial sums: another order
            key = "episode_return_sum"
            assert {**m, key: 0} == {**w, key: 0}
            np.testing.assert_allclose(m[key], w[key], rtol=1e-6, atol=1e-6)


DQN_CASES = {
    "kernels_pool": {},                 # kernels 1 and 2
    "sorted": dict(opponent_binding="sorted"),
    "scan_autodiff": dict(use_pallas_rollout=False, use_pallas_update=False),
    "whole_batch": dict(num_envs=96, memory_size=4096),   # 48 % 32 != 0
}


@pytest.mark.parametrize("case", sorted(DQN_CASES))
def test_replicated_dqn_is_the_single_process_iteration(case, tmp_path):
    rng = np.random.default_rng(len(case))
    pb, pa = np_qnet(rng), np_qnet(rng)
    payload = dict(kind="dqn", env=ENV, cfg={**DQN, **DQN_CASES[case]},
                   seed=5, params=pb, opp=[pa, pb, pa], pool_size=2, iters=3)
    assert_bit_equal(run_ranks("learner", 2, tmp_path, payload), payload)


DRQN_CASES = {
    "kernels_pool": ({}, 2),
    "sorted_4_ranks": (dict(opponent_binding="sorted"), 4),
    "scan_burn_in": (dict(use_pallas_rollout=False, use_pallas_update=False,
                          burn_in_length=1), 2),
    "whole_batch": (dict(num_envs=96, pallas_tile_rows=32), 2),
}


@pytest.mark.parametrize("case", sorted(DRQN_CASES))
def test_replicated_drqn_is_the_single_process_iteration(case, tmp_path):
    over, n = DRQN_CASES[case]
    rng = np.random.default_rng(len(case))
    pb, pa = np_rnn(rng), np_rnn(rng)
    payload = dict(kind="drqn", cfg={**DRQN, **over}, seed=5, params=pb,
                   opp=[pa, pb, pa], pool_size=2, iters=4)
    res = run_ranks("learner", n, tmp_path, payload)
    assert_bit_equal(res, payload)
    assert res[0]["metrics"][-1]["updates_run"] == 4


SELFPLAY = dict(max_generations=1, episodes_per_generation=24,
                eval_episodes=16, max_retries_for_generation=1,
                curr_win_threshold=0.0, pool_win_threshold=0.0,
                win_rate_interval=8)


@pytest.mark.parametrize("kind,layout", [("dqn", "sharded"),
                                         ("drqn", "replicated")])
def test_loop_promotes_on_every_rank_and_rank0_writes(kind, layout,
                                                      tmp_path):
    if kind == "dqn":
        cfg = dict(num_envs=32, rollout_length=16, updates_per_iteration=2,
                   batch_size=16, memory_size=4096, pool_max=2,
                   pallas_tile_rows=16, target_update_interval=8)
    else:
        cfg = {k: v for k, v in DRQN.items() if k != "learner_sharding"}
        cfg.update(pool_max=2, num_envs=32)
    cfg.update(learner_sharding=layout, selfplay=SELFPLAY)
    res = run_ranks("loop", 2, tmp_path, dict(
        kind=kind, env=ENV, cfg=cfg, workdir=str(tmp_path / "w")))
    for r in res:
        assert r["mesh"] and r["sharded"] == (layout == "sharded")
        assert [x["promoted"] for x in r["records"]] == [True]
        assert r["records"] == res[0]["records"]
        assert torch.equal(r["params"], res[0]["params"])
    assert len(res[0]["writes"]) == 1 and res[1]["writes"] == []


def test_sharded_kill_and_resume_is_bit_equal(tmp_path):
    cfg = dict(num_envs=32, rollout_length=16, updates_per_iteration=2,
               batch_size=16, memory_size=8192, pool_max=2,
               pallas_tile_rows=16, target_update_interval=8,
               learner_sharding="sharded",
               selfplay={**SELFPLAY, "max_generations": 2})
    res = run_ranks("loop", 2, tmp_path, dict(
        kind="dqn", env=ENV, cfg=cfg, workdir=str(tmp_path / "w"),
        resume=True, block=16))
    for r in res:
        assert r["resumed_mid"]
        assert r["local_rows"] == cfg["memory_size"] // 2
        for a, b in (("saved", "restored"), ("straight", "continued")):
            assert set(r[a]) == set(r[b])
            for k, v in r[a].items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, r[b][k]), (a, k)
                else:
                    assert v == r[b][k], (a, k)
    # the saved ring is the whole one, in the global layout
    assert res[0]["saved"]["buffer/data"].shape[0] == cfg["memory_size"]


def test_cli_train_distributed_two_ranks(tmp_path):
    """``cli train --distributed`` on 2 ranks (torchrun's environment set
    by hand): one promoted generation, the log and the checkpoint written
    once, by rank 0; the JAX package loads the checkpoint and plays it as
    the port does."""
    w = tmp_path / "w"
    port = free_port()
    procs = []
    for r in range(2):
        env = worker_env(2)
        env.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pingpong_tpu_torch.cli", "train",
             "--device", "cpu", "--distributed", "--config",
             "configs/qnet.yaml", "--workdir", str(w),
             "dqn.num_envs=256", "dqn.rollout_length=16",
             "dqn.batch_size=128", "dqn.memory_size=16384",
             "dqn.pallas_tile_rows=64", "dqn.selfplay.max_generations=1",
             "dqn.selfplay.episodes_per_generation=50",
             "dqn.selfplay.eval_episodes=50",
             "dqn.selfplay.curr_win_threshold=0.0",
             "dqn.selfplay.pool_win_threshold=0.0"],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out0, out1 = wait_all(procs, 300)
    assert "done: 1/1 generations promoted" in out0
    assert "done:" not in out1
    events = [json.loads(line)["event"] for line in
              (w / "train_qnet_metrics.jsonl").read_text().splitlines()]
    assert events.count("promoted") == 1 and events.count("mesh") == 1
    ckpt = w / "checkpoints" / "model5-1"
    assert (w / "checkpoints" / "latest_qnet_training_state").is_dir()
    obs = np.random.default_rng(0).uniform(-1, 1, (64, 7)).astype(np.float32)
    jq = japply(jload_params(ckpt), jnp.asarray(obs))
    tq = qnet_apply(load_params_any(ckpt), torch.from_numpy(obs))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=1e-5, atol=1e-6)
    assert jax.device_get(jq).shape == (64, 3)
