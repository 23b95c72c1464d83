"""PyTorch port: the self-play generation loop's promotion, fault and
warm-start flows at tiny CPU shapes (the flows of tests/test_selfplay.py)."""

import dataclasses

import torch

from pingpong_tpu.checkpoint.store import load_checkpoint as jload_checkpoint
from pingpong_tpu.selfplay.pool import load_pool as jload_pool
from pingpong_tpu_torch.checkpoint.store import list_checkpoints, load_checkpoint
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.models.qnet import qnet_to_flat
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.utils.metrics import MetricsLogger


def tiny(**sp):
    cfg = load_config("configs/qnet.yaml")
    sel = dataclasses.replace(cfg.dqn.selfplay, **{
        "max_generations": 2, "episodes_per_generation": 8,
        "eval_episodes": 16, "max_retries_for_generation": 2,
        "win_rate_interval": 8, **sp})
    dq = dataclasses.replace(
        cfg.dqn, selfplay=sel, num_envs=256, rollout_length=16,
        updates_per_iteration=2, batch_size=128, memory_size=16384,
        pallas_tile_rows=128, pool_max=4, target_update_interval=16,
        save_latest_checkpoint_interval_steps=0)
    return dataclasses.replace(cfg.env, max_episode_steps=200), dq


def make_selfplay(tmp_path, env, dq, seed=0):
    return QNetSelfPlay(env, dq, workdir=str(tmp_path), seed=seed,
                        logger=MetricsLogger(echo=False), device="cpu")


def test_promotion_path_and_pool_reload(tmp_path):
    env, dq = tiny(curr_win_threshold=0.0, pool_win_threshold=0.0)
    records = make_selfplay(tmp_path, env, dq).run()
    assert [(r.generation, r.promoted, r.tries) for r in records] == [
        (1, True, 1), (2, True, 1)]
    names = [p.name for p in list_checkpoints(tmp_path / "checkpoints")]
    assert names == ["model5-1", "model5-2"]
    ck = load_checkpoint(tmp_path / "checkpoints" / "model5-1")
    assert ck["generation"] == 1 and ck["model_kind"] == "qnet"
    assert 0 <= ck["epsilon"] <= 1
    # the JAX package reads the same files, optimizer leaves included
    jck = jload_checkpoint(tmp_path / "checkpoints" / "model5-2")
    assert int(jck["opt_state"][0]) == jck["train_steps"] > 0
    assert jck["opt_state"][1].shape == jck["opt_state"][2].shape == (5192,)
    assert len(jload_pool(tmp_path / "checkpoints")) == 2
    # a second run loads both generations into its opponent pool
    d2 = make_selfplay(tmp_path, env, dataclasses.replace(
        dq, selfplay=dataclasses.replace(dq.selfplay, max_generations=1)))
    assert len(d2.pool) == 2
    d2.run()


def test_fault_path_resets_learner(tmp_path):
    env, dq = tiny(max_generations=1, curr_win_threshold=1.1,
                   pool_win_threshold=1.1)
    d = make_selfplay(tmp_path, env, dq)
    init = qnet_to_flat(d.init_params)
    records = d.run()
    assert len(records) == 1 and not records[0].promoted
    assert records[0].tries == 2
    names = [p.name for p in list_checkpoints(tmp_path / "checkpoints")]
    assert names == ["model5-1_fault"]
    # reset: initial weights, fresh buffer, optimizer and epsilon
    st = d.state
    assert st.epsilon == 1.0 and st.buffer.size == 0
    assert st.opt_count == 0 and st.train_steps == 0
    assert torch.equal(st.params, init) and torch.equal(st.target, init)
    assert not st.opt_mu.any() and not st.opt_nu.any()


def test_warm_start_from_checkpoint(tmp_path):
    env, dq = tiny(curr_win_threshold=0.0, pool_win_threshold=0.0,
                   max_generations=1)
    d1 = make_selfplay(tmp_path, env, dq)
    d1.run()
    d2 = make_selfplay(tmp_path, env, dataclasses.replace(
        dq, init_model_path="checkpoints/model5-1"), seed=1)
    assert d2.state.episodes == d1.state.episodes
    assert d2.state.epsilon < 1.0
    assert torch.equal(d2.state.params, d1.state.params)
    assert len(d2.pool) == 1
