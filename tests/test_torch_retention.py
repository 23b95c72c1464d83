"""PyTorch port: checkpoint retention against the JAX package's
``apply_retention`` on identical directory trees (the cases of
tests/test_retention.py and the names retention must never touch), and
retention wired into both generation loops."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pingpong_tpu.checkpoint.retention import apply_retention as japply
from pingpong_tpu_torch.checkpoint.full_state import save_train_state
from pingpong_tpu_torch.checkpoint.retention import apply_retention
from pingpong_tpu_torch.checkpoint.store import list_checkpoints, save_checkpoint
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay
from pingpong_tpu_torch.utils.metrics import MetricsLogger


def build(root, names, mtimes=None):
    """Model checkpoints under ``names``; ``latest_*`` names get a
    full-state autosave and ``plain/*`` names a directory that is no
    checkpoint."""
    root.mkdir()
    for i, name in enumerate(names):
        if name.startswith("latest_"):
            save_train_state(root / name, {"x": torch.zeros(3)}, {"g": 0})
        elif name.startswith("plain/"):
            (root / name[6:]).mkdir()
        else:
            save_checkpoint(root / name, {"x": np.zeros(3), "generation": 0})
            if mtimes is not None:
                os.utime(root / name, (mtimes[i], mtimes[i]))


CASES = {
    "keeps_newest_promoted": (
        [f"model5-{g}" for g in range(6)], dict(keep_promoted=2)),
    "fault_class_and_protect": (
        [f"rnn_pong_soul_{g}" for g in range(3)]
        + [f"rnn_pong_soul_{g}_fault" for g in range(3)]
        + ["latest_rnn_training_state", "warm_start"],
        dict(keep_promoted=1, keep_faults=1, protect=["warm_start"])),
    "zero_keeps_all": (
        [f"model5-{g}" for g in range(4)], dict(keep_promoted=0,
                                                keep_faults=0)),
    "old_tmp_latest_untouched": (
        ["model5-1", "model5-2", "model5-3", "model5-2.old",
         "model5-4.tmp-77", "latest_qnet_training_state", "plain/notes"],
        dict(keep_promoted=1)),
    "generation_order_not_name_order": (
        ["model5-9", "model5-10", "model5-11", "model5-2_fault",
         "model5-10_fault"], dict(keep_promoted=2, keep_faults=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deletes_the_same_names_as_jax(tmp_path, case):
    names, kw = CASES[case]
    build(tmp_path / "jax", names)
    build(tmp_path / "port", names)
    want = japply(tmp_path / "jax", **kw)
    got = apply_retention(tmp_path / "port", **kw)
    assert sorted(got) == sorted(want)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_names_without_a_generation_fall_back_to_mtime(tmp_path):
    names = ["alpha", "beta", "gamma"]
    for side in ("jax", "port"):
        build(tmp_path / side, names, mtimes=[300, 100, 200])
    want = japply(tmp_path / "jax", keep_promoted=1)
    got = apply_retention(tmp_path / "port", keep_promoted=1)
    assert sorted(got) == sorted(want) == ["beta", "gamma"]


def test_qnet_loop_keeps_the_newest_promotion(tmp_path):
    cfg = load_config("configs/qnet.yaml")
    sp = dataclasses.replace(cfg.dqn.selfplay, max_generations=3,
                             episodes_per_generation=4, eval_episodes=8,
                             curr_win_threshold=0.0, pool_win_threshold=0.0,
                             win_rate_interval=8)
    dq = dataclasses.replace(
        cfg.dqn, selfplay=sp, num_envs=256, rollout_length=16,
        updates_per_iteration=2, batch_size=128, memory_size=16384,
        pallas_tile_rows=128, keep_checkpoints=1, use_pallas_eval=False)
    d = QNetSelfPlay(dataclasses.replace(cfg.env, max_episode_steps=200), dq,
                     workdir=str(tmp_path), logger=MetricsLogger(echo=False),
                     device="cpu")
    records = d.run()
    assert [r.promoted for r in records] == [True] * 3
    # the autosave stays beside the one promotion kept
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "latest_qnet_training_state", "model5-3"]


def test_drqn_loop_trims_fault_checkpoints(tmp_path):
    cfg = load_config("configs/rnn.yaml")
    sp = dataclasses.replace(cfg.drqn.selfplay, max_generations=3,
                             episodes_per_generation=16, eval_episodes=8,
                             max_retries_for_generation=1,
                             win_rate_interval=8, curr_win_threshold=1.1,
                             pool_win_threshold=1.1)
    dq = dataclasses.replace(
        cfg.drqn, selfplay=sp, feature_dim=32, lstm_hidden_dim=16,
        head_hidden_dim=16, trace_length=4, num_envs=32, rollout_length=32,
        updates_per_iteration=2, batch_size=8, ring_len=128,
        pallas_tile_rows=32, min_episodes_for_training_start=1,
        max_episode_steps=128, keep_fault_checkpoints=2,
        save_latest_checkpoint_interval_steps=0)
    d = DRQNSelfPlay(cfg.env, dq, workdir=str(tmp_path),
                     logger=MetricsLogger(echo=False), device="cpu")
    assert [r.promoted for r in d.run()] == [False] * 3
    assert [p.name for p in list_checkpoints(tmp_path / "checkpoints_rnn")] \
        == ["rnn_pong_soul_2_fault", "rnn_pong_soul_3_fault"]
