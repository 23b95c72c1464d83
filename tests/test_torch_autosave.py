"""PyTorch port: the full-state autosave and its resume
(``checkpoint/full_state.py``, tier 0 of the QNet loop, tier 1 of the
DRQN loop), held to the JAX package's flows (tests/test_selfplay.py,
tests/test_selfplay_rnn.py): a round trip restores every tensor, int and
generator state; the async snapshot is taken at call time; a resume
mid-generation keeps the label; a straight run and a kill-and-resume run
end bit-equal; the frozen-A noise survives a resume; a corrupt autosave
falls through to the next tier. The JAX package's own checkpoint tools
never take the port's autosave for a model checkpoint. Last, both CLIs at
the shipped autosave interval, twice in one workdir, and the stall bench
at tiny shapes."""

import dataclasses
import json
import shutil
import threading

import pytest
import torch

from pingpong_tpu.checkpoint.orbax_io import (
    is_train_state_checkpoint as jis_train_state,
)
from pingpong_tpu.checkpoint.retention import apply_retention as jretention
from pingpong_tpu.checkpoint.store import list_checkpoints as jlist
from pingpong_tpu.selfplay.pool import load_pool as jload_pool
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.checkpoint import full_state
from pingpong_tpu_torch.checkpoint.full_state import (
    flatten_tree,
    is_train_state_checkpoint,
    restore_train_state,
    save_train_state,
)
from pingpong_tpu_torch.checkpoint.store import list_checkpoints
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay
from pingpong_tpu_torch.selfplay.pool import load_pool
from pingpong_tpu_torch.utils.metrics import MetricsLogger


def qnet_cfg(**kw):
    cfg = load_config("configs/qnet.yaml")
    sp = dataclasses.replace(cfg.dqn.selfplay, **{
        "max_generations": 2, "episodes_per_generation": 8,
        "eval_episodes": 16, "win_rate_interval": 8,
        "curr_win_threshold": 0.0, "pool_win_threshold": 0.0,
        **kw.pop("sp", {})})
    dq = dataclasses.replace(
        cfg.dqn, selfplay=sp, num_envs=256, rollout_length=16,
        updates_per_iteration=2, batch_size=128, memory_size=16384,
        pallas_tile_rows=128, pool_max=4, target_update_interval=16, **kw)
    return dataclasses.replace(cfg.env, max_episode_steps=200), dq


def drqn_cfg(**kw):
    cfg = load_config("configs/rnn.yaml")
    sp = dataclasses.replace(cfg.drqn.selfplay, **{
        "max_generations": 2, "episodes_per_generation": 16,
        "eval_episodes": 8, "win_rate_interval": 8,
        "curr_win_threshold": 0.0, "pool_win_threshold": 0.0,
        **kw.pop("sp", {})})
    dq = dataclasses.replace(
        cfg.drqn, selfplay=sp, feature_dim=32, lstm_hidden_dim=16,
        head_hidden_dim=16, trace_length=4, num_envs=32, rollout_length=32,
        updates_per_iteration=2, batch_size=8, ring_len=128,
        pallas_tile_rows=32, min_episodes_for_training_start=1,
        max_episode_steps=128, **kw)
    return cfg.env, dq


DRIVERS = {"qnet": (QNetSelfPlay, qnet_cfg, "checkpoints",
                    "latest_qnet_training_state"),
           "drqn": (DRQNSelfPlay, drqn_cfg, "checkpoints_rnn",
                    "latest_rnn_training_state")}


def driver(kind, tmp_path, seed=0, log=None, **kw):
    cls, cfg_fn, _, _ = DRIVERS[kind]
    env, cfg = cfg_fn(**kw)
    return cls(env, cfg, workdir=str(tmp_path), seed=seed,
               logger=log or MetricsLogger(echo=False), device="cpu")


def snapshot(tree):
    """Independent copies of every leaf (generators as state bytes)."""
    out = {}
    for k, v in flatten_tree(tree).items():
        if isinstance(v, torch.Generator):
            v = v.get_state()
        out[k] = v.clone() if isinstance(v, torch.Tensor) else v
    return out


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


def whole(d):
    """The state a resume must reproduce: train state, A, host generator."""
    return snapshot({"state": d.state, "a": list(d.params_a.parameters()),
                     "host": d.gen})


def events(log_path):
    return [json.loads(x) for x in log_path.read_text().splitlines() if x]


@pytest.mark.parametrize("kind", sorted(DRIVERS))
@pytest.mark.parametrize("async_save", [True, False])
def test_round_trip_restores_every_leaf(tmp_path, kind, async_save):
    d1 = driver(kind, tmp_path, async_autosave=async_save)
    d1.current_generation = 1
    d1._train_block(8)
    d1.autosave(wait=True)
    saved = whole(d1)
    latest = tmp_path / DRIVERS[kind][2] / DRIVERS[kind][3]
    assert is_train_state_checkpoint(latest)
    # never a model checkpoint: no meta.json/arrays.npz, skipped by the
    # store, the pool and the JAX package's tools alike
    assert not (latest / "meta.json").exists()
    assert not (latest / "arrays.npz").exists()
    assert list_checkpoints(latest.parent) == []
    assert load_pool(latest.parent) == [] and jload_pool(latest.parent) == []
    assert jlist(latest.parent) == [] and jis_train_state(latest)
    assert jretention(latest.parent, keep_promoted=1, keep_faults=1) == []

    d2 = driver(kind, tmp_path, seed=7)
    assert_same(saved, whole(d2))
    assert d2.current_generation == 1 and d2.done_generations == 0
    meta = json.loads((latest / "framework_meta.json").read_text())
    assert set(meta) == {"generation", "done_generations", "model_kind"}


@pytest.mark.parametrize("kind", sorted(DRIVERS))
def test_async_snapshot_survives_in_place_training(tmp_path, kind):
    """The port's buffers change in place (``per_push``,
    ``seq_push_rollout``): the autosave must hold the state at the
    ``save()`` call, not the state the worker finds later."""
    d1 = driver(kind, tmp_path)
    assert d1.cfg.async_autosave
    d1.current_generation = 1
    d1._train_block(8)
    at_save = whole(d1)
    d1.autosave()                # returns with the write in flight
    d1._train_block(8)           # rewrites the replay in place
    d1.flush_autosave()
    after = whole(d1)
    assert any(not torch.equal(at_save[k], after[k]) for k in at_save
               if isinstance(at_save[k], torch.Tensor))
    assert_same(at_save, whole(driver(kind, tmp_path, seed=5)))


@pytest.mark.parametrize("kind", sorted(DRIVERS))
def test_periodic_autosave_keeps_its_cadence_and_resumes(tmp_path, kind,
                                                        monkeypatch):
    """A small interval: the autosave fires inside ``_train_block`` every
    ``interval`` train steps without waiting, and the newest one, written
    only after training went on, restores bit-equal to the state at its
    ``save()``."""
    interval = 4                      # two iterations of 2 updates
    log = tmp_path / "log.jsonl"
    d1 = driver(kind, tmp_path, log=MetricsLogger(str(log), echo=False),
                save_latest_checkpoint_interval_steps=interval)
    d1.current_generation = 1
    at_save = []
    periodic_save = d1.autosave
    may_write = threading.Semaphore(0)
    write = full_state._write

    def late_write(*args):            # each write waits for more training
        assert may_write.acquire(timeout=60)
        return write(*args)

    monkeypatch.setattr(full_state, "_write", late_write)

    def autosave(wait=False):
        assert not wait
        if at_save:
            may_write.release()       # the previous save's write goes on
        at_save.append(whole(d1))
        return periodic_save(wait)

    d1.autosave = autosave
    for _ in range(6):
        d1._train_block(8)
    steps = [e["train_steps"] for e in events(log) if e["event"] == "autosave"]
    assert len(at_save) == len(steps) and steps == list(
        range(interval, d1.state.train_steps + 1, interval))
    assert len(steps) >= 3
    d1.cfg = dataclasses.replace(d1.cfg,
                                 save_latest_checkpoint_interval_steps=0)
    d1._train_block(8)                # trains on over the last write
    may_write.release()
    d1.flush_autosave()
    assert d1._autosaver._thread is None and not d1._autosaver._pinned
    assert d1.state.train_steps > steps[-1]
    assert_same(at_save[-1], whole(driver(kind, tmp_path, seed=5)))


@pytest.mark.parametrize("kind", sorted(DRIVERS))
def test_resume_mid_generation_keeps_the_label(tmp_path, kind):
    d1 = driver(kind, tmp_path)
    d1.current_generation = 2       # an interrupted generation 2
    d1.done_generations = 1
    d1._train_block(8)
    d1.autosave(wait=True)
    saved = whole(d1)
    steps = d1.state.train_steps
    d2 = driver(kind, tmp_path, seed=7)
    assert d2._resumed_mid_generation
    assert d2.current_generation == 2 and d2.done_generations == 1
    assert_same(saved, whole(d2))
    records = d2.run()
    assert [r.generation for r in records] == [2]
    # run() continued the restored B (no new_generation reset at entry)
    assert d2.state.train_steps > steps


@pytest.mark.parametrize("kind", sorted(DRIVERS))
def test_straight_run_equals_kill_and_resume(tmp_path, kind):
    """N + M episodes in one driver against N, an autosave, a new driver
    of another seed in the same workdir, then M: the same parameters,
    replay, counters and generator states."""
    straight = driver(kind, tmp_path / "straight")
    straight.current_generation = 1
    straight._train_block(8)
    straight._train_block(8)

    first = driver(kind, tmp_path / "resumed")
    first.current_generation = 1
    first._train_block(8)
    first.autosave(wait=True)
    del first
    second = driver(kind, tmp_path / "resumed", seed=123)
    second._train_block(8)
    assert_same(whole(straight), whole(second))


def test_frozen_a_fold_persists_across_resume(tmp_path):
    sp = dict(frozen_a_stale_noise=True)
    d1 = driver("qnet", tmp_path, sp=sp)
    d1.current_generation = 1
    d1._train_block(8)
    d1.autosave(wait=True)
    play1 = [p.clone() for p in d1.params_a_play.parameters()]
    # another seed: without the saved draw the new driver would fold
    # other noise into A
    d2 = driver("qnet", tmp_path, sp=sp, seed=99)
    play2 = list(d2.params_a_play.parameters())
    assert all(torch.equal(a, b) for a, b in zip(play1, play2))
    assert not torch.equal(d2.params_a_play.fc_a.w_mu, d2.params_a.fc_a.w_mu)


def test_drqn_tier1_restores_the_counters_and_pool(tmp_path):
    d1 = driver("drqn", tmp_path, sp=dict(max_generations=1))
    d1.run()
    d2 = driver("drqn", tmp_path, seed=1, sp=dict(max_generations=1))
    assert d2.state.episodes == d1.state.episodes
    assert d2.state.train_steps == d1.state.train_steps > 0
    assert d2.done_generations == 1 and not d2._resumed_mid_generation
    assert len(d2.pool) == 1           # the promotion, not the autosave
    assert d2.run() == []              # nothing left to do


@pytest.mark.parametrize("kind,tier", [("qnet", None), ("drqn", 3),
                                       ("drqn", 2)])
def test_corrupt_autosave_falls_through(tmp_path, kind, tier):
    kw = {}
    if tier == 2:
        warm = driver("drqn", tmp_path, sp=dict(max_generations=1))
        warm.run()
        kw = dict(init_model_path_rnn="checkpoints_rnn/rnn_pong_soul_1")
    latest = tmp_path / DRIVERS[kind][2] / DRIVERS[kind][3]
    shutil.rmtree(latest, ignore_errors=True)
    latest.mkdir(parents=True)
    (latest / "state.pt").write_bytes(b"not a checkpoint")
    log = tmp_path / "log.jsonl"
    d = driver(kind, tmp_path, log=MetricsLogger(str(log), echo=False), **kw)
    ev = events(log)
    assert ev[0]["event"] == "restore_failed"
    assert ev[0]["tier"] == (0 if kind == "qnet" else 1)
    if tier is not None:
        assert ev[1]["event"] == "restore" and ev[1]["tier"] == tier
    # a fresh state was kept and the run goes on
    assert d.state.train_steps == 0 and d.current_generation == 0
    assert [r.generation for r in d.run()] == [1, 2]


@pytest.mark.parametrize("change", ["shape", "dtype", "missing", "extra",
                                    "type"])
def test_restore_refuses_a_mismatched_template(tmp_path, change):
    tree = {"a": torch.zeros(4), "n": 3, "g": torch.Generator()}
    save_train_state(tmp_path / "ck", tree, {})
    bad = dict(tree)
    if change == "shape":
        bad["a"] = torch.zeros(5)
    elif change == "dtype":
        bad["a"] = torch.zeros(4, dtype=torch.float64)
    elif change == "missing":
        bad["b"] = torch.zeros(1)
    elif change == "extra":
        del bad["n"]
    else:
        bad["n"] = 3.0
    with pytest.raises((KeyError, ValueError)):
        restore_train_state(tmp_path / "ck", bad)
    assert restore_train_state(tmp_path / "ck", tree)["n"] == 3


QNET_CLI = ["train", "--config", "configs/qnet.yaml", "--device", "cpu",
            "dqn.num_envs=256", "dqn.rollout_length=16",
            "dqn.batch_size=128", "dqn.memory_size=16384",
            "dqn.updates_per_iteration=2",
            "dqn.pallas_tile_rows=128", "dqn.selfplay.eval_episodes=16",
            "dqn.selfplay.episodes_per_generation=16",
            "dqn.selfplay.curr_win_threshold=0.0",
            "dqn.selfplay.pool_win_threshold=0.0", "env.max_episode_steps=200"]
DRQN_CLI = ["train-rnn", "--config", "configs/rnn.yaml", "--device", "cpu",
            "drqn.feature_dim=32", "drqn.lstm_hidden_dim=16",
            "drqn.head_hidden_dim=16", "drqn.trace_length=4",
            "drqn.num_envs=32", "drqn.rollout_length=32",
            "drqn.updates_per_iteration=4", "drqn.batch_size=8",
            "drqn.min_episodes_for_training_start=1", "drqn.ring_len=256",
            "drqn.pallas_tile_rows=32", "drqn.max_episode_steps=128",
            "drqn.selfplay.episodes_per_generation=40",
            "drqn.selfplay.eval_episodes=16",
            "drqn.selfplay.curr_win_threshold=0.0",
            "drqn.selfplay.pool_win_threshold=0.0"]


@pytest.mark.parametrize("args,prefix,log,tier", [
    (QNET_CLI, "dqn", "train_qnet_metrics.jsonl", 0),
    (DRQN_CLI, "drqn", "train_rnn_metrics.jsonl", 1)])
def test_cli_autosaves_at_the_shipped_interval_and_resumes(tmp_path, args,
                                                           prefix, log, tier):
    cfg = load_config(args[2])
    assert getattr(cfg, prefix).save_latest_checkpoint_interval_steps == 10000
    base = args[:1] + ["--workdir", str(tmp_path)] + args[1:]
    assert cli.main(base + [f"{prefix}.selfplay.max_generations=1"]) == 0
    ev = events(tmp_path / log)
    assert ev[-1]["event"] == "autosave"      # the final full state
    assert cli.main(base + [f"{prefix}.selfplay.max_generations=2"]) == 0
    ev = events(tmp_path / log)[len(ev):]
    assert ev[0]["event"] == "restore" and ev[0]["tier"] == tier
    assert [e["generation"] for e in ev if e["event"] == "promoted"] == [2]
    sub = "checkpoints" if prefix == "dqn" else "checkpoints_rnn"
    names = [p.name for p in list_checkpoints(tmp_path / sub)]
    assert len(names) == 2 and names[-1].endswith("2")


@pytest.mark.parametrize("kind", ["qnet", "rnn"])
def test_stall_bench_measures_on_the_cpu(tmp_path, kind):
    from pingpong_tpu_torch.bench import dqn_setup
    from pingpong_tpu_torch.tools import autosave_stall_bench as sb

    if kind == "qnet":
        setup = dqn_setup(0, "cpu", num_envs=256, rollout_length=16,
                          updates=2, batch_size=128, memory_size=16384)
    else:
        env, cfg = drqn_cfg()
        path = tmp_path / "rnn.yaml"
        path.write_text(
            "drqn:\n" + "".join(
                f"  {k}: {getattr(cfg, k)}\n" for k in (
                    "feature_dim", "lstm_hidden_dim", "head_hidden_dim",
                    "trace_length", "num_envs", "rollout_length",
                    "updates_per_iteration", "batch_size", "ring_len",
                    "pallas_tile_rows", "min_episodes_for_training_start",
                    "max_episode_steps")))
        setup = sb.rnn_setup("cpu", path)
    out = sb.measure(*setup, tmp_path, n_iters=3, trials=1, warm_iters=20)
    assert out["sync_save_s"] > 0 and out["async_call_s"] > 0
    assert (len(out["window_plain_s"]) == len(out["window_with_save_s"])
            == len(out["stall_paired_s"]) == 1)
    assert out["updates_in_windows"] > 0
    assert out["state_bytes"] > sum(
        v.numel() * 4 for v in flatten_tree(setup[1]).values()
        if isinstance(v, torch.Tensor) and v.dim() == 3)
