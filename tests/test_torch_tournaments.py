"""PyTorch port: the tournaments (``evaluation/registry.py``,
``round_robin.py``, ``arena.py``, ``cli round-robin``, ``cli arena``)
held to the JAX package's (tests/test_tournaments.py): the same CSV
headers and JSON database, batched pairings bit-identical to sequential
ones, a resumable arena (``--save-every`` kill and resume, incremental
registration, a JAX-written database resumed with 0 pairings), and plots
that only warn when matplotlib is missing."""

import dataclasses
import sys

import jax
import pytest
import torch

from pingpong_tpu.checkpoint.serialize import qnet_rnn_to_dict as jrnn_dict
from pingpong_tpu.checkpoint.serialize import qnet_to_dict as jqnet_dict
from pingpong_tpu.checkpoint.store import save_checkpoint as jsave
from pingpong_tpu.config import EnvConfig as JEnvConfig
from pingpong_tpu.config import ExperimentConfig as JExperimentConfig
from pingpong_tpu.evaluation.arena import run_arena as jrun_arena
from pingpong_tpu.evaluation.round_robin import run_round_robin as jrun_rr
from pingpong_tpu.models import qnet_init as jqnet_init
from pingpong_tpu.models import qnet_rnn_init as jrnn_init
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.config import EnvConfig, ExperimentConfig
from pingpong_tpu_torch.env.pong import env_params_from_config
from pingpong_tpu_torch.evaluation.arena import (
    create_match_plan,
    load_database,
    register_models,
    run_arena,
    run_tournament,
    save_database,
)
from pingpong_tpu_torch.evaluation.registry import MatchRunner, discover_models
from pingpong_tpu_torch.evaluation.round_robin import run_round_robin


def make_ckpts(tmp_path, rnn=True):
    """Two QNets and (``rnn``) a QNetRNN, written by the JAX package."""
    d = tmp_path / "ckpts"
    for i in (1, 2):
        jsave(d / f"model5-{i}", {"params_b": jqnet_dict(
            jqnet_init(jax.random.PRNGKey(i - 1)))})
    if rnn:
        jsave(d / "rnn_1", {"params_b": jrnn_dict(jrnn_init(
            jax.random.PRNGKey(2), feature_dim=32, lstm_hidden_dim=16,
            head_hidden_dim=16))})
    return d


def small_cfg():
    return dataclasses.replace(ExperimentConfig(),
                               env=EnvConfig(max_episode_steps=200))


def read_csv(path):
    lines = path.read_text().splitlines()
    return lines[0].split(","), [ln.split(",") for ln in lines[1:]]


def test_round_robin_outputs_and_jax_csv_headers(tmp_path):
    d = make_ckpts(tmp_path)
    out = tmp_path / "results"
    assert run_round_robin(small_cfg(), d, out, episodes_per_match=4,
                           include_bot=True, seed=0, device="cpu") == 0
    files = sorted(p.name for p in out.iterdir())
    for prefix in ("match_records_", "summary_ranking_", "win_rates_",
                   "h2h_heatmap_"):
        assert any(f.startswith(prefix) for f in files), prefix
    head, rows = read_csv(next(out.glob("match_records_*.csv")))
    assert len(rows) == 6 * 4      # C(4, 2) pairs x 4 games
    s_head, s_rows = read_csv(next(out.glob("summary_ranking_*.csv")))
    assert len(s_rows) == 4 and all(r[4] == "12" for r in s_rows)
    # the JAX package's round-robin on two of the models: the same headers
    jout = tmp_path / "jax_results"
    jcfg = dataclasses.replace(JExperimentConfig(),
                               env=JEnvConfig(max_episode_steps=200))
    assert jrun_rr(jcfg, make_ckpts(tmp_path / "j", rnn=False), jout,
                   episodes_per_match=2, include_bot=False) == 0
    assert head == read_csv(next(jout.glob("match_records_*.csv")))[0]
    assert s_head == read_csv(next(jout.glob("summary_ranking_*.csv")))[0]


def test_batched_pairs_bit_identical_to_sequential(tmp_path):
    entries = discover_models([make_ckpts(tmp_path)], include_bot=True)
    assert [e.kind for e in entries] == [0, 0, 1, 2]
    env_params = env_params_from_config(EnvConfig(max_episode_steps=200))
    jobs = [(entries[i], entries[j], 4 + i)
            for i in range(len(entries)) for j in range(len(entries))
            if i != j]
    batched = MatchRunner(env_params, device="cpu").play_pairs_batched(
        jobs, torch.Generator().manual_seed(42))
    runner = MatchRunner(env_params, device="cpu")
    gen = torch.Generator().manual_seed(42)
    for (a, b, n), (_, _, res_b) in zip(jobs, batched):
        seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        res_s = runner.play(a, b, n, seed)
        for x, y in zip(res_b, res_s):
            assert torch.equal(x, y)


def test_round_robin_swap_sides_batched(tmp_path):
    out = tmp_path / "rr_swap"
    assert run_round_robin(small_cfg(), make_ckpts(tmp_path), out,
                           episodes_per_match=4, include_bot=False,
                           swap_sides=True, device="cpu") == 0
    _, rows = read_csv(next(out.glob("match_records_*.csv")))
    assert len({(r[0], r[1]) for r in rows}) == 2 * 3


def test_arena_resumes_with_zero_pairings(tmp_path, capsys):
    d = make_ckpts(tmp_path)
    db = tmp_path / "arena_database.json"
    out = tmp_path / "results_arena"
    assert run_arena(small_cfg(), d, db, out, episodes_per_match=3,
                     include_bot=False, seed=0, device="cpu") == 0
    data = load_database(db)
    assert len(data["models"]) == 3
    assert len(data["match_history"]) == 3 * 3
    assert set(data["match_history"][0]) == {
        "p1", "p2", "winner", "p1_score", "p2_score", "timestamp"}
    assert set(data["models"][2]) == {"id", "type", "path", "description"}
    assert data["models"][2]["type"] == "QNetRNN"
    capsys.readouterr()
    assert run_arena(small_cfg(), d, db, out, episodes_per_match=3,
                     include_bot=False, seed=1, device="cpu") == 0
    assert "3 models, 0 pairings with 0 games remaining" in \
        capsys.readouterr().out
    assert len(load_database(db)["match_history"]) == 9
    assert all(p["episodes_to_run"] == 2
               for p in create_match_plan(load_database(db), 5))
    assert run_arena(small_cfg(), d, db, out, episodes_per_match=5,
                     include_bot=False, seed=1, device="cpu") == 0
    assert len(load_database(db)["match_history"]) == 3 * 5


def test_arena_save_every_kill_and_resume(tmp_path):
    d = make_ckpts(tmp_path)
    db = tmp_path / "arena_database.json"
    database = load_database(db)
    found = discover_models([d], include_bot=False)
    register_models(database, [
        {"id": e.id, "type": e.type_name, "path": e.path} for e in found])
    save_database(db, database)
    plan = create_match_plan(database, 4)       # 3 pairs x 4 games

    runner = MatchRunner(env_params_from_config(small_cfg().env),
                         device="cpu")
    real_play = runner.play_pairs_batched
    calls = {"n": 0}

    def dying_play(jobs, generator):
        if calls["n"] >= 2:                      # die on the third slice
            raise KeyboardInterrupt("simulated crash")
        calls["n"] += 1
        return real_play(jobs, generator)

    runner.play_pairs_batched = dying_play
    with pytest.raises(KeyboardInterrupt):
        run_tournament(runner, database, db, plan, torch.Generator(),
                       save_every=2)
    on_disk = load_database(db)
    assert len(on_disk["match_history"]) == 4  # two slices of 2 survived

    runner.play_pairs_batched = real_play
    plan = create_match_plan(on_disk, 4)
    assert sum(p["episodes_to_run"] for p in plan) == 8
    run_tournament(runner, on_disk, db, plan,
                   torch.Generator().manual_seed(1), save_every=2)
    final = load_database(db)
    assert len(final["match_history"]) == 12
    assert create_match_plan(final, 4) == []

    # save_every=1: every batched match plays one game
    ones = tmp_path / "db_ones.json"
    db1 = load_database(ones)
    register_models(db1, [
        {"id": e.id, "type": e.type_name, "path": e.path} for e in found])
    save_database(ones, db1)
    seen = []
    runner.play_pairs_batched = lambda jobs, g: (
        seen.extend(m for _, _, m in jobs) or real_play(jobs, g))
    run_tournament(runner, db1, ones, create_match_plan(db1, 2),
                   torch.Generator().manual_seed(2), save_every=1)
    assert seen == [1] * 6
    assert len(load_database(ones)["match_history"]) == 6


def test_arena_registers_new_models_incrementally(tmp_path):
    d = make_ckpts(tmp_path)
    db = tmp_path / "db.json"
    out = tmp_path / "res"
    run_arena(small_cfg(), d, db, out, episodes_per_match=2,
              include_bot=False, seed=0, device="cpu")
    n_before = len(load_database(db)["match_history"])
    jsave(d / "model5-3", {"params_b": jqnet_dict(
        jqnet_init(jax.random.PRNGKey(9)))})
    run_arena(small_cfg(), d, db, out, episodes_per_match=2,
              include_bot=False, seed=1, device="cpu")
    data = load_database(db)
    assert len(data["models"]) == 4
    assert len(data["match_history"]) == n_before + 3 * 2


def test_a_jax_arena_database_resumes_with_zero_pairings(tmp_path, capsys):
    d = make_ckpts(tmp_path, rnn=False)
    db = tmp_path / "arena_database.json"
    jcfg = dataclasses.replace(JExperimentConfig(),
                               env=JEnvConfig(max_episode_steps=200))
    assert jrun_arena(jcfg, d, db, tmp_path / "jax_res",
                      episodes_per_match=3, include_bot=True, seed=0) == 0
    history = load_database(db)["match_history"]
    capsys.readouterr()
    assert cli.main(["arena", "--device", "cpu", "--ckpt-dir", str(d),
                     "--db", str(db), "--out", str(tmp_path / "res"),
                     "--episodes", "3"]) == 0
    assert "3 models, 0 pairings with 0 games remaining" in \
        capsys.readouterr().out
    assert load_database(db)["match_history"] == history


def test_cli_round_robin_and_arena(tmp_path, capsys):
    d = make_ckpts(tmp_path)
    assert cli.main(["round-robin", "--device", "cpu", "--ckpt-dir", str(d),
                     "--out", str(tmp_path / "rr"), "--episodes", "2",
                     "--no-bot"]) == 0
    out = capsys.readouterr().out
    assert "[round-robin] 6 games in" in out and "games/s" in out
    for _ in range(2):
        assert cli.main(["arena", "--device", "cpu", "--ckpt-dir", str(d),
                         "--db", str(tmp_path / "db.json"), "--out",
                         str(tmp_path / "ar"), "--episodes", "2",
                         "--swap-sides"]) == 0
    assert "0 pairings" in capsys.readouterr().out.splitlines()[-6]


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_missing_matplotlib_only_warns(tmp_path, capsys, no_matplotlib):
    out = tmp_path / "rr"
    assert run_round_robin(small_cfg(), make_ckpts(tmp_path), out,
                           episodes_per_match=2, include_bot=False,
                           device="cpu") == 0
    assert "[warn] plot failed" in capsys.readouterr().err
    assert not list(out.glob("*.png"))
    assert list(out.glob("summary_ranking_*.csv"))
    assert cli.main([
        "train", "--device", "cpu", "--config", "configs/qnet.yaml",
        "--workdir", str(tmp_path / "w"), "dqn.num_envs=256",
        "dqn.rollout_length=16", "dqn.batch_size=128",
        "dqn.updates_per_iteration=2", "dqn.use_pallas_eval=false",
        "dqn.memory_size=16384", "dqn.pallas_tile_rows=128",
        "dqn.selfplay.max_generations=1",
        "dqn.selfplay.episodes_per_generation=4",
        "dqn.selfplay.eval_episodes=8", "env.max_episode_steps=64"]) == 0
    assert "[warn] plot failed" in capsys.readouterr().err


def test_train_draws_its_plots(tmp_path):
    pytest.importorskip("matplotlib")
    assert cli.main([
        "train-rnn", "--device", "cpu", "--config", "configs/rnn.yaml",
        "--workdir", str(tmp_path), "drqn.feature_dim=32",
        "drqn.lstm_hidden_dim=16", "drqn.head_hidden_dim=16",
        "drqn.trace_length=4", "drqn.num_envs=32", "drqn.rollout_length=32",
        "drqn.updates_per_iteration=2", "drqn.batch_size=8",
        "drqn.min_episodes_for_training_start=1", "drqn.ring_len=128",
        "drqn.pallas_tile_rows=32", "drqn.max_episode_steps=128",
        "drqn.use_pallas_eval=false", "drqn.selfplay.max_generations=1",
        "drqn.selfplay.episodes_per_generation=16",
        "drqn.selfplay.eval_episodes=8"]) == 0
    assert (tmp_path / "plot_rnn" / "training_rnn_rewards.png").is_file()
