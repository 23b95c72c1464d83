"""PyTorch port: the batched match runner (``evaluation/match.py``)
against the JAX package's ``make_match_fn``, and the generation loops'
match-runner gates (``use_pallas_eval=false``).

Initial states come from the JAX ``reset`` on keys and are carried over;
parameters are carried over with ``qnet_from_numpy`` /
``qnet_rnn_from_numpy``. For every pair of seat kinds (QNet, QNetRNN,
bot), scores, wins, draws and steps must be exactly equal. The
side-balanced split must call the match function as JAX does, and gate
win rates on the same checkpoint pair, each side from its own random
serves, must agree within 4 binomial sigma."""

import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config import EnvConfig as JEnvConfig
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.evaluation import match as jm
from pingpong_tpu.models import qnet_init as jqnet_init
from pingpong_tpu.models import qnet_rnn_init as jrnn_init
from pingpong_tpu.selfplay.pool import load_params_any as jload
from pingpong_tpu_torch.checkpoint.serialize import (
    qnet_from_numpy,
    qnet_rnn_from_numpy,
)
from pingpong_tpu_torch.config import EnvConfig, load_config
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.evaluation import match as tm
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.utils.metrics import MetricsLogger

DEMO = Path(__file__).resolve().parent.parent / "demo" / "checkpoints"
N = 32
JENV = jpong.env_params_from_config(JEnvConfig())
TENV = tpong.env_params_from_config(EnvConfig())


def jax_stack(params):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)


def sides():
    """Per kind: (JAX stack, port stack, slots)."""
    qs = [jqnet_init(jax.random.PRNGKey(i)) for i in range(3)]
    rs = [jrnn_init(jax.random.PRNGKey(10 + i), feature_dim=32,
                    lstm_hidden_dim=16, head_hidden_dim=16) for i in range(2)]
    return {
        tm.QNET: (jax_stack(qs), [qnet_from_numpy(jax.device_get(q))
                                  for q in qs], 3),
        tm.RNN: (jax_stack(rs), [qnet_rnn_from_numpy(jax.device_get(r))
                                 for r in rs], 2),
        tm.BOT: (None, None, 1),
    }


def jax_resets(seed, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    st = jax.vmap(jpong.reset, in_axes=(None, 0))(JENV, keys)
    port = tpong.EnvState(*(torch.from_numpy(np.array(getattr(st, f)))
                            for f in tpong.EnvState._fields))
    return keys, port


def assert_results_equal(jres, tres):
    for f in jres._fields:
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)),
                                      err_msg=f)


KINDS = {"qnet": tm.QNET, "rnn": tm.RNN, "bot": tm.BOT}


@pytest.mark.parametrize("kind_b", sorted(KINDS))
@pytest.mark.parametrize("kind_a", sorted(KINDS))
def test_match_equals_jax_for_every_pair_of_seats(kind_a, kind_b):
    ka, kb = KINDS[kind_a], KINDS[kind_b]
    s = sides()
    rng = np.random.default_rng(ka * 3 + kb)
    idx_a = rng.integers(0, s[ka][2], N).astype(np.int32)
    idx_b = rng.integers(0, s[kb][2], N).astype(np.int32)
    keys, state = jax_resets(ka * 3 + kb, N)
    jres = jm.make_match_fn(JENV, jm.PolicySpec(ka, None),
                            jm.PolicySpec(kb, None), max_steps=800)(
        s[ka][0], s[kb][0], jnp.asarray(idx_a), jnp.asarray(idx_b), keys)
    tres = tm.make_match_fn(TENV, tm.PolicySpec(ka, None),
                            tm.PolicySpec(kb, None), max_steps=800,
                            device="cpu")(
        s[ka][1], s[kb][1], torch.from_numpy(idx_a), torch.from_numpy(idx_b),
        env_state=state)
    assert_results_equal(jres, tres)
    assert bool(tres.steps.min() > 0)


@pytest.mark.parametrize("max_steps,check_every", [(37, 16), (64, 1)])
def test_unfinished_games_count_max_steps_as_in_jax(max_steps, check_every):
    """The stop test runs every ``check_every`` steps, yet no game steps
    past ``max_steps``; games still running there are decided by score."""
    s = sides()
    keys, state = jax_resets(5, N)
    idx = np.zeros(N, np.int32)
    jres = jm.make_match_fn(JENV, jm.PolicySpec(tm.BOT, None),
                            jm.PolicySpec(tm.QNET, None),
                            max_steps=max_steps)(
        None, s[tm.QNET][0], jnp.asarray(idx), jnp.asarray(idx), keys)
    tres = tm.make_match_fn(TENV, tm.PolicySpec(tm.BOT, None),
                            tm.PolicySpec(tm.QNET, None), max_steps=max_steps,
                            check_every=check_every, device="cpu")(
        None, s[tm.QNET][1], torch.from_numpy(idx), torch.from_numpy(idx),
        env_state=state)
    assert_results_equal(jres, tres)
    assert int(tres.steps.max()) == max_steps


def test_resets_come_from_the_generator():
    s = sides()
    fn = tm.make_match_fn(TENV, tm.PolicySpec(tm.QNET, None),
                          tm.PolicySpec(tm.BOT, None), device="cpu")
    idx = torch.zeros(N, dtype=torch.int32)
    a = fn(s[tm.QNET][1][:1], None, idx, idx,
           generator=torch.Generator().manual_seed(3))
    b = fn(s[tm.QNET][1][:1], None, idx, idx,
           env_state=tpong.reset(TENV, N, torch.Generator().manual_seed(3)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


class Recorder:
    """A match function that records its calls and returns fixed
    results: the top seat wins every game with an even index."""

    def __init__(self):
        self.calls = []

    def result(self, n):
        top = np.arange(n) % 2 == 0
        return dict(score_a=np.where(top, 3, 1), score_b=np.where(top, 1, 3),
                    win_a=top, win_b=~top, draw=np.zeros(n, bool),
                    steps=np.full(n, 9))

    def jax_fn(self, pa, pb, ia, ib, keys):
        self.calls.append((pa, pb, np.asarray(ia).tolist(),
                           np.asarray(ib).tolist(), len(keys)))
        return jm.MatchResult(**{k: jnp.asarray(v) for k, v in
                                 self.result(len(keys)).items()})

    def port_fn(self, pa, pb, ia, ib, generator=None, env_state=None):
        self.calls.append((pa, pb, ia.tolist(), ib.tolist(), len(ia)))
        return tm.MatchResult(**{k: torch.from_numpy(v) for k, v in
                                 self.result(len(ia)).items()})


@pytest.mark.parametrize("n_games", [10, 13])
def test_balanced_seat_split_matches_jax(n_games):
    idx_opp = np.arange(n_games, dtype=np.int32) % 3
    idx_l = np.zeros(n_games, np.int32)
    j, t = Recorder(), Recorder()
    want = jm.eval_win_rate_balanced(j.jax_fn, "opp", "learner",
                                     jnp.asarray(idx_opp), jnp.asarray(idx_l),
                                     jax.random.PRNGKey(0), n_games)
    got = tm.eval_win_rate_balanced(t.port_fn, "opp", "learner",
                                    torch.from_numpy(idx_opp),
                                    torch.from_numpy(idx_l),
                                    torch.Generator(), n_games)
    assert t.calls == j.calls
    assert got == pytest.approx(want, abs=0, rel=1e-12)


def binomial_close(p1, n1, p2, n2):
    sigma = math.sqrt(max(p1 * (1 - p1), p2 * (1 - p2), 1e-4)
                      * (1 / n1 + 1 / n2))
    return abs(p1 - p2) <= 4 * sigma


@pytest.mark.parametrize("balanced", [False, True])
def test_gate_win_rates_agree_with_jax(balanced):
    """B = model5-2 against A = model5-1 of the demo ladder, 256 games a
    side, each side from its own random serves."""
    n = 256
    ja, jb = jload(DEMO / "model5-1"), jload(DEMO / "model5-2")
    ta, tb = load_params_any(DEMO / "model5-1"), load_params_any(DEMO /
                                                                 "model5-2")
    jfn = jm.make_match_fn(JENV, jm.PolicySpec(jm.QNET, None),
                           jm.PolicySpec(jm.QNET, None))
    tfn = tm.make_match_fn(TENV, tm.PolicySpec(tm.QNET, None),
                           tm.PolicySpec(tm.QNET, None), device="cpu")
    zj, zt = jnp.zeros(n, jnp.int32), torch.zeros(n, dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    if balanced:
        want = jm.eval_win_rate_balanced(
            jfn, jax_stack([ja]), jax_stack([jb]), zj, zj,
            jax.random.PRNGKey(1), n)
        got = tm.eval_win_rate_balanced(tfn, [ta], [tb], zt, zt, gen, n)
        pairs = [(want[0], got[0], n), (want[1], got[1], n // 2),
                 (want[2], got[2], n // 2)]
    else:
        want, _ = jm.eval_win_rate(jfn, jax_stack([ja]), jax_stack([jb]), zj,
                                   zj, jax.random.PRNGKey(1), n)
        got, _ = tm.eval_win_rate(tfn, [ta], [tb], zt, zt, gen, n)
        pairs = [(want, got, n)]
    for w, g, m in pairs:
        assert binomial_close(w, m, g, m), (w, g)


def gate_driver(kind, tmp_path, swap):
    if kind == "qnet":
        cfg = load_config("configs/qnet.yaml")
        sp = dataclasses.replace(
            cfg.dqn.selfplay, max_generations=2, episodes_per_generation=8,
            eval_episodes=16, curr_win_threshold=0.0, pool_win_threshold=0.0,
            win_rate_interval=8, swap_sides_eval=swap)
        dq = dataclasses.replace(
            cfg.dqn, selfplay=sp, num_envs=256, rollout_length=16,
            updates_per_iteration=2, batch_size=128, memory_size=16384,
            pallas_tile_rows=128, use_pallas_eval=False,
            save_latest_checkpoint_interval_steps=0)
        cls, env = QNetSelfPlay, dataclasses.replace(cfg.env,
                                                     max_episode_steps=200)
    else:
        cfg = load_config("configs/rnn.yaml")
        sp = dataclasses.replace(
            cfg.drqn.selfplay, max_generations=2, episodes_per_generation=16,
            eval_episodes=8, curr_win_threshold=0.0, pool_win_threshold=0.0,
            win_rate_interval=8, swap_sides_eval=swap)
        dq = dataclasses.replace(
            cfg.drqn, selfplay=sp, feature_dim=32, lstm_hidden_dim=16,
            head_hidden_dim=16, trace_length=4, num_envs=32,
            rollout_length=32, updates_per_iteration=2, batch_size=8,
            ring_len=128, pallas_tile_rows=32,
            min_episodes_for_training_start=1, max_episode_steps=128,
            use_pallas_eval=False, save_latest_checkpoint_interval_steps=0)
        cls, env = DRQNSelfPlay, cfg.env
    log = tmp_path / "log.jsonl"
    return cls(env, dq, workdir=str(tmp_path), device="cpu",
               logger=MetricsLogger(str(log), echo=False)), log


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("kind", ["qnet", "drqn"])
def test_loop_gates_run_through_the_match_runner(tmp_path, kind, swap,
                                                 monkeypatch):
    """``use_pallas_eval=false`` runs the match runner, single-seat or
    side-balanced, and never the fused gates."""
    d, log = gate_driver(kind, tmp_path, swap)
    calls = []
    real = d.match_fn
    d.match_fn = lambda *a, **k: calls.append(len(a[2])) or real(*a, **k)
    # every fused gate of either family runs the one chunk loop
    fused = []
    monkeypatch.setattr(
        "pingpong_tpu_torch.evaluation.fast_eval._stream_chunks",
        lambda *a, **k: fused.append(a))
    records = d.run()
    assert fused == []
    assert [r.promoted for r in records] == [True, True]
    # A in both generations; the DRQN loop adds its promotion to the pool
    # (the QNet pool is loaded once, empty here)
    gates = 2 if kind == "qnet" else 3
    n = d.cfg.selfplay.eval_episodes
    per_call = [n // 2, n - n // 2] if swap else [n]
    assert calls == per_call * gates
    ev = [json.loads(x) for x in log.read_text().splitlines()]
    seats = [e for e in ev if e["event"] == "eval_seats"]
    assert len(seats) == (gates if swap else 0)
    for e in ev:
        if e["event"] == "eval":
            assert 0.0 <= e["win_vs_A"] <= 1.0 and e["eval_s"] > 0
