"""PyTorch port: the DQN learner's scan rollout and the rest of its
non-fused routes against the JAX package on the CPU: the scan rollout
against ``DQNLearner._rollout`` with ``use_pallas_rollout=false`` on a
horizon with no randomness, its per-step epsilon and re-binding, sorted
binding, ``bot_qnet_params``, the one-shard warning, ``cli train`` on the
new routes and a kill-and-resume run on the row layout."""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.checkpoint.serialize import qnet_from_dict as jfrom_dict
from pingpong_tpu.config import load_config as jload_config
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.qnet import bot_qnet_params as jbot
from pingpong_tpu.models.qnet import qnet_apply as japply
from pingpong_tpu.selfplay.pool import load_params_any as jload_params
from pingpong_tpu.train.dqn import DQNLearner as JDQNLearner
from pingpong_tpu.train.dqn import bucketed_covers_pool as jcovers
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.checkpoint.serialize import qnet_from_numpy
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.models.policy import (
    ball_follower_action,
    qnet_act_greedy,
)
from pingpong_tpu_torch.models.qnet import bot_qnet_params
from pingpong_tpu_torch.ops.actor_rollout import actor_rollout, pack_qnet
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.train.dqn import (
    ONE_SHARD_WARNING,
    DQNLearner,
    bucketed_covers_pool,
)
from tests.test_torch_autosave import assert_same, driver, whole
from tests.test_torch_learner import np_qnet

CONFIG = "configs/qnet.yaml"
B, T, CAP = 128, 16, 4096


def small(**kw):
    return {**dict(num_envs=B, rollout_length=T, batch_size=96,
                   memory_size=CAP, pallas_tile_rows=128,
                   updates_per_iteration=6), **kw}


# ---------------------------------------------------------------------------
# the scan rollout
# ---------------------------------------------------------------------------

def zero_sigma(d):
    for head in ("fc_v", "fc_a"):
        for f in ("w_sigma", "b_sigma"):
            d[head][f] = np.zeros_like(d[head][f])
    return d


def test_scan_rollout_matches_jax_on_a_deterministic_horizon():
    """Zero sigmas, epsilon 0 and no episode end in the chunk: the
    rollout has no randomness, so both packages must agree exactly."""
    rng = np.random.default_rng(31)
    pb, pa, pm = zero_sigma(np_qnet(rng)), np_qnet(rng), np_qnet(rng)
    over = small(use_pallas_rollout=False, rollout_length=12, min_epsilon=0.0)
    cfg = load_config(CONFIG)
    learner = DQNLearner(cfg.env, dataclasses.replace(cfg.dqn, **over),
                         device="cpu")
    st = learner.init_state(3, qnet_from_numpy(pb), epsilon=0.0)
    opp0 = rng.integers(0, 3, B).astype(np.int32)
    st.opp_idx = torch.from_numpy(opp0.copy())
    env_np = {f: getattr(st.env_state, f).numpy().copy()
              for f in st.env_state._fields}
    opp = learner.prepare_opponents([qnet_from_numpy(d)
                                     for d in (pa, pm, pa)])
    counts, ret_sum = learner._rollout(st, opp, 2)

    jcfg = jload_config(CONFIG)
    jl = JDQNLearner(jcfg.env, dataclasses.replace(jcfg.dqn, **over))
    jst = jl.init_state(jax.random.PRNGKey(0), jfrom_dict(pb), epsilon=0.0)
    jst = jst._replace(
        env_state=jpong.EnvState(**{f: jnp.asarray(v)
                                    for f, v in env_np.items()}),
        opp_idx=jnp.asarray(opp0))
    members = [jfrom_dict(d) for d in (pa, pm, pa)]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    jst2, stats, jret = jax.jit(jl._rollout)(jst, jstack, jnp.int32(2))

    assert not jst2.buffer.done.any() and counts == [0, 0, 0, 0]
    np.testing.assert_array_equal(np.asarray(stats), counts)
    for f in env_np:
        a = np.asarray(getattr(jst2.env_state, f))
        got = getattr(st.env_state, f).numpy()
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(got, a, err_msg=f)
        else:
            np.testing.assert_allclose(got, a, rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(st.opp_idx.numpy(), np.asarray(jst2.opp_idx))
    np.testing.assert_allclose(st.ep_return.numpy(),
                               np.asarray(jst2.ep_return), atol=1e-5)
    assert st.epsilon == float(jst2.epsilon) == 0.0
    n = B * 12
    rows = st.buffer.data[:n].numpy()
    jrows = np.asarray(jst2.buffer.data)[:n]
    np.testing.assert_array_equal(rows[:, 14], jrows[:, 14])   # actions
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=1e-5)
    assert len(set(rows[:, 14].tolist())) == 3     # the policies act


def scan_learner(**kw):
    cfg = load_config(CONFIG)
    env = dataclasses.replace(cfg.env, max_episode_steps=kw.pop("cap", 3))
    return DQNLearner(env, dataclasses.replace(
        cfg.dqn, **small(use_pallas_rollout=False, **kw)), device="cpu")


def test_scan_epsilon_decays_per_step_over_its_own_dones():
    learner = scan_learner(num_envs=128, rollout_length=16,
                           epsilon_decay=0.997, min_epsilon=0.2)
    st = learner.init_state(4, epsilon=0.9)
    opp = learner.prepare_opponents([learner.params_b(st)])
    want = torch.tensor(0.9, dtype=torch.float32)
    decay = torch.tensor(0.997, dtype=torch.float32)
    for _ in range(3):
        learner._rollout(st, opp, 0)
        pos = st.buffer.pos or st.buffer.capacity
        done = st.buffer.data[pos - 128 * 16:pos, 16].view(16, 128)
        for t in range(16):
            want = torch.maximum(torch.tensor(0.2), want * decay
                                 ** done[t].sum())
        assert st.epsilon == float(want)
    assert st.epsilon == pytest.approx(0.2)   # reached the floor


def test_scan_rebinds_each_ended_env_iid():
    """Every env ends every 3 steps and re-binds: the pool share of the
    bindings within 3 sigma of ``opponent_pool_ratio``, the members
    uniform; the JAX rule's draws from its own key land within the same
    bounds."""
    learner = scan_learner(num_envs=2048, rollout_length=8,
                           memory_size=16384)
    ratio = learner.cfg.selfplay.opponent_pool_ratio
    st = learner.init_state(5)
    P = 4
    opp = learner.prepare_opponents([learner.params_b(st)] * (P + 1))
    binds = []
    for _ in range(6):
        learner._rollout(st, opp, P)
        binds.append(st.opp_idx.clone())
    idx = torch.cat(binds).numpy()
    n = idx.size
    key = jax.random.PRNGKey(1)
    kg, kp = jax.random.split(key)
    use = np.asarray(jax.random.uniform(kg, (n,)) < ratio)
    pick = np.asarray(jax.random.randint(kp, (n,), 0, P))
    jidx = np.where(use, pick + 1, 0)
    for draws in (idx, jidx):
        share = (draws > 0).mean()
        assert abs(share - ratio) < 3 * np.sqrt(ratio * (1 - ratio) / n)
        k = (draws > 0).sum()
        counts = np.bincount(draws[draws > 0], minlength=P + 1)[1:]
        sd = np.sqrt(k * (1 / P) * (1 - 1 / P))
        assert np.all(np.abs(counts - k / P) < 3 * sd), counts


def test_sorted_binding_sorts_the_envs_by_slot():
    """``opponent_binding="sorted"`` on the kernel route: the ended envs
    draw iid (pool share and members within 3 sigma), the envs are sorted
    by slot before the chunk (stable), and the chunk is the kernel's on
    the permuted inputs."""
    cfg = load_config(CONFIG)
    over = dict(num_envs=512, rollout_length=4, batch_size=128,
                memory_size=16384, pallas_tile_rows=128,
                opponent_binding="sorted")
    learner = DQNLearner(cfg.env, dataclasses.replace(cfg.dqn, **over),
                         device="cpu")
    ratio = cfg.dqn.selfplay.opponent_pool_ratio
    st = learner.init_state(6)
    P = 3
    opp = learner.prepare_opponents([learner.params_b(st)] * (P + 1))
    draws = []
    for _ in range(8):
        st.ended = torch.ones(512, dtype=torch.bool)
        gen_state = st.generator.get_state()
        env0, ret0, eps0 = st.env_state, st.ep_return.clone(), st.epsilon
        learner._rollout(st, opp, P)
        # the same draws, by hand: iid, then a stable sort by slot
        g = torch.Generator()
        g.set_state(gen_state)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=g))
        use = torch.rand((512,), generator=g) < ratio
        pick = torch.randint(0, P, (512,), generator=g, dtype=torch.int32)
        drawn = torch.where(use, pick + 1, 0).to(torch.int32)
        perm = torch.sort(drawn, stable=True).indices
        assert torch.equal(st.opp_idx, drawn[perm])
        assert bool((st.opp_idx[1:] >= st.opp_idx[:-1]).all())
        want = actor_rollout(
            learner.env_params, type(env0)(*(x[perm] for x in env0)),
            drawn[perm], ret0[perm], pack_qnet(learner.params_b(st)),
            opp.packed, seed=seed, epsilon=eps0, steps=4,
            max_episode_steps=cfg.env.max_episode_steps, tile_rows=128)
        draws.append(drawn.numpy())
        assert all(torch.equal(a, b) for a, b in zip(st.env_state, want[0]))
        assert torch.equal(st.ep_return, want[2])
    d = np.concatenate(draws)
    share = (d > 0).mean()
    assert abs(share - ratio) < 3 * np.sqrt(ratio * (1 - ratio) / d.size)
    counts = np.bincount(d[d > 0], minlength=P + 1)[1:]
    k = counts.sum()
    assert np.all(np.abs(counts - k / P) < 3 * np.sqrt(k / P * (1 - 1 / P)))


@pytest.mark.parametrize("n,ratio,members", [(64, 0.33, 16), (4096, 0.33, 16),
                                             (10, 0.5, 6)])
def test_bucketed_covers_pool_matches_jax(n, ratio, members):
    assert bucketed_covers_pool(n, ratio, members) == jcovers(n, ratio,
                                                              members)


# ---------------------------------------------------------------------------
# the bot as QNet weights, the one-shard warning
# ---------------------------------------------------------------------------

def test_bot_qnet_params_match_jax_and_the_ball_follower():
    jp = jbot(0.02)
    tp = bot_qnet_params(0.02)
    for name, p in tp.named_parameters():
        node = jp
        for part in name.split("."):
            node = getattr(node, part)
        np.testing.assert_array_equal(p.numpy(), np.asarray(node), name)
    obs = np.random.default_rng(2).uniform(
        [0, 0, -0.06, -0.06, 0, 0, -5], [1, 1, 0.06, 0.06, 1, 1, 5],
        (4096, 7)).astype(np.float32)
    got = qnet_act_greedy(tp, torch.from_numpy(obs))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.argmax(japply(jp, jnp.asarray(obs)), -1)))
    np.testing.assert_array_equal(
        got.numpy(), ball_follower_action(torch.from_numpy(obs)).numpy())


def test_one_shard_sharded_learner_warns_as_jax_and_runs():
    jcfg = jload_config(CONFIG)
    with pytest.warns(UserWarning, match="one data shard") as jw:
        JDQNLearner(jcfg.env, dataclasses.replace(
            jcfg.dqn, learner_sharding="sharded"))
    cfg = load_config(CONFIG)
    over = small(learner_sharding="sharded")
    with pytest.warns(UserWarning, match="one data shard") as tw:
        learner = DQNLearner(cfg.env, dataclasses.replace(cfg.dqn, **over),
                             device="cpu")
    assert str(tw[0].message) == str(jw[0].message) == ONE_SHARD_WARNING
    st = learner.init_state(0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, m = learner.train_iteration(
            st, learner.prepare_opponents([learner.params_b(st)]), 0)
    assert m.env_steps == B * T and st.buffer.size == B * T


# ---------------------------------------------------------------------------
# the entry point and a resume on the new routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["dqn.use_pallas_rollout=false", "dqn.use_pallas_update=false"],
    ["dqn.use_pallas_update=false", "dqn.opponent_binding=sorted"],
])
def test_cli_train_cpu_new_routes_promote_and_jax_loads(tmp_path, capsys,
                                                        flags):
    args = ["train", "--config", CONFIG, "--workdir", str(tmp_path),
            "--device", "cpu", "--seed", "4", "dqn.num_envs=128",
            "dqn.rollout_length=16", "dqn.updates_per_iteration=2",
            "dqn.batch_size=100", "dqn.memory_size=10000",
            "dqn.pallas_tile_rows=128", "dqn.selfplay.max_generations=1",
            "dqn.selfplay.episodes_per_generation=1",
            "dqn.selfplay.eval_episodes=8",
            "dqn.selfplay.curr_win_threshold=0.0",
            "dqn.selfplay.pool_win_threshold=0.0",
            "dqn.save_latest_checkpoint_interval_steps=0",
            "env.max_episode_steps=64", *flags]
    assert cli.main(args) == 0
    out = capsys.readouterr()
    assert "done: 1/1 generations promoted" in out.out
    assert "update autodiff, replay row layout" in out.err
    ckpt = tmp_path / "checkpoints" / "model5-1"
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["tree"]["model_kind"]["value"] == "qnet"
    obs = np.random.default_rng(5).uniform(
        [0, 0, -0.06, -0.06, 0, 0, -5], [1, 1, 0.06, 0.06, 1, 1, 5],
        (4096, 7)).astype(np.float32)
    want = np.asarray(jnp.argmax(japply(jload_params(ckpt),
                                        jnp.asarray(obs)), -1))
    got = qnet_act_greedy(load_params_any(ckpt), torch.from_numpy(obs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_layout_straight_run_equals_kill_and_resume(tmp_path):
    kw = dict(use_pallas_rollout=False, use_pallas_update=False)
    straight = driver("qnet", tmp_path / "straight", **kw)
    assert not straight.state.buffer.is_block
    straight.current_generation = 1
    straight._train_block(8)
    straight._train_block(8)
    first = driver("qnet", tmp_path / "resumed", **kw)
    first.current_generation = 1
    first._train_block(8)
    first.autosave(wait=True)
    del first
    second = driver("qnet", tmp_path / "resumed", seed=123, **kw)
    second._train_block(8)
    assert second.state.train_steps > 0
    assert_same(whole(straight), whole(second))
