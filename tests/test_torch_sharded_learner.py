"""PyTorch port: the sharded learner layouts on gloo CPU processes against
the JAX sharded learners on a mesh of virtual CPU devices.

From the same pre-iteration state, one JAX train iteration of the sharded
DQN and DRQN learners (kernels 1 and 3 in interpret mode under
``shard_map``) and one port iteration on n ranks, with the rollout seed,
the update noise and every rank's sample draws recomputed from the JAX
state's key (``fold_in(k_u, s)`` / ``fold_in(k_samples, s)``): parameters,
target, Adam moments, priorities and chunk sums within the JAX test's
tolerances (rtol 2e-4, atol 1e-6; ``tests/test_sharded_learner.py``), the
ranks bit-equal to each other. Also the DRQN global admitted count
against the replicated learner, and the layout rule's warnings word for
word against the JAX learners'."""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh

from pingpong_tpu.checkpoint.serialize import qnet_rnn_to_dict as jrnn_dict
from pingpong_tpu.checkpoint.serialize import qnet_to_dict as jqnet_dict
from pingpong_tpu.config import DQNConfig as JDQNConfig
from pingpong_tpu.config import DRQNConfig as JDRQNConfig
from pingpong_tpu.config import EnvConfig as JEnvConfig
from pingpong_tpu.models.qnet import qnet_init as jqnet_init
from pingpong_tpu.models.qnet import qnet_sample_noise as jqnet_noise
from pingpong_tpu.models.qnet_rnn import qnet_rnn_sample_noise as jrnn_noise
from pingpong_tpu.train.dqn import DQNLearner as JDQNLearner
from pingpong_tpu.train.dqn import stack_opponents
from pingpong_tpu.train.drqn import DRQNLearner as JDRQNLearner
from pingpong_tpu.train.drqn import stack_rnn_opponents
from pingpong_tpu_torch.checkpoint.full_state import STATE_FILE
from pingpong_tpu_torch.config.schema import DQNConfig, DRQNConfig, EnvConfig
from pingpong_tpu_torch.parallel.mesh import create_mesh
from pingpong_tpu_torch.train import dqn as tdqn
from pingpong_tpu_torch.train import drqn as tdrqn
from tests.test_torch_dqn_rows import port_noise as dqn_port_noise
from tests.test_torch_drqn_autodiff import port_noise as rnn_port_noise
from tests.torch_dist import run_ranks

ENV = dict(max_episode_steps=128)
RTOL, ATOL = 2e-4, 1e-6
DQN = dict(num_envs=64, rollout_length=16, updates_per_iteration=4,
           batch_size=32, memory_size=8192, pallas_tile_rows=16,
           learner_sharding="sharded")
DRQN = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16,
            trace_length=4, num_envs=64, rollout_length=32,
            updates_per_iteration=4, batch_size=16,
            min_episodes_for_training_start=1, ring_len=512,
            pallas_tile_rows=16, learner_sharding="sharded")


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def common_leaves(st, opt_leaves):
    """The port's flat-state entries shared by both learners."""
    t = lambda x: torch.from_numpy(np.array(x))
    count, mu, nu = opt_leaves
    env = {f"env_state/{f}": t(getattr(st.env_state, f))
           for f in st.env_state._fields}
    return {"generator": torch.Generator().manual_seed(0).get_state(),
            "params": t(ravel_pytree(st.params_b)[0]),
            "target": t(ravel_pytree(st.target_b)[0]),
            "opt_count": int(count), "opt_mu": t(mu), "opt_nu": t(nu),
            **env, "opp_idx": t(st.opp_idx), "ep_return": t(st.ep_return),
            "ended": t(st.ended), "epsilon": float(st.epsilon),
            "train_steps": int(st.train_steps),
            "episodes": int(st.episodes)}


def save_state(flat, tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    torch.save(flat, d / STATE_FILE)
    return str(d)


def assert_close(got, want, key, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=key)


def assert_ranks_equal(res):
    for r in res[1:]:
        for k in ("params", "target", "opt_mu", "opt_nu"):
            assert torch.equal(r["local"][k], res[0]["local"][k]), k


def dqn_case(n, tmp_path):
    mesh = jax_mesh(n)
    jl = JDQNLearner(JEnvConfig(**ENV), JDQNConfig(**DQN), mesh=mesh)
    jl._pallas_interpret = True
    assert jl._learner_sharded
    a = jqnet_init(jax.random.PRNGKey(1))
    opp, pn = stack_opponents(a, [], 0)
    opp = jl.prepare_opponents(opp)
    state = jl.shard_state(jl.init_state(jax.random.PRNGKey(0)))
    for _ in range(2):
        state, _ = jl.train_iteration(state, opp, jnp.int32(pn))
    before = np_tree(state)
    state, m = jl.train_iteration(state, opp, jnp.int32(pn))
    got = np_tree(state)

    # the draws of _rollout_pallas and _push_update_sharded
    K, bs_l = DQN["updates_per_iteration"], DQN["batch_size"] // n
    key, k_seed, _, _ = jax.random.split(before.key, 4)
    seed = int(jax.random.randint(k_seed, (), 0, jnp.int32(2**31 - 1)))
    _, k_noise, k_u = jax.random.split(key, 3)
    jn = jax.vmap(lambda k: jqnet_noise(k, before.params_b))(
        jax.random.split(k_noise, K))
    u01 = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(k_u, s), (K, bs_l), jnp.float32))
        for s in range(n)])
    t = lambda x: torch.from_numpy(np.array(x))
    b = before.buffer
    flat = common_leaves(before, jax.tree_util.tree_leaves(before.opt_state))
    flat.update({"buffer/data": t(b.data), "buffer/prios": t(b.prios),
                 "buffer/p_alpha": t(b.p_alpha),
                 "buffer/chunk_sums": t(b.chunk_sums),
                 "buffer/pos": int(b.pos), "buffer/size": int(b.size),
                 "frame_idx": int(before.frame_idx)})
    res = run_ranks("learner", n, tmp_path, dict(
        kind="dqn", env=ENV, cfg=DQN, params=None, pool_size=0,
        opp=[jqnet_dict(np_tree(a))], iters=1,
        state_dir=save_state(flat, tmp_path, "dqn_before"),
        inject=[dict(seed=seed, u01=torch.from_numpy(u01),
                     noise=dqn_port_noise(jn))]))
    assert all(r["sharded"] for r in res)
    assert_ranks_equal(res)
    g = res[0]["global"]
    _, mu, nu = jax.tree_util.tree_leaves(got.opt_state)
    assert_close(g["params"], ravel_pytree(got.params_b)[0], "params")
    assert_close(g["target"], ravel_pytree(got.target_b)[0], "target")
    assert_close(g["opt_mu"], mu, "mu", atol=1e-7)
    assert_close(g["opt_nu"], nu, "nu", atol=1e-10)
    assert_close(g["buffer/prios"], got.buffer.prios, "prios", 1e-5, 1e-7)
    assert_close(g["buffer/chunk_sums"], got.buffer.chunk_sums,
                 "chunk_sums", 1e-4)
    np.testing.assert_array_equal(g["buffer/data"].numpy()[:, 14:],
                                  np.asarray(got.buffer.data)[:, 14:])
    assert g["train_steps"] == int(got.train_steps)
    assert g["frame_idx"] == int(got.frame_idx)
    assert g["episodes"] == int(got.episodes)
    mt = res[0]["metrics"][0]
    assert mt["buffer_size"] == int(m.buffer_size)
    np.testing.assert_allclose(mt["mean_loss"], float(m.mean_loss),
                               rtol=RTOL)
    # the replay is 1/n a rank
    assert res[0]["local"]["buffer/data"].shape[0] == DQN["memory_size"] // n


def rnn_leaves(st):
    """The DRQN state's own entries (hidden block, ring) on the port."""
    t = lambda x: torch.from_numpy(np.array(x))
    hb, ho = st.hid_b, st.hid_opp
    hid = np.concatenate([np.asarray(hb.h[0]).T, np.asarray(hb.c[0]).T,
                          np.asarray(ho.h[0]).T, np.asarray(ho.c[0]).T])
    b = st.buffer
    return {"hid": t(hid), "buffer/data": t(b._brf()),
            "buffer/ep_id": t(b.ep_id), "buffer/cursor": int(b.cursor),
            "buffer/ep_count": int(b.ep_count),
            "buffer/cur_ep_id": t(b.cur_ep_id),
            "buffer/cur_ep_len": t(b.cur_ep_len),
            **{f"buffer/{f}": t(getattr(b, f))
               for f in ("dir_env", "dir_start", "dir_len", "dir_id")},
            "buffer/dir_cursor": int(b.dir_cursor)}


def drqn_case(n, tmp_path):
    mesh = jax_mesh(n)
    jl = JDRQNLearner(JEnvConfig(**ENV), JDRQNConfig(**DRQN), mesh=mesh)
    jl._pallas_interpret = True
    assert jl._learner_sharded
    params = jl.init_params(jax.random.PRNGKey(0))
    opp, pn = stack_rnn_opponents(params, [])
    opp = jl.prepare_opponents(opp)
    state = jl.shard_state(jl.init_state(jax.random.PRNGKey(1), params))
    for _ in range(3):
        state, _ = jl.train_iteration(state, opp, jnp.int32(pn))
    before = np_tree(state)
    state, m = jl.train_iteration(state, opp, jnp.int32(pn))
    assert int(m.updates_run) == DRQN["updates_per_iteration"]
    got = np_tree(state)

    K, T = DRQN["updates_per_iteration"], DRQN["trace_length"]
    bs_l, B_l = DRQN["batch_size"] // n, DRQN["num_envs"] // n
    key, k_seed, _, _ = jax.random.split(before.key, 4)
    seed = int(jax.random.randint(k_seed, (), 0, jnp.int32(2**31 - 1)))
    key, k_noise = jax.random.split(key)
    jn = jax.vmap(lambda k: jrnn_noise(k, before.params_b))(
        jax.random.split(k_noise, K))
    _, k_samples = jax.random.split(key)
    cands = []
    for s in range(n):
        _, k_env, k_t = jax.random.split(jax.random.fold_in(k_samples, s), 3)
        m4 = 4 * K * bs_l
        env = jax.random.randint(k_env, (m4,), 0, B_l)
        t0 = jax.random.randint(k_t, (m4,), 0, DRQN["ring_len"] - T + 1)
        cands.append(tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                           for x in (env, t0)))
    flat = common_leaves(before, jax.tree_util.tree_leaves(before.opt_state))
    flat.update(rnn_leaves(before))
    res = run_ranks("learner", n, tmp_path, dict(
        kind="drqn", env=ENV, cfg=DRQN, params=jrnn_dict(np_tree(params)),
        pool_size=0, opp=[jrnn_dict(np_tree(params))], iters=1,
        state_dir=save_state(flat, tmp_path, "drqn_before"),
        inject=[dict(seed=seed, noise=rnn_port_noise(jn),
                     candidates=cands)]))
    assert all(r["sharded"] for r in res)
    assert_ranks_equal(res)
    g = res[0]["global"]
    _, mu, nu = jax.tree_util.tree_leaves(got.opt_state)
    assert_close(g["params"], ravel_pytree(got.params_b)[0], "params")
    assert_close(g["target"], ravel_pytree(got.target_b)[0], "target")
    assert_close(g["opt_mu"], mu, "mu", atol=1e-7)
    assert_close(g["opt_nu"], nu, "nu", atol=1e-10)
    assert g["buffer/ep_count"] == int(got.buffer.ep_count)
    assert g["train_steps"] == int(got.train_steps)
    np.testing.assert_array_equal(g["buffer/ep_id"].numpy(),
                                  np.asarray(got.buffer.ep_id))
    mt = res[0]["metrics"][0]
    assert mt["buffer_episodes"] == int(m.buffer_episodes)
    np.testing.assert_allclose(mt["mean_loss"], float(m.mean_loss),
                               rtol=RTOL)
    assert res[0]["local"]["buffer/data"].shape[0] == B_l


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_dqn_matches_jax(n, tmp_path):
    dqn_case(n, tmp_path)


def test_sharded_drqn_matches_jax(tmp_path):
    drqn_case(2, tmp_path)


def test_sharded_drqn_ep_count_matches_replicated(tmp_path):
    """The all-reduced global admitted count of the sharded ring equals the
    replicated ring's for the same rollout stream (the rollouts are the
    single-device ones: kernel 3 with ``tile0``)."""
    from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
    from tests.test_torch_seq_directory import np_rnn

    d = np_rnn(np.random.default_rng(0))
    res = run_ranks("learner", 2, tmp_path, dict(
        kind="drqn", env=ENV, cfg=DRQN, seed=5, params=d, opp=[d],
        pool_size=0, iters=3))
    rep = tdrqn.DRQNLearner(EnvConfig(**ENV), DRQNConfig(
        **{**DRQN, "learner_sharding": "replicated"}), device="cpu")
    st = rep.init_state(5, qnet_rnn_from_numpy(d))
    opp = rep.prepare_opponents([qnet_rnn_from_numpy(d)])
    for it in range(3):
        st, m = rep.train_iteration(st, opp, 0)
        for r in res:
            assert r["metrics"][it]["buffer_episodes"] == m.buffer_episodes
            assert r["metrics"][it]["episodes"] == m.episodes
    assert res[0]["global"]["buffer/ep_count"] == st.buffer.ep_count


def fake_jax_mesh(n):
    return types.SimpleNamespace(shape={"data": n, "model": 1})


def warning_of(build):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        learner = build()
    msgs = [str(x.message) for x in w if "learner_sharding" in str(x.message)]
    return learner, msgs


@pytest.mark.parametrize("family,over,n,sharded", [
    ("dqn", dict(batch_size=28), 8, False),          # batch does not divide
    ("dqn", dict(memory_size=8192 + 128), 8, False),  # replay does not
    ("dqn", dict(learner_sharding="auto"), 32, True),  # auto above 16
    ("dqn", dict(learner_sharding="auto", batch_size=30), 32, False),
    ("dqn", dict(learner_sharding="auto"), 8, False),  # no warning
    ("dqn", {}, 1, False),                           # one data shard
    ("drqn", dict(episode_uniform_sampling=True), 8, False),
    ("drqn", dict(batch_size=12), 8, False),
    ("drqn", dict(learner_sharding="auto", batch_size=32), 32, True),
    ("drqn", {}, 1, False),
])
def test_layout_rule_and_warnings_match_jax(family, over, n, sharded):
    """The layout the JAX learner picks, and its warnings word for word:
    the fallback ones and the one-shard one."""
    dqn = family == "dqn"
    base = DQN if dqn else DRQN
    cfg = {**base, **over, "num_envs": 64 if n < 32 else 128}
    jcls, tcls = ((JDQNLearner, tdqn.DQNLearner) if dqn
                  else (JDRQNLearner, tdrqn.DRQNLearner))
    jcfg = (JDQNConfig if dqn else JDRQNConfig)(**cfg)
    tcfg = (DQNConfig if dqn else DRQNConfig)(**cfg)
    jl, jmsg = warning_of(lambda: jcls(JEnvConfig(**ENV), jcfg, mesh=(
        fake_jax_mesh(n) if n > 1 else None)))
    tl, tmsg = warning_of(lambda: tcls(EnvConfig(**ENV), tcfg, device="cpu",
                                       mesh=create_mesh(world=n)))
    assert tmsg == jmsg
    assert tl.sharded == jl._learner_sharded == sharded
    if n == 1 or (not sharded and over.get("learner_sharding") != "auto"):
        assert len(tmsg) == 1
    if sharded:
        assert tl.route.update == "autodiff"
