"""PyTorch port: one whole train iteration of the port's learner vs the
same sequence composed from the JAX package's public functions (bucketed
re-binding -> ``pallas_actor_rollout(interpret=True)`` -> ``per_push`` ->
``pallas_dqn_update_block(interpret=True)`` -> last-writer-wins priority
replay), with the rollout seed, the update uniforms and the noise
injected on both sides. Then a tiny ``cli train --device cpu`` run that
promotes, whose checkpoint the JAX package loads and plays identically."""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pingpong_tpu.checkpoint.serialize import qnet_from_dict as jfrom_dict
from pingpong_tpu.config import load_config as jload_config
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.noisy import NoisyNoise as JNoisyNoise
from pingpong_tpu.models.qnet import QNetNoise as JQNetNoise
from pingpong_tpu.models.qnet import qnet_apply as japply
from pingpong_tpu.ops.actor_rollout import pack_qnet as jpack_qnet
from pingpong_tpu.ops.actor_rollout import pallas_actor_rollout
from pingpong_tpu.ops.dqn_update import (
    pack_dqn_noise as jpack_noise,
    pack_dqn_params as jpack_params,
    pallas_dqn_update_block,
    unpack_dqn_params as junpack_params,
)
from pingpong_tpu.replay import per as jper
from pingpong_tpu.selfplay.pool import load_params_any as jload_params
from pingpong_tpu.train.dqn import bucket_opp_idx as jbucket
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.checkpoint.serialize import qnet_from_numpy
from pingpong_tpu_torch.config import apply_overrides, load_config
from pingpong_tpu_torch.models.policy import qnet_act_greedy
from pingpong_tpu_torch.models.qnet import qnet_sample_noise
from pingpong_tpu_torch.ops.dqn_update import pack_dqn_noise
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.train.dqn import DeferredLoss, DQNLearner
from pingpong_tpu_torch.utils.metrics import MetricsLogger
from tests.test_torch_cuda import state_leaves

CONFIG = "configs/qnet.yaml"
B, T, K, BS, CAP, TILE = 256, 16, 3, 128, 16384, 128
SEED, EPS0, EPISODES0 = 987654, 0.5, 5
SMALL = dict(num_envs=B, rollout_length=T, updates_per_iteration=K,
             batch_size=BS, memory_size=CAP, pallas_tile_rows=TILE)


def np_qnet(rng):
    """QNet weights in the JAX layout, made with numpy."""
    def u(*shape):
        return rng.uniform(-0.3, 0.3, shape).astype(np.float32)

    def noisy(n_out):
        return dict(w_mu=u(64, n_out), w_sigma=np.full((64, n_out), 0.017,
                                                       np.float32),
                    b_mu=u(n_out), b_sigma=np.full((n_out,), 0.017,
                                                   np.float32))

    return dict(feat1=dict(w=u(7, 64), b=u(64)),
                feat2=dict(w=u(64, 64), b=u(64)),
                fc_v=noisy(1), fc_a=noisy(3))


def np_noise(rng):
    """(K, 260) factorized head noise and the same draw as JAX QNetNoise."""
    def f(shape):
        x = rng.normal(size=shape).astype(np.float32)
        return np.sign(x) * np.sqrt(np.abs(x))

    ein_v, eout_v, ein_a, eout_a = f((K, 64)), f((K, 1)), f((K, 64)), f((K, 3))
    v_w = ein_v[:, :, None] * eout_v[:, None, :]
    a_w = ein_a[:, :, None] * eout_a[:, None, :]
    flat = np.concatenate([v_w.reshape(K, -1), eout_v, a_w.reshape(K, -1),
                           eout_a], axis=1)
    jn = JQNetNoise(v=JNoisyNoise(jnp.asarray(v_w), jnp.asarray(eout_v)),
                    a=JNoisyNoise(jnp.asarray(a_w), jnp.asarray(eout_a)))
    return flat, jn


def run_jax(cfg, env_np, ended, pb, stack, u01, jnoise):
    """The JAX learner's fused iteration, composed from public functions."""
    dq = cfg.dqn
    env_params = jpong.env_params_from_config(cfg.env)
    ratio = dq.selfplay.opponent_pool_ratio
    target = jbucket(B, ratio, jnp.int32(1), phase=jnp.int32(EPISODES0))
    opp_idx = jnp.where(jnp.asarray(ended), target, 0).astype(jnp.int32)
    state = jpong.EnvState(**{f: jnp.asarray(v) for f, v in env_np.items()})
    params = jfrom_dict(pb)
    members = [jfrom_dict(d) for d in stack]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    (env2, opp2, ret2, tr, counts, rsum, ended2) = pallas_actor_rollout(
        env_params, state, opp_idx, jnp.zeros((B,), jnp.float32),
        jpack_qnet(params), jpack_qnet(jstack, mirror=True),
        seed=jnp.int32(SEED), epsilon=jnp.float32(EPS0),
        pool_size=jnp.int32(1), steps=T, pool_ratio=ratio,
        max_episode_steps=cfg.env.max_episode_steps, tile_rows=TILE,
        interpret=True)
    n_done = counts[0] + counts[2]
    epsilon = jnp.maximum(jnp.float32(dq.min_epsilon),
                          jnp.float32(EPS0) * dq.epsilon_decay
                          ** n_done.astype(jnp.float32))
    flat = jper.Transition(*(tr[k].reshape((-1,) + tr[k].shape[2:])
                             for k in ("obs", "action", "reward", "next_obs",
                                       "done")))
    buf = jper.per_push(jper.per_init(CAP, block=True), flat, dq.per_alpha)
    nc = CAP // 128
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jpack_params(params))
    (pa, cs, o2, t2, m2, v2, newp, idx, losses, _) = pallas_dqn_update_block(
        jnp.int32(0), jnp.int32(0), jnp.int32(0), buf.size,
        jnp.asarray(u01)[:, :, None], jpack_noise(jnoise),
        buf.p_alpha.reshape(nc, 128), buf.chunk_sums.reshape(nc // 128, 128),
        jpack_params(params), jpack_params(params), zeros, zeros, buf.data,
        K=K, bs=BS, lr=dq.lr, gamma=dq.gamma,
        interval=dq.target_update_interval, tau=dq.target_tau,
        alpha=dq.per_alpha, per_eps=dq.per_eps,
        beta_start=dq.per_beta_start, beta_frames=dq.per_beta_frames,
        heads_only=dq.train_heads_only, interpret=True)
    # last writer wins, in chronological order (train/dqn.py:_update_pallas)
    prios = np.asarray(buf.prios).copy()
    for i, p in zip(np.asarray(idx).reshape(-1), np.asarray(newp).reshape(-1)):
        prios[i] = p
    flat_of = lambda u: np.asarray(ravel_pytree(junpack_params(u, params))[0])
    return dict(
        env={f: np.asarray(getattr(env2, f)) for f in env_np},
        opp_idx=np.asarray(opp2), ep_return=np.asarray(ret2),
        ended=np.asarray(ended2), counts=np.asarray(counts),
        ret_sum=float(rsum), epsilon=float(epsilon),
        episodes=EPISODES0 + int(n_done), data=np.asarray(buf.data),
        prios=prios, p_alpha=np.asarray(pa).reshape(-1),
        chunk_sums=np.asarray(cs).reshape(-1), params=flat_of(o2),
        target=flat_of(t2), m=flat_of(m2), v=flat_of(v2),
        loss=float(np.sum(np.asarray(losses))) / K)


def test_train_iteration_matches_jax_composition():
    rng = np.random.default_rng(11)
    pb, pa, pm = np_qnet(rng), np_qnet(rng), np_qnet(rng)
    noise_flat, jnoise = np_noise(rng)
    u01 = rng.random((K, BS)).astype(np.float32)
    ended = rng.random(B) < 0.5

    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.dqn, **SMALL)
    learner = DQNLearner(cfg.env, dq, device="cpu")
    state = learner.init_state(3, qnet_from_numpy(pb), epsilon=EPS0,
                               episodes=EPISODES0)
    state.ended = torch.from_numpy(ended)
    env_np = {f: getattr(state.env_state, f).numpy().copy()
              for f in state.env_state._fields}
    opp = learner.prepare_opponents([qnet_from_numpy(pa),
                                     qnet_from_numpy(pm)])
    assert opp.n_slots == 2 and not opp.shared_trunk
    state, metrics = learner.train_iteration(
        state, opp, 1, seed=SEED, u01=torch.from_numpy(u01),
        noise=torch.from_numpy(noise_flat))

    jcfg = jload_config(CONFIG)
    want = run_jax(dataclasses.replace(jcfg, dqn=dataclasses.replace(
        jcfg.dqn, **SMALL)), env_np, ended, pb, [pa, pm], u01, jnoise)

    # rollout: discrete fields exact, f32 within 1e-5
    for f, a in want["env"].items():
        got = getattr(state.env_state, f).numpy()
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(got, a, err_msg=f)
        else:
            np.testing.assert_allclose(got, a, rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(state.opp_idx.numpy(), want["opp_idx"])
    assert 0 < int((want["opp_idx"] == 1).sum()) < B   # both slots bound
    np.testing.assert_array_equal(state.ended.numpy(), want["ended"])
    np.testing.assert_allclose(state.ep_return.numpy(), want["ep_return"],
                               atol=1e-5)
    c = want["counts"]
    assert (metrics.games_vs_a, metrics.wins_vs_a, metrics.games_vs_pool,
            metrics.wins_vs_pool) == tuple(int(x) for x in c[:4])
    assert metrics.episodes == state.episodes - EPISODES0
    assert state.episodes == want["episodes"] and metrics.episodes > 0
    np.testing.assert_allclose(metrics.episode_return_sum, want["ret_sum"],
                               atol=1e-5)
    np.testing.assert_allclose(state.epsilon, want["epsilon"], rtol=1e-6)
    # the pushed chunk: action + 4*done exact, f32 fields within 1e-5
    np.testing.assert_allclose(state.buffer.data.numpy(), want["data"],
                               rtol=0, atol=1e-5)
    assert state.buffer.size == B * T and state.buffer.pos == B * T
    # the update block
    assert metrics.updates_run == K and state.train_steps == K
    assert state.opt_count == K and state.frame_idx == K
    np.testing.assert_allclose(metrics.mean_loss, want["loss"], rtol=1e-5)
    # new priorities are |td| + 1e-6: their error is absolute, at the ulp of
    # the O(1) Q-values that td is the difference of; p_alpha = newp**0.6
    # scales it by 0.6 * newp**-0.4, about 10x for the smallest newp here
    for key, got, rtol, atol in (
            ("params", state.params, 2e-5, 2e-6),
            ("target", state.target, 2e-5, 2e-6),
            ("m", state.opt_mu, 1e-4, 1e-7), ("v", state.opt_nu, 1e-4, 1e-9),
            ("prios", state.buffer.prios, 5e-5, 1e-6),
            ("p_alpha", state.buffer.p_alpha, 1e-4, 1e-5),
            ("chunk_sums", state.buffer.chunk_sums, 1e-4, 1e-5)):
        np.testing.assert_allclose(got.numpy(), want[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def test_update_skipped_until_buffer_holds_a_batch():
    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.dqn, **{**SMALL, "num_envs": 128,
                                         "rollout_length": 1,
                                         "batch_size": 256})
    learner = DQNLearner(cfg.env, dq, device="cpu")
    state = learner.init_state(0)
    before = state.params.clone()
    state, m = learner.train_iteration(state, learner.prepare_opponents(
        [learner.params_b(state)]), 0)
    assert m.updates_run == 0 and m.mean_loss == 0.0
    assert state.buffer.size == 128 and state.train_steps == 0
    assert torch.equal(state.params, before)


@pytest.mark.parametrize("update", ["kernel", "autodiff"])
@pytest.mark.parametrize("n_slots", [1, 3])
def test_own_draws_equal_draws_given_in_the_documented_order(update,
                                                             n_slots):
    """A call that draws from the state's generator is the call given the
    seed, the noise and the uniforms drawn by hand in the order
    ``train_iteration`` documents: state, metrics and generator state
    after each call, bit for bit."""
    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.dqn, **SMALL,
                             use_pallas_update=update == "kernel")
    learner = DQNLearner(cfg.env, dq, device="cpu")
    rng = np.random.default_rng(5)
    opp = learner.prepare_opponents([qnet_from_numpy(np_qnet(rng))
                                     for _ in range(n_slots)])
    own, given = (learner.init_state(2**33 + 7, epsilon=0.8)
                  for _ in range(2))
    for _ in range(2):
        own, m_own = learner.train_iteration(own, opp, n_slots - 1)
        gen = given.generator
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        noise = pack_dqn_noise(qnet_sample_noise(gen, learner.template,
                                                 batch=(K,)))
        u01 = torch.rand((K, BS), generator=gen)
        given, m_given = learner.train_iteration(
            given, opp, n_slots - 1, seed=seed, u01=u01, noise=noise)
        assert m_own.updates_run == K and m_own == m_given
        for a, b in zip(state_leaves(own), state_leaves(given),
                        strict=True):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)


def test_a_deferred_loss_reads_as_the_float_it_stands_for(tmp_path):
    """A call's deferred mean loss reads as the float the host read gave,
    through ``float()``, numpy, ``==``, formats and pickling; the loop's
    interval log writes it into its JSON as that float."""
    losses = torch.rand((7,), generator=torch.Generator().manual_seed(3))
    want = float(losses.sum()) / 7
    loss = DeferredLoss(losses.sum(), 7)
    assert float(loss) == want and loss == want and want == loss
    assert not loss != want and loss != want + 1.0
    assert np.asarray(loss) == want and np.isfinite(loss)
    np.testing.assert_allclose(loss, want, rtol=0, atol=0)
    assert f"{loss:.5g}" == f"{want:.5g}" and repr(loss) == repr(want)
    back = pickle.loads(pickle.dumps(loss))
    assert type(back) is float and back == want
    assert DeferredLoss(torch.zeros(()), 4) == 0.0

    loop_cfg = apply_overrides(load_config(CONFIG), [
        "dqn.num_envs=64", "dqn.rollout_length=32",
        "dqn.updates_per_iteration=4", "dqn.batch_size=128",
        "dqn.memory_size=16384", "dqn.pallas_tile_rows=64",
        "dqn.selfplay.episodes_per_generation=16",
        "dqn.selfplay.win_rate_interval=4", "dqn.selfplay.max_generations=1",
        "dqn.selfplay.eval_episodes=16",
        "dqn.selfplay.curr_win_threshold=0.0",
        "dqn.selfplay.pool_win_threshold=0.0",
        "dqn.save_latest_checkpoint_interval_steps=0",
        "env.max_episode_steps=256"])
    path = tmp_path / "metrics.jsonl"
    loop = QNetSelfPlay(loop_cfg.env, loop_cfg.dqn, workdir=str(tmp_path),
                        seed=5, logger=MetricsLogger(str(path), echo=False),
                        device="cpu")
    inner, given = loop.learner.train_iteration, []

    def deferred(*args, **kw):
        state, m = inner(*args, **kw)
        m = m._replace(mean_loss=DeferredLoss(
            torch.tensor(m.mean_loss, dtype=torch.float64), 1))
        given.append(float(m.mean_loss))
        return state, m

    loop.learner.train_iteration = deferred
    loop.run()
    logged = [json.loads(line)["loss"] for line in path.read_text()
              .splitlines() if json.loads(line)["event"] == "interval"]
    assert logged and any(x != 0.0 for x in logged)
    assert all(type(x) is float and x in given for x in logged)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(CONFIG)
    with pytest.raises(RuntimeError, match="--device cpu"):
        DQNLearner(cfg.env, cfg.dqn)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train", "--config", CONFIG, "--workdir", str(tmp_path),
                  "dqn.save_latest_checkpoint_interval_steps=0"])
    # the XLA-scan option runs the scan rollout (on the CPU when asked)
    scan = DQNLearner(cfg.env, dataclasses.replace(
        cfg.dqn, use_pallas_rollout=False), device="cpu")
    assert scan.route == ("scan", "kernel")


def test_cli_train_cpu_promotes_and_jax_loads_the_checkpoint(tmp_path,
                                                             capsys):
    args = ["train", "--config", CONFIG, "--workdir", str(tmp_path),
            "--device", "cpu", "--seed", "4",
            "dqn.num_envs=256", "dqn.rollout_length=16",
            "dqn.updates_per_iteration=2", "dqn.batch_size=128",
            "dqn.memory_size=16384", "dqn.pallas_tile_rows=128",
            "dqn.selfplay.max_generations=1",
            "dqn.selfplay.episodes_per_generation=1",
            "dqn.selfplay.eval_episodes=8",
            "dqn.selfplay.curr_win_threshold=0.0",
            "dqn.selfplay.pool_win_threshold=0.0",
            "dqn.save_latest_checkpoint_interval_steps=0",
            "env.max_episode_steps=64"]
    assert cli.main(args) == 0
    out = capsys.readouterr()
    assert "done: 1/1 generations promoted" in out.out
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
    events = [json.loads(line)["event"] for line in
              (tmp_path / "train_qnet_metrics.jsonl").read_text().split("\n")
              if line]
    assert events[0] == "try" and "eval" in events and events[-1] == "promoted"
