"""PyTorch port: one whole DRQN train iteration of the port's learner vs
the same sequence composed from the JAX package's public functions
(bucketed re-binding and opponent-stream reset ->
``pallas_recurrent_rollout(interpret=True)`` -> ``seq_push_rollout`` ->
``seq_sample`` -> ``pallas_drqn_update_block(interpret=True)``), with the
rollout seed, the window candidates and the update noise injected on both
sides. Then the generation loop at tiny CPU shapes: a ``cli train-rnn
--device cpu`` run that promotes, whose checkpoint the JAX package loads
and plays identically; the fault path; the warm start; and the route
the batch takes on the card."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pingpong_tpu.checkpoint.serialize import qnet_rnn_from_dict as jfrom_dict
from pingpong_tpu.config import load_config as jload_config
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.noisy import NoisyNoise as JNoisyNoise
from pingpong_tpu.models.policy import rnn_act_greedy as jgreedy
from pingpong_tpu.models.qnet_rnn import QNetRNNNoise as JNoise
from pingpong_tpu.models.qnet_rnn import init_hidden as jinit_hidden
from pingpong_tpu.ops.drqn_update import (
    pack_upd_noise as jpack_noise,
    pack_upd_params as jpack_upd,
    pallas_drqn_update_block,
    unpack_upd_params as junpack_upd,
)
from pingpong_tpu.ops.recurrent_rollout import (
    pack_qnet_rnn as jpack_rnn,
    pack_rnn_sigma as jpack_sigma,
    pallas_recurrent_rollout,
)
from pingpong_tpu.replay import sequence as jseq
from pingpong_tpu.selfplay.pool import load_params_any as jload_params
from pingpong_tpu.train.dqn import bucket_opp_idx as jbucket
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
from pingpong_tpu_torch.checkpoint.store import list_checkpoints
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.models import init_hidden, rnn_act_greedy
from pingpong_tpu_torch.models.noisy import NoisyNoise
from pingpong_tpu_torch.models.qnet_rnn import QNetRNNNoise
from pingpong_tpu_torch.ops.drqn_update import flat_noise
from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.train.drqn import DRQNLearner, drqn_route
from pingpong_tpu_torch.utils.metrics import MetricsLogger

CONFIG = "configs/rnn.yaml"
B, T, K, BS, RING, TILE, TRACE = 64, 32, 3, 8, 64, 32, 4
SEED, EPS0, EPISODES0 = 987654, 0.5, 5
SMALL = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16,
             trace_length=TRACE, num_envs=B, rollout_length=T,
             updates_per_iteration=K, batch_size=BS, ring_len=RING,
             pallas_tile_rows=TILE, min_episodes_for_training_start=1,
             max_episode_steps=200, save_latest_checkpoint_interval_steps=0)
H = SMALL["lstm_hidden_dim"]
CLI_TINY = [f"drqn.{k}={v}" for k, v in SMALL.items()] + [
    "drqn.selfplay.max_generations=1",
    "drqn.selfplay.episodes_per_generation=40",
    "drqn.selfplay.eval_episodes=16", "drqn.selfplay.win_rate_interval=8"]


def np_rnn(rng):
    """QNetRNN weights in the JAX layout at the small widths, made with
    numpy."""
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)

    def noisy(n_in, n_out):
        return dict(w_mu=u(n_in, n_out),
                    w_sigma=np.full((n_in, n_out), 0.017, np.float32),
                    b_mu=u(n_out), b_sigma=np.full((n_out,), 0.017, np.float32))

    return dict(kind="qnet_rnn", feat1=dict(w=u(7, 16), b=u(16)),
                feat2=dict(w=u(16, 32), b=u(32)),
                lstm=[dict(w_ih=u(32, 4 * H), w_hh=u(H, 4 * H),
                           b_ih=u(4 * H), b_hh=u(4 * H))],
                shared=noisy(H, 16), fc_v=noisy(16, 1), fc_a=noisy(16, 3))


def np_noise(rng):
    f = lambda *s: (lambda x: np.sign(x) * np.sqrt(np.abs(x)))(
        rng.normal(size=s).astype(np.float32))
    out = {}
    for name, n_in, n_out in (("shared", H, 16), ("v", 16, 1), ("a", 16, 3)):
        e_in, e_out = f(K, n_in), f(K, n_out)
        out[name] = (e_in[:, :, None] * e_out[:, None, :], e_out)
    return out


def run_jax(cfg, env_np, hid, ended, pb, stack, noise):
    dq = cfg.drqn
    env_params = jpong.env_params_from_config(cfg.env)
    ratio = dq.selfplay.opponent_pool_ratio
    target = jbucket(B, ratio, jnp.int32(1), phase=jnp.int32(EPISODES0))
    opp_idx = jnp.where(jnp.asarray(ended), target, 0).astype(jnp.int32)
    hid = jnp.asarray(hid).at[2 * H:].multiply(
        (~jnp.asarray(ended)).astype(jnp.float32)[None, :])
    state = jpong.EnvState(**{f: jnp.asarray(v) for f, v in env_np.items()})
    params = jfrom_dict(pb)
    members = [jfrom_dict(d) for d in stack]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    (env2, opp2, ret2, hid2, tr, counts, rsum, ended2) = pallas_recurrent_rollout(
        env_params, state, opp_idx, jnp.zeros((B,), jnp.float32), hid,
        jpack_rnn(params), jpack_sigma(params), jpack_rnn(jstack, mirror=True),
        seed=jnp.int32(SEED), epsilon=jnp.float32(EPS0), steps=T,
        max_episode_steps=dq.max_episode_steps, tile_rows=TILE,
        interpret=True)
    n_done = counts[0] + counts[2]
    epsilon = jnp.maximum(jnp.float32(dq.min_epsilon), jnp.float32(EPS0)
                          * dq.epsilon_decay ** n_done.astype(jnp.float32))
    buf = jseq.seq_push_rollout(jseq.seq_init(B, RING), tr["obs"],
                                tr["action"], tr["reward"], tr["done"], TRACE)
    key = jax.random.PRNGKey(SEED)
    smp = jax.tree_util.tree_map(
        lambda x: x.reshape((K, BS) + x.shape[1:]),
        jseq.seq_sample(buf, key, K * BS, TRACE))
    assert int(buf.ep_count) > BS * dq.min_episodes_for_training_start
    n = {k: JNoisyNoise(jnp.asarray(w), jnp.asarray(b))
         for k, (w, b) in noise.items()}
    po = jpack_upd(params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, po)
    o2, t2, m2, v2, losses, _ = pallas_drqn_update_block(
        jnp.int32(0), jnp.int32(0), smp.obs, smp.next_obs,
        smp.action[:, :, -1], smp.reward[:, :, -1], smp.done[:, :, -1],
        smp.valid, jpack_noise(JNoise(shared=n["shared"], v=n["v"], a=n["a"])),
        po, po, zeros, zeros, K=K, bs=BS, T=TRACE, lr=dq.lr,
        clip=dq.grad_clip_norm, gamma=dq.gamma,
        interval=dq.target_update_interval, tau=dq.target_tau,
        interpret=True)
    flat = lambda u: np.asarray(ravel_pytree(junpack_upd(u, params))[0])
    _, k_env, k_t = jax.random.split(key, 3)
    cand = (torch.from_numpy(np.asarray(jax.random.randint(
        k_env, (4 * K * BS,), 0, B)).astype(np.int64)),
        torch.from_numpy(np.asarray(jax.random.randint(
            k_t, (4 * K * BS,), 0, RING - TRACE + 1)).astype(np.int64)))
    return dict(
        env={f: np.asarray(getattr(env2, f)) for f in env_np},
        hid=np.asarray(hid2), opp_idx=np.asarray(opp2),
        ep_return=np.asarray(ret2), ended=np.asarray(ended2),
        counts=np.asarray(counts), ret_sum=float(rsum),
        epsilon=float(epsilon), episodes=EPISODES0 + int(n_done),
        data=np.asarray(buf._brf()), ep_id=np.asarray(buf.ep_id),
        ep_count=int(buf.ep_count), valid=np.asarray(smp.valid),
        params=flat(o2), target=flat(t2), m=flat(m2), v=flat(v2),
        loss=float(np.sum(np.asarray(losses))) / K), cand


def test_train_iteration_matches_jax_composition():
    rng = np.random.default_rng(11)
    pb, pa, pm = np_rnn(rng), np_rnn(rng), np_rnn(rng)
    noise = np_noise(rng)
    ended = rng.random(B) < 0.5
    hid = rng.uniform(-0.5, 0.5, (4 * H, B)).astype(np.float32)

    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.drqn, **SMALL)
    learner = DRQNLearner(cfg.env, dq, device="cpu")
    state = learner.init_state(3, qnet_rnn_from_numpy(pb), epsilon=EPS0,
                               episodes=EPISODES0)
    # scores one point from the end: episodes end, the update gate opens
    state.env_state = state.env_state._replace(
        score_a=torch.from_numpy(rng.integers(1, 3, B).astype(np.int32)),
        score_b=torch.from_numpy(rng.integers(1, 3, B).astype(np.int32)))
    state.ended = torch.from_numpy(ended)
    state.hid = torch.from_numpy(hid.copy())
    env_np = {f: getattr(state.env_state, f).numpy().copy()
              for f in state.env_state._fields}
    jcfg = jload_config(CONFIG)
    want, cand = run_jax(dataclasses.replace(jcfg, drqn=dataclasses.replace(
        jcfg.drqn, **SMALL)), env_np, hid, ended, pb, [pa, pm], noise)

    opp = learner.prepare_opponents([qnet_rnn_from_numpy(pa),
                                     qnet_rnn_from_numpy(pm)])
    tn = {k: NoisyNoise(torch.from_numpy(w), torch.from_numpy(b))
          for k, (w, b) in noise.items()}
    state, metrics = learner.train_iteration(
        state, opp, 1, seed=SEED, candidates=cand,
        noise=flat_noise(QNetRNNNoise(shared=tn["shared"], v=tn["v"],
                                      a=tn["a"])))

    # rollout: discrete fields exact, f32 within 1e-5
    for f, a in want["env"].items():
        got = getattr(state.env_state, f).numpy()
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(got, a, err_msg=f)
        else:
            np.testing.assert_allclose(got, a, rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(state.hid.numpy(), want["hid"], atol=1e-5)
    np.testing.assert_array_equal(state.opp_idx.numpy(), want["opp_idx"])
    assert 0 < int((want["opp_idx"] == 1).sum()) < B   # both slots bound
    np.testing.assert_array_equal(state.ended.numpy(), want["ended"])
    np.testing.assert_allclose(state.ep_return.numpy(), want["ep_return"],
                               atol=1e-5)
    c = want["counts"]
    assert (metrics.games_vs_a, metrics.wins_vs_a, metrics.games_vs_pool,
            metrics.wins_vs_pool) == tuple(int(x) for x in c[:4])
    assert state.episodes == want["episodes"] and metrics.episodes > 0
    np.testing.assert_allclose(metrics.episode_return_sum, want["ret_sum"],
                               atol=1e-5)
    np.testing.assert_allclose(state.epsilon, want["epsilon"], rtol=1e-6)
    # the ring: actions, rewards, done flags and episode ids exact
    np.testing.assert_allclose(state.buffer.data.numpy(), want["data"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(state.buffer.ep_id.numpy(), want["ep_id"])
    assert state.buffer.ep_count == want["ep_count"] == metrics.buffer_episodes
    assert want["valid"].mean() > 0.15
    # the update block
    assert metrics.updates_run == K and state.train_steps == K
    assert state.opt_count == K
    np.testing.assert_allclose(metrics.mean_loss, want["loss"], rtol=1e-5)
    for key, got, rtol, atol in (
            ("params", state.params, 2e-5, 2e-6),
            ("target", state.target, 2e-5, 2e-6),
            ("m", state.opt_mu, 1e-4, 1e-7), ("v", state.opt_nu, 1e-4, 1e-10)):
        np.testing.assert_allclose(got.numpy(), want[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def test_update_waits_for_the_episode_gate():
    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.drqn, **{**SMALL, "rollout_length": 8})
    learner = DRQNLearner(cfg.env, dq, device="cpu")
    state = learner.init_state(0)
    before = state.params.clone()
    state, m = learner.train_iteration(
        state, learner.prepare_opponents([learner.params_b(state)]), 0)
    assert m.updates_run == 0 and m.mean_loss == 0.0
    assert state.buffer.cursor == 8 and state.train_steps == 0
    assert m.buffer_episodes <= BS
    assert torch.equal(state.params, before)


def test_card_learner_refuses_a_batch_the_update_kernel_cannot_take():
    """On the card the update kernel takes a batch that is a multiple of
    4: the route for batch 6 is the autodiff update there, batch 8 gets
    kernel 4, and the CPU's plain version takes any batch. The route is a
    function of the config and the device, fixed at construction; the CPU
    learner at batch 6 runs its updates."""
    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.drqn, **{**SMALL, "batch_size": 6})
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert drqn_route(dq, cuda) == ("kernel", "autodiff")
    assert drqn_route(dataclasses.replace(dq, batch_size=8), cuda) \
        == ("kernel", "kernel")
    assert drqn_route(dq, cpu) == ("kernel", "kernel")

    learner = DRQNLearner(cfg.env, dq, device="cpu")
    state = learner.init_state(1)
    # scores one point from the end: episodes end, the update gate opens
    rng = np.random.default_rng(3)
    state.env_state = state.env_state._replace(
        score_a=torch.from_numpy(rng.integers(1, 3, B).astype(np.int32)),
        score_b=torch.from_numpy(rng.integers(1, 3, B).astype(np.int32)))
    opp = learner.prepare_opponents([learner.params_b(state)])
    for _ in range(2):
        state, m = learner.train_iteration(state, opp, 0)
        if m.updates_run:
            break
    assert m.updates_run == K and np.isfinite(m.mean_loss)
    assert state.opt_count == K


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(CONFIG)
    with pytest.raises(RuntimeError, match="--device cpu"):
        DRQNLearner(cfg.env, dataclasses.replace(cfg.drqn, **SMALL))
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train-rnn", "--config", CONFIG, "--workdir", str(tmp_path),
                  *CLI_TINY])
    # burn-in runs the autodiff update (on the CPU when asked)
    burn = DRQNLearner(cfg.env, dataclasses.replace(
        cfg.drqn, **SMALL, burn_in_length=4), device="cpu")
    assert burn.route == ("kernel", "autodiff")


def test_cli_train_rnn_cpu_promotes_and_jax_loads_the_checkpoint(tmp_path,
                                                                 capsys):
    args = ["train-rnn", "--config", CONFIG, "--workdir", str(tmp_path),
            "--device", "cpu", "--seed", "4", *CLI_TINY,
            "drqn.selfplay.curr_win_threshold=0.0",
            "drqn.selfplay.pool_win_threshold=0.0"]
    assert cli.main(args) == 0
    assert "done: 1/1 generations promoted" in capsys.readouterr().out
    ckpt = tmp_path / "checkpoints_rnn" / "rnn_pong_soul_1"
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["tree"]["model_kind"]["value"] == "qnet_rnn"
    obs = np.random.default_rng(5).uniform(
        [0, 0, -0.06, -0.06, 0, 0, -5], [1, 1, 0.06, 0.06, 1, 1, 5],
        (6, 512, 7)).astype(np.float32)
    jp, tp = jload_params(ckpt), load_params_any(ckpt)
    jh, th = jinit_hidden(jp, (512,)), init_hidden(tp, (512,))
    for t in range(6):
        ja, jh = jgreedy(jp, jnp.asarray(obs[t]), jh)
        ta, th = rnn_act_greedy(tp, torch.from_numpy(obs[t]), th)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    lines = (tmp_path / "train_rnn_metrics.jsonl").read_text().split("\n")
    events = [json.loads(x)["event"] for x in lines if x]
    assert events[:2] == ["restore", "try"] and "interval" in events
    assert events[-1] == "promoted"
    # a second run loads the promotion into its pool and warm-starts
    d2 = DRQNSelfPlay(load_config(CONFIG).env, dataclasses.replace(
        load_config(CONFIG).drqn, **SMALL,
        init_model_path_rnn="checkpoints_rnn/rnn_pong_soul_1"),
        workdir=str(tmp_path), logger=MetricsLogger(echo=False),
        device="cpu")
    assert len(d2.pool) == 1
    np.testing.assert_array_equal(
        d2.state.params.numpy(),
        torch.cat([p.reshape(-1) for p in tp.parameters()]).numpy())


def test_fault_path_resets_learner_and_keeps_the_ring(tmp_path):
    cfg = load_config(CONFIG)
    sp = dataclasses.replace(cfg.drqn.selfplay, max_generations=1,
                             episodes_per_generation=40, eval_episodes=16,
                             max_retries_for_generation=2,
                             win_rate_interval=8, curr_win_threshold=1.1,
                             pool_win_threshold=1.1)
    d = DRQNSelfPlay(cfg.env, dataclasses.replace(cfg.drqn, **SMALL,
                                                  selfplay=sp),
                     workdir=str(tmp_path), logger=MetricsLogger(echo=False),
                     device="cpu")
    records = d.run()
    assert [(r.promoted, r.tries) for r in records] == [(False, 2)]
    assert [p.name for p in list_checkpoints(tmp_path / "checkpoints_rnn")] \
        == ["rnn_pong_soul_1_fault"]
    st = d.state
    assert st.epsilon == 1.0 and st.opt_count == 0
    assert not st.opt_mu.any() and torch.equal(st.params, st.target)
    assert st.buffer.ep_count > 0 and st.train_steps > 0   # ring kept
