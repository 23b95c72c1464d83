"""PyTorch port: the DRQN learner's scan rollout and the rest of its
non-fused routes against the JAX package on the CPU: the scan rollout
with two LSTM layers against ``DRQNLearner._rollout`` on a horizon with
no randomness, its resets and re-binding, sorted binding on kernel 3's
route, ``cli train-rnn`` on the new routes and a kill-and-resume run on
the episode directory."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.checkpoint.serialize import qnet_rnn_from_dict as jfrom_dict
from pingpong_tpu.config import load_config as jload_config
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.policy import rnn_act_greedy as jgreedy
from pingpong_tpu.models.qnet_rnn import Hidden as JHidden
from pingpong_tpu.models.qnet_rnn import init_hidden as jinit_hidden
from pingpong_tpu.selfplay.pool import load_params_any as jload_params
from pingpong_tpu.train.drqn import DRQNLearner as JDRQNLearner
from pingpong_tpu.train.drqn import stack_rnn_opponents as jstack_rnn
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.models import init_hidden, rnn_act_greedy
from pingpong_tpu_torch.ops.recurrent_rollout import (
    pack_qnet_rnn,
    pack_rnn_sigma,
    recurrent_rollout,
)
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.train.drqn import (
    DRQNLearner,
    join_hidden,
    sorted_binding_draws,
    split_hidden,
)
from tests.test_torch_autosave import assert_same, driver, whole
from tests.test_torch_seq_directory import np_rnn

CONFIG = "configs/rnn.yaml"
B, RING = 32, 128


def small(**kw):
    return {**dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16,
                   trace_length=8, num_envs=B, rollout_length=64,
                   updates_per_iteration=4, batch_size=6, ring_len=RING,
                   pallas_tile_rows=32, min_episodes_for_training_start=1,
                   max_episode_steps=200, episode_dir_capacity=64,
                   save_latest_checkpoint_interval_steps=0), **kw}


def zero_sigma(d):
    for name in ("shared", "fc_v", "fc_a"):
        if d[name] is not None:
            for f in ("w_sigma", "b_sigma"):
                d[name][f] = np.zeros_like(d[name][f])
    return d


def test_scan_rollout_two_layers_matches_jax_on_a_deterministic_horizon():
    """Two LSTM layers (the scan route), zero sigmas, epsilon 0, no
    episode end, random hidden states carried in: both packages agree."""
    over = small(lstm_layers=2, rollout_length=10, min_epsilon=0.0)
    rng = np.random.default_rng(5)
    pb, pa, pm = (zero_sigma(np_rnn(rng, layers=2)) for _ in range(3))
    cfg = load_config(CONFIG)
    learner = DRQNLearner(cfg.env, dataclasses.replace(cfg.drqn, **over),
                          device="cpu")
    assert learner.route == ("scan", "autodiff")
    st = learner.init_state(2, qnet_rnn_from_numpy(pb), epsilon=0.0)
    hid = rng.uniform(-0.5, 0.5, (4, 2, B, 16)).astype(np.float32)
    st.hid = join_hidden(torch.from_numpy(hid))
    assert np.array_equal(split_hidden(st.hid, 2).numpy(), hid)
    opp0 = rng.integers(0, 3, B).astype(np.int32)
    st.opp_idx = torch.from_numpy(opp0.copy())
    env_np = {f: getattr(st.env_state, f).numpy().copy()
              for f in st.env_state._fields}
    opp = learner.prepare_opponents([qnet_rnn_from_numpy(x)
                                     for x in (pa, pm, pa)])
    counts, ret_sum = learner._rollout(st, opp, 2)

    jcfg = jload_config(CONFIG)
    jl = JDRQNLearner(jcfg.env, dataclasses.replace(jcfg.drqn, **over))
    jst = jl.init_state(jax.random.PRNGKey(0), jfrom_dict(pb), epsilon=0.0)
    jst = jst._replace(
        env_state=jpong.EnvState(**{f: jnp.asarray(v)
                                    for f, v in env_np.items()}),
        hid_b=JHidden(jnp.asarray(hid[0]), jnp.asarray(hid[1])),
        hid_opp=JHidden(jnp.asarray(hid[2]), jnp.asarray(hid[3])),
        opp_idx=jnp.asarray(opp0))
    jstack, _ = jstack_rnn([jfrom_dict(x) for x in (pa, pm, pa)][0],
                           [jfrom_dict(x) for x in (pm, pa)])
    jst2, stats, jret = jax.jit(jl._rollout)(jst, jstack, jnp.int32(2))

    assert counts == [0, 0, 0, 0] and not st.ended.any()
    np.testing.assert_array_equal(np.asarray(stats), counts)
    for f in env_np:
        a = np.asarray(getattr(jst2.env_state, f))
        got = getattr(st.env_state, f).numpy()
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(got, a, err_msg=f)
        else:
            np.testing.assert_allclose(got, a, rtol=0, atol=1e-5, err_msg=f)
    parts = split_hidden(st.hid, 2).numpy()
    for i, x in enumerate((jst2.hid_b.h, jst2.hid_b.c, jst2.hid_opp.h,
                           jst2.hid_opp.c)):
        np.testing.assert_allclose(parts[i], np.asarray(x), atol=1e-5)
    np.testing.assert_array_equal(st.opp_idx.numpy(), np.asarray(jst2.opp_idx))
    np.testing.assert_allclose(st.ep_return.numpy(),
                               np.asarray(jst2.ep_return), atol=1e-5)
    assert st.epsilon == float(jst2.epsilon) == 0.0
    data, jdata = st.buffer.data.numpy(), np.asarray(jst2.buffer._brf())
    np.testing.assert_array_equal(data[..., 7:], jdata[..., 7:])
    np.testing.assert_allclose(data, jdata, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(st.buffer.ep_id.numpy(),
                                  np.asarray(jst2.buffer.ep_id))
    assert len(set(st.buffer.data[:, :10, 7].reshape(-1).tolist())) > 1


def test_scan_rollout_resets_and_rebinds_at_episode_ends():
    """Episodes end every 3 steps: both streams restart from zero, the
    ended envs re-bind iid (the pool share within 3 sigma), epsilon decays
    per step over the chunk's own dones."""
    over = small(lstm_layers=2, rollout_length=12, max_episode_steps=3,
                 num_envs=512, epsilon_decay=0.999, min_epsilon=0.2)
    cfg = load_config(CONFIG)
    learner = DRQNLearner(cfg.env, dataclasses.replace(cfg.drqn, **over),
                          device="cpu")
    st = learner.init_state(3, epsilon=0.9)
    P = 3
    opp = learner.prepare_opponents([learner.params_b(st)] * (P + 1))
    learner._rollout(st, opp, P)
    assert st.ended.all()
    parts = split_hidden(st.hid, 2)
    assert not parts.any()            # the last step (12 = 4 x 3) ended all
    done = st.buffer.data[:, :12, 9] > 0.5
    eps = torch.tensor(0.9)
    for t in range(12):
        eps = torch.maximum(torch.tensor(0.2), eps * torch.tensor(0.999)
                            ** done[:, t].sum())
    assert st.epsilon == float(eps)
    ratio = cfg.drqn.selfplay.opponent_pool_ratio
    share = float((st.opp_idx > 0).float().mean())
    assert abs(share - ratio) < 3 * np.sqrt(ratio * (1 - ratio) / 512)


def test_sorted_binding_unpermutes_to_the_canonical_chunk():
    """Sorted binding on kernel 3's route: the ended envs draw iid, go to
    the kernel sorted by slot and come back in env order. On a horizon
    with no randomness the chunk equals the canonical-order chunk with the
    same ``opp_idx`` exactly, transitions, hidden states and all."""
    over = small(rollout_length=10, min_epsilon=0.0, num_envs=64,
                 opponent_binding="sorted")
    cfg = load_config(CONFIG)
    learner = DRQNLearner(cfg.env, dataclasses.replace(cfg.drqn, **over),
                          device="cpu")
    assert learner.route == ("kernel", "kernel")
    rng = np.random.default_rng(8)
    pb = zero_sigma(np_rnn(rng))
    ratio = cfg.drqn.selfplay.opponent_pool_ratio
    P = 3
    opp = learner.prepare_opponents([qnet_rnn_from_numpy(np_rnn(rng))
                                     for _ in range(P + 1)])
    draws = []
    for it in range(4):
        st = learner.init_state(it, qnet_rnn_from_numpy(pb), epsilon=0.0)
        st.ended = torch.ones(64, dtype=torch.bool)
        st.hid = torch.from_numpy(
            rng.uniform(-0.5, 0.5, (64, 64)).astype(np.float32))
        env0, hid0 = st.env_state, st.hid.clone()
        hid0[32:] = 0.0                      # re-bound: fresh opponent stream
        g = torch.Generator()
        g.set_state(st.generator.get_state())
        counts, _, tr = learner._rollout_kernel(st, opp, P, seed=99)
        drawn = sorted_binding_draws(g, 64, ratio, P)
        draws.append(drawn.numpy())
        want = recurrent_rollout(
            learner.env_params, env0, drawn, torch.zeros(64), hid0,
            pack_qnet_rnn(learner.params_b(st)),
            pack_rnn_sigma(learner.params_b(st)), opp.packed, seed=99,
            epsilon=0.0, steps=10, max_episode_steps=200, tile_rows=32)
        assert counts == want[5].tolist() and counts[0] + counts[2] == 0
        assert torch.equal(st.opp_idx, drawn)
        for a, b in zip(st.env_state, want[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        torch.testing.assert_close(st.hid, want[3], rtol=0, atol=1e-6)
        for k in ("action", "done"):
            assert torch.equal(tr[k], want[4][k]), k
        for k in ("obs", "reward"):
            torch.testing.assert_close(tr[k], want[4][k], rtol=0, atol=1e-6)
    d = np.concatenate(draws)
    share = (d > 0).mean()
    assert abs(share - ratio) < 3 * np.sqrt(ratio * (1 - ratio) / d.size)
    c = np.bincount(d[d > 0], minlength=P + 1)[1:]
    assert np.all(np.abs(c - c.sum() / P) < 3 * np.sqrt(c.sum() * 2 / 9))


# ---------------------------------------------------------------------------
# the entry point and a resume on the new routes
# ---------------------------------------------------------------------------

TINY = [f"drqn.{k}={v}" for k, v in small(
    trace_length=4, rollout_length=32, batch_size=8, ring_len=256).items()
    if k != "episode_dir_capacity"] + [
    "drqn.selfplay.max_generations=1",
    "drqn.selfplay.episodes_per_generation=40",
    "drqn.selfplay.eval_episodes=16", "drqn.selfplay.win_rate_interval=8",
    "drqn.selfplay.curr_win_threshold=0.0",
    "drqn.selfplay.pool_win_threshold=0.0"]


@pytest.mark.parametrize("flags,route", [
    (["drqn.lstm_layers=2"], "rollout scan, update autodiff"),
    (["drqn.burn_in_length=2", "drqn.episode_uniform_sampling=true",
      "drqn.opponent_binding=sorted", "drqn.batch_size=6"],
     "rollout kernel, update autodiff"),
])
def test_cli_train_rnn_cpu_new_routes_promote_and_jax_loads(tmp_path, capsys,
                                                            flags, route):
    args = ["train-rnn", "--config", CONFIG, "--workdir", str(tmp_path),
            "--device", "cpu", "--seed", "4", *TINY, *flags]
    assert cli.main(args) == 0
    out = capsys.readouterr()
    assert "done: 1/1 generations promoted" in out.out
    assert route in out.err
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
    events = [json.loads(x)["event"] for x in (
        tmp_path / "train_rnn_metrics.jsonl").read_text().split("\n") if x]
    assert "interval" in events and events[-1] == "promoted"


def test_episode_directory_straight_run_equals_kill_and_resume(tmp_path):
    kw = dict(episode_uniform_sampling=True, episode_dir_capacity=256,
              lstm_layers=2, burn_in_length=2)
    straight = driver("drqn", tmp_path / "straight", **kw)
    assert straight.state.buffer.has_directory
    assert straight.learner.route == ("scan", "autodiff")
    straight.current_generation = 1
    straight._train_block(8)
    straight._train_block(8)
    first = driver("drqn", tmp_path / "resumed", **kw)
    first.current_generation = 1
    first._train_block(8)
    first.autosave(wait=True)
    del first
    second = driver("drqn", tmp_path / "resumed", seed=123, **kw)
    second._train_block(8)
    assert second.state.buffer.dir_cursor > 0 and second.state.train_steps
    assert_same(whole(straight), whole(second))
