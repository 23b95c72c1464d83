"""PyTorch port: the sequence ring's episode directory and episode-uniform
sampling against ``pingpong_tpu/replay/sequence.py`` (the scenarios of
``tests/test_sequence_replay.py``'s directory tests, with the JAX
sampler's draws handed to the port), the learner's recurrent actor step
``rnn_act_train`` against the JAX function, and the DRQN learner's
one-shard warning against the JAX learner's."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config import load_config as jload_config
from pingpong_tpu.models.policy import rnn_act_train as jrnn_act_train
from pingpong_tpu.models.qnet_rnn import init_hidden as jinit_hidden
from pingpong_tpu.replay import sequence as jseq
from pingpong_tpu.train.drqn import DRQNLearner as JDRQNLearner
from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.models import init_hidden, rnn_act_greedy
from pingpong_tpu_torch.models.policy import rnn_act_train
from pingpong_tpu_torch.replay import sequence as tseq
from pingpong_tpu_torch.train.dqn import ONE_SHARD_WARNING
from pingpong_tpu_torch.train.drqn import DRQNLearner

TRACE = 4
CONFIG = "configs/rnn.yaml"


def pattern_chunks(episode_lens, num_envs=2, chunk=5, seed=0):
    """``(obs, action, reward, done)`` chunks: env 0 follows
    ``episode_lens``, the other envs end episodes at random; obs encodes
    ``[env + 1, step, ...]``."""
    rng = np.random.default_rng(seed)
    total = sum(episode_lens)
    obs = np.zeros((total, num_envs, 7), np.float32)
    obs[:, :, 0] = np.arange(num_envs)[None] + 1
    obs[:, :, 1] = np.arange(total)[:, None]
    done = rng.random((total, num_envs)) < 0.12
    done[:, 0] = False
    done[np.cumsum(episode_lens) - 1, 0] = True
    act = rng.integers(0, 3, (total, num_envs)).astype(np.int32)
    rew = rng.normal(size=(total, num_envs)).astype(np.float32)
    for s in range(0, total, chunk):
        sl = slice(s, s + chunk)
        yield obs[sl], act[sl], rew[sl], done[sl]


jpush = jax.jit(jseq.seq_push_rollout, static_argnums=5)


def push_both(episode_lens, ring, dir_cap, num_envs=2, chunk=5, seed=0):
    jb = jseq.seq_init(num_envs, ring, dir_cap=dir_cap)
    tb = tseq.seq_init(num_envs, ring, dir_cap=dir_cap)
    for o, a, r, d in pattern_chunks(episode_lens, num_envs, chunk, seed):
        jb = jpush(jb, *(jnp.asarray(x) for x in (o, a, r, d)), TRACE)
        tseq.seq_push_rollout(tb, *(torch.from_numpy(x) for x in (o, a, r, d)),
                              TRACE)
    return jb, tb


def episode_candidates(buf, key, n, rounds):
    """The draws ``jseq.seq_sample(episode_uniform=True)`` makes from
    ``key``: directory slots, then offsets within each slot's episode."""
    cap = buf.dir_env.shape[0]
    n_dir = jnp.minimum(buf.dir_cursor, cap)
    _, k_slot, k_off = jax.random.split(key, 3)
    slot = jax.random.randint(k_slot, (rounds * n,), 0, jnp.maximum(n_dir, 1))
    off = jax.random.randint(k_off, (rounds * n,), 0, jnp.maximum(
        buf.dir_len[slot] - TRACE + 1, 1))
    conv = lambda x: torch.from_numpy(np.asarray(x).astype(np.int64))
    return conv(slot), conv(off)


def assert_directory(jb, tb):
    for f in ("dir_env", "dir_start", "dir_len", "dir_id"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.dir_cursor == int(jb.dir_cursor)
    assert tb.ep_count == int(jb.ep_count)


def assert_same_sample(jb, tb, seed, n=1024, rounds=8):
    key = jax.random.PRNGKey(seed)
    want = jseq.seq_sample(jb, key, n, TRACE, rejection_rounds=rounds,
                           episode_uniform=True)
    got = tseq.seq_sample(tb, n, TRACE, *episode_candidates(jb, key, n,
                                                            rounds),
                          rejection_rounds=rounds, episode_uniform=True)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in ("obs", "action", "reward", "done", "next_obs"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        np.testing.assert_array_equal(b[valid], a[valid], err_msg=f)
    return got


@pytest.mark.parametrize("chunk", [1, 5, 17])
def test_directory_and_episode_uniform_sample_match_jax(chunk):
    """Episode A (4 steps, one window) and B (13 steps, ten windows) each
    near half the samples, as the reference rule has it; the directory,
    appended time-major from chunks of any length, equal to JAX's."""
    jb, tb = push_both([4, 13, 9], 64, 16, chunk=chunk)
    assert_directory(jb, tb)
    got = assert_same_sample(jb, tb, 0)
    valid = got.valid.numpy()
    assert valid.mean() > 0.95
    env0 = got.obs.numpy()[:, 0, 0] == 1
    step0 = got.obs.numpy()[valid & env0, 0, 1]
    a, b = (step0 < 4).mean(), ((step0 >= 4) & (step0 < 17)).mean()
    assert 0.4 < a / (a + b) < 0.6, (a, b)


def test_stale_directory_records_are_rejected_as_in_jax():
    """Episodes the ring has overwritten leave stale records; those, and
    windows that would wrap the row end, are rejected, and every valid
    sample is a real single-episode window."""
    jb, tb = push_both([6, 6, 6, 6, 6], 16, 8, num_envs=3, chunk=4)
    assert_directory(jb, tb)
    got = assert_same_sample(jb, tb, 1)
    valid = got.valid.numpy()
    assert 0.2 < valid.mean() < 1.0
    for i in np.nonzero(valid)[0]:
        assert not got.done[i, :-1].any()
        np.testing.assert_array_equal(np.diff(got.obs[i, :, 1].numpy()), 1)


def test_directory_wraps_its_ring_as_in_jax():
    """More admitted episodes than directory slots, one chunk admitting
    more than the whole directory: the newest records win."""
    jb, tb = push_both([4] * 12, 64, 4, num_envs=4, chunk=24, seed=3)
    assert int(jb.dir_cursor) > 4
    assert_directory(jb, tb)
    assert_same_sample(jb, tb, 2)


def test_episode_uniform_needs_the_directory():
    tb = tseq.seq_init(2, 64)
    assert not tb.has_directory and tb.dir_env.shape == (1,)
    with pytest.raises(ValueError, match="dir_cap"):
        tseq.seq_sample(tb, 8, TRACE, torch.zeros(32, dtype=torch.long),
                        torch.zeros(32, dtype=torch.long),
                        episode_uniform=True)


def test_port_episode_draws_cover_the_directory():
    """The port's own episode-uniform draws: slots uniform over the filled
    directory, offsets inside each slot's episode."""
    _, tb = push_both([4, 13, 9, 7], 64, 16)
    g = torch.Generator().manual_seed(0)
    slot, off = tseq.draw_episode_candidates(tb, g, 4096, TRACE, rounds=1)
    n_dir = min(tb.dir_cursor, 16)
    assert slot.max() < n_dir and slot.min() >= 0
    counts = torch.bincount(slot, minlength=n_dir).float()
    assert counts.min() > 0.7 * counts.mean()
    hi = tb.dir_len[slot].long() - TRACE + 1
    assert bool((off >= 0).all()) and bool((off < hi).all())


# ---------------------------------------------------------------------------
# rnn_act_train, the one-shard warning
# ---------------------------------------------------------------------------

def np_rnn(rng, F=32, H=16, HH=16, layers=1, sigma=0.017):
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)

    def noisy(n_in, n_out):
        return dict(w_mu=u(n_in, n_out),
                    w_sigma=np.full((n_in, n_out), sigma, np.float32),
                    b_mu=u(n_out), b_sigma=np.full((n_out,), sigma,
                                                   np.float32))

    head_in = HH if HH else H
    return dict(kind="qnet_rnn", feat1=dict(w=u(7, F // 2), b=u(F // 2)),
                feat2=dict(w=u(F // 2, F), b=u(F)),
                lstm=[dict(w_ih=u(F if l == 0 else H, 4 * H),
                           w_hh=u(H, 4 * H), b_ih=u(4 * H), b_hh=u(4 * H))
                      for l in range(layers)],
                shared=noisy(H, HH) if HH else None,
                fc_v=noisy(head_in, 1), fc_a=noisy(head_in, 3))


@pytest.mark.parametrize("layers,HH", [(1, 16), (2, 0)])
def test_rnn_act_train_matches_jax(layers, HH):
    """The hidden state advances on every step, explore or not, exactly as
    JAX's; with zero sigmas and epsilon 0 the actions are the greedy
    ones of both packages; with epsilon 1 they are uniform."""
    from pingpong_tpu.checkpoint.serialize import qnet_rnn_from_dict

    rng = np.random.default_rng(layers)
    d = np_rnn(rng, layers=layers, HH=HH)
    jp, tp = qnet_rnn_from_dict(d), qnet_rnn_from_numpy(d)
    obs = rng.uniform(-1, 1, (5, 512, 7)).astype(np.float32)
    jh, th = jinit_hidden(jp, (512,)), init_hidden(tp, (512,))
    g = torch.Generator().manual_seed(0)
    acts = []
    for t in range(5):
        ja, jh = jrnn_act_train(jax.random.PRNGKey(t), jp,
                                jnp.asarray(obs[t]), jh, jnp.float32(1.0))
        ta, th = rnn_act_train(g, tp, torch.from_numpy(obs[t]), th, 1.0)
        np.testing.assert_allclose(th.h.numpy(), np.asarray(jh.h), atol=1e-6)
        np.testing.assert_allclose(th.c.numpy(), np.asarray(jh.c), atol=1e-6)
        acts.append(ta.numpy())
    counts = np.bincount(np.concatenate(acts), minlength=3)
    n = counts.sum()
    assert np.all(np.abs(counts - n / 3) < 4 * np.sqrt(n * 2 / 9)), counts
    z = np_rnn(np.random.default_rng(9), layers=layers, HH=HH, sigma=0.0)
    jz, tz = qnet_rnn_from_dict(z), qnet_rnn_from_numpy(z)
    ja, _ = jrnn_act_train(jax.random.PRNGKey(0), jz, jnp.asarray(obs[0]),
                           jinit_hidden(jz, (512,)), jnp.float32(0.0))
    ta, _ = rnn_act_train(g, tz, torch.from_numpy(obs[0]),
                          init_hidden(tz, (512,)), 0.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    greedy, _ = rnn_act_greedy(tz, torch.from_numpy(obs[0]),
                               init_hidden(tz, (512,)))
    np.testing.assert_array_equal(ta.numpy(), greedy.numpy())


def test_drqn_one_shard_sharded_learner_warns_as_jax():
    jcfg = jload_config(CONFIG)
    with pytest.warns(UserWarning, match="one data shard") as jw:
        JDRQNLearner(jcfg.env, dataclasses.replace(
            jcfg.drqn, learner_sharding="sharded"))
    cfg = load_config(CONFIG)
    with pytest.warns(UserWarning, match="one data shard") as tw:
        learner = DRQNLearner(cfg.env, dataclasses.replace(
            cfg.drqn, learner_sharding="sharded", num_envs=32,
            feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16,
            pallas_tile_rows=32, rollout_length=8, ring_len=64),
            device="cpu")
    assert str(tw[0].message) == str(jw[0].message) == ONE_SHARD_WARNING
    st = learner.init_state(0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, m = learner.train_iteration(
            st, learner.prepare_opponents([learner.params_b(st)]), 0)
    assert m.env_steps == 32 * 8 and st.buffer.cursor == 8
