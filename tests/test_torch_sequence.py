"""PyTorch port: the sequence ring's push and window sampling vs the JAX
package's ``seq_push_rollout`` / ``seq_sample`` on the same pushes, with
the JAX sampler's candidates handed to the port. Valid flags and every
window field must be identical, over the scenarios of
``tests/test_sequence_replay.py`` (admission, windows inside episodes,
in-flight exclusion, ring wrap, the write seam, the derived-next frontier)
and a randomly filled chunk-major ring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.replay import sequence as jseq
from pingpong_tpu_torch.replay import sequence as tseq

TRACE = 4


def pattern(episode_lens, steps=None, num_envs=2):
    """(T, B, 7) obs encoding [env+1, step, ...] and (T, B) done: env 0
    follows ``episode_lens`` (then one open episode), the others run one
    open episode."""
    total = steps if steps is not None else sum(episode_lens)
    obs = np.zeros((total, num_envs, 7), np.float32)
    done = np.zeros((total, num_envs), bool)
    for e in range(num_envs):
        obs[:, e, 0] = e + 1
    obs[:, :, 1] = np.arange(total)[:, None]
    ends = np.cumsum(np.asarray(episode_lens, np.int64)) - 1
    done[ends[ends < total], 0] = True
    return obs, done


def push_both(obs, done, ring, chunk, rng):
    T, B = done.shape
    act = rng.integers(0, 3, (T, B)).astype(np.int32)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    jb = jseq.seq_init(B, ring)
    tb = tseq.seq_init(B, ring)
    for s in range(0, T, chunk):
        sl = slice(s, min(s + chunk, T))
        jb = jseq.seq_push_rollout(jb, jnp.asarray(obs[sl]), jnp.asarray(act[sl]),
                                   jnp.asarray(rew[sl]), jnp.asarray(done[sl]),
                                   TRACE)
        tseq.seq_push_rollout(tb, torch.from_numpy(obs[sl]),
                              torch.from_numpy(act[sl]),
                              torch.from_numpy(rew[sl]),
                              torch.from_numpy(done[sl]), TRACE)
    return jb, tb


def jax_candidates(buf, key, n, rounds):
    """The candidates ``jseq.seq_sample`` draws from ``key``."""
    num_envs, ring = buf.ep_id.shape
    _, k_env, k_t = jax.random.split(key, 3)
    env = jax.random.randint(k_env, (rounds * n,), 0, num_envs)
    t0 = jax.random.randint(k_t, (rounds * n,), 0, ring - TRACE + 1)
    return (torch.from_numpy(np.asarray(env).astype(np.int64)),
            torch.from_numpy(np.asarray(t0).astype(np.int64)))


def assert_same(jb, tb, seed, n=256, rounds=8):
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb._brf()))
    np.testing.assert_array_equal(tb.ep_id.numpy(), np.asarray(jb.ep_id))
    assert tb.cursor == int(jb.cursor) and tb.ep_count == int(jb.ep_count)
    np.testing.assert_array_equal(tb.cur_ep_id.numpy(),
                                  np.asarray(jb.cur_ep_id))
    np.testing.assert_array_equal(tb.cur_ep_len.numpy(),
                                  np.asarray(jb.cur_ep_len))
    key = jax.random.PRNGKey(seed)
    want = jseq.seq_sample(jb, key, n, TRACE, rejection_rounds=rounds)
    got = tseq.seq_sample(tb, n, TRACE, *jax_candidates(jb, key, n, rounds),
                          rejection_rounds=rounds)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in ("obs", "action", "reward", "done", "next_obs"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        np.testing.assert_array_equal(b[valid], a[valid], err_msg=f)
    return got


@pytest.mark.parametrize("lens,steps,ring,envs,chunk,check", [
    ([2, 6, 3, 4], None, 64, 2, 5, "admission"),
    ([5, 7, 6], None, 64, 2, 4, "windows"),
    ([], 20, 64, 1, 8, "inflight"),
    ([10, 12], None, 16, 1, 11, "wrap"),
    ([16 + 6], None, 16, 1, 11, "seam"),
    ([], TRACE + 1, 64, 1, 5, "frontier_open"),
    ([TRACE], None, 64, 1, 4, "frontier_done"),
    ([6, 9, 7], None, 64, 2, 11, "derived_next"),
])
def test_push_and_sample_match_jax(lens, steps, ring, envs, chunk, check):
    rng = np.random.default_rng(len(lens) + ring)
    obs, done = pattern(lens, steps, envs)
    jb, tb = push_both(obs, done, ring, chunk, rng)
    got = assert_same(jb, tb, seed=ring + chunk)
    valid = got.valid.numpy()
    if check == "admission":
        assert tb.ep_count == 2
    elif check in ("inflight", "frontier_open"):
        assert not valid.any()
    elif check == "frontier_done":
        assert valid.any() and got.done.numpy()[valid, -1].all()
    else:
        assert valid.any()
        o, nx, d = got.obs.numpy(), got.next_obs.numpy(), got.done.numpy()
        for i in np.nonzero(valid)[0]:
            np.testing.assert_array_equal(np.diff(o[i, :, 1]), 1)
            for j in range(TRACE):
                if not (j == TRACE - 1 and d[i, j]):
                    assert nx[i, j, 1] == o[i, j, 1] + 1


def test_random_chunk_major_ring_matches_jax():
    B, R, TT = 4, 256, 64
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(5 * TT, B, 7)).astype(np.float32)
    done = rng.random((5 * TT, B)) < 0.1
    jb, tb = push_both(obs, done, R, TT, rng)       # 320 columns: wraps
    assert jb.is_chunked
    got = assert_same(jb, tb, seed=7, n=512, rounds=4)
    assert got.valid.numpy().mean() > 0.5
