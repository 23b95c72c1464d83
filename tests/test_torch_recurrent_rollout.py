"""PyTorch port: the plain recurrent rollout vs the JAX Pallas recurrent
kernel in interpret mode (same states, hidden streams, weights, seed and
epsilon; both draw from the counter hash), plus the packing helpers. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``. Discrete outputs
and statistics must be equal; floats within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config import EnvConfig
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.qnet_rnn import qnet_rnn_init as jinit
from pingpong_tpu.ops.recurrent_rollout import pack_qnet_rnn as jpack
from pingpong_tpu.ops.recurrent_rollout import pack_rnn_sigma as jsigma
from pingpong_tpu.ops.recurrent_rollout import pallas_recurrent_rollout
from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.ops import recurrent_rollout as trr

B, TILE, T = 64, 32, 20
DIMS = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16)
H = DIMS["lstm_hidden_dim"]
CFG = EnvConfig(
    paddle_speed=0.03, magnus_factor=0.025, restitution=1.0, friction=0.6,
    ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
    speed_scale_every=1, speed_increment=0.1,
)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def zero_sigma_j(p):
    z = lambda l: l._replace(w_sigma=jnp.zeros_like(l.w_sigma),
                             b_sigma=jnp.zeros_like(l.b_sigma))
    return p._replace(shared=z(p.shared), fc_a=z(p.fc_a))


def setup(n_slots, eval_mode, seed):
    learner = jinit(jax.random.PRNGKey(seed), **DIMS)
    if eval_mode:
        learner = zero_sigma_j(learner)
    members = [jinit(jax.random.PRNGKey(seed + 1 + i), **DIMS)
               for i in range(n_slots)]
    st = jax.vmap(jpong.reset, in_axes=(None, 0))(
        jpong.env_params_from_config(CFG),
        jax.random.split(jax.random.PRNGKey(seed + 50), B))
    rng = np.random.default_rng(seed)
    # scores one point from the end, so that episodes end within the chunk
    st = st._replace(score_a=jnp.asarray(rng.integers(0, 3, B), jnp.int32),
                     score_b=jnp.asarray(rng.integers(1, 3, B), jnp.int32))
    opp = np.sort(rng.integers(0, n_slots, B)).astype(np.int32)
    ret = rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32)
    hid = rng.uniform(-0.5, 0.5, (4 * H, B)).astype(np.float32)
    return learner, members, st, opp, ret, hid


@pytest.mark.parametrize("n_slots,eps,eval_mode,mes", [
    (1, 0.3, False, 10),       # empty pool, truncation cap
    (3, 0.3, False, 4096),     # three bucketed slots, mixed-member tiles
    (1, 0.0, True, 0),         # gate eval: greedy, no transitions
])
def test_plain_rollout_matches_jax_interpret(n_slots, eps, eval_mode, mes):
    learner, members, st, opp, ret, hid = setup(n_slots, eval_mode,
                                                seed=5 * n_slots)
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = pallas_recurrent_rollout(
        jpong.env_params_from_config(CFG), st, jnp.asarray(opp),
        jnp.asarray(ret), jnp.asarray(hid), jpack(learner), jsigma(learner),
        jpack(stack, mirror=True), seed=jnp.int32(7654321),
        epsilon=jnp.float32(eps), steps=T, max_episode_steps=mes,
        tile_rows=TILE, interpret=True, emit_transitions=not eval_mode)
    tst = tpong.EnvState(*(torch.from_numpy(np.array(getattr(st, f)))
                           for f in tpong.EnvState._fields))
    tl = qnet_rnn_from_numpy(np_tree(learner))
    got = trr.recurrent_rollout(
        tpong.env_params_from_config(CFG), tst, torch.from_numpy(opp),
        torch.from_numpy(ret), torch.from_numpy(hid), trr.pack_qnet_rnn(tl),
        trr.pack_rnn_sigma(tl),
        trr.pack_qnet_rnn([qnet_rnn_from_numpy(np_tree(m)) for m in members],
                          mirror=True),
        seed=7654321, epsilon=eps, steps=T, max_episode_steps=mes,
        tile_rows=TILE, emit_transitions=not eval_mode)
    (js, jopp, jret, jhid, jtr, jcounts, jrsum, jended) = want
    (ts, topp, tret, thid, ttr, tcounts, trsum, tended) = got
    if not eval_mode:
        for k in ("action", "reward", "done"):
            np.testing.assert_array_equal(ttr[k].numpy(), np.asarray(jtr[k]),
                                          err_msg=k)
        np.testing.assert_allclose(ttr["obs"].numpy(), np.asarray(jtr["obs"]),
                                   rtol=0, atol=1e-5)
        assert int(np.asarray(jtr["done"]).sum()) > 0   # resets exercised
        assert len(set(np.asarray(jtr["action"]).ravel().tolist())) == 3
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(float(trsum), float(jrsum), atol=1e-5)
    np.testing.assert_array_equal(tended.numpy(), np.asarray(jended))
    np.testing.assert_array_equal(topp.numpy(), np.asarray(jopp))
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-5)
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), rtol=0,
                               atol=1e-5)
    for f in tpong.EnvState._fields[:-1]:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("mirror", [False, True])
def test_pack_qnet_rnn_matches_jax(mirror):
    members = [jinit(jax.random.PRNGKey(i), **DIMS) for i in range(2)]
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = jpack(stack, mirror=mirror)
    ports = [qnet_rnn_from_numpy(np_tree(m)) for m in members]
    got = trr.pack_qnet_rnn(ports, mirror=mirror)
    for name in trr.PackedQNetRNN._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-7, err_msg=name)
    for name, a in zip(trr.RNNSigma._fields, jsigma(members[0])):
        np.testing.assert_array_equal(
            getattr(trr.pack_rnn_sigma(ports[0]), name).numpy(),
            np.asarray(a), err_msg=name)
    # the kernel's flat layout: one vector per net, widths recovered
    flat = trr.rnn_kernel_flat(got)
    F1, F, Hd, HH = trr.packed_dims(got)
    assert (F1, F, Hd, HH) == (16, 32, 16, 16)
    assert flat.shape == (2, F1 * 9 + F1 * F + F + (F + Hd) * 4 * Hd
                          + 4 * Hd + Hd * HH + HH + 3 * HH + 3)
    assert trr.supports_kernel((64, 128, 128, 128))
    assert not trr.supports_kernel((64, 256, 128, 128))
