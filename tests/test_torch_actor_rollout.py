"""PyTorch port: the plain fused rollout vs the JAX Pallas actor kernel in
interpret mode (same states, weights, seed and epsilon; both draw from the
counter hash), plus the hash and packing helpers. The CUDA kernel itself
is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config import EnvConfig
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.qnet import qnet_init as jinit
from pingpong_tpu.ops.actor_rollout import pack_qnet as jpack
from pingpong_tpu.ops.actor_rollout import pallas_actor_rollout
from pingpong_tpu.ops.pong_kernel import _hash_uniform
from pingpong_tpu_torch.checkpoint.serialize import qnet_from_numpy
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.ops import actor_rollout as tar

B, TILE, T = 256, 128, 16
CFG = EnvConfig(
    paddle_speed=0.03, magnus_factor=0.025, restitution=1.0, friction=0.6,
    ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
    speed_scale_every=1, speed_increment=0.1,
)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def zero_sigma_j(p):
    return p._replace(fc_a=p.fc_a._replace(
        w_sigma=jnp.zeros_like(p.fc_a.w_sigma),
        b_sigma=jnp.zeros_like(p.fc_a.b_sigma)))


def setup(n_slots, shared, eval_mode, seed):
    learner = jinit(jax.random.PRNGKey(seed))
    if eval_mode:
        learner = zero_sigma_j(learner)
    members = [jinit(jax.random.PRNGKey(seed + 1 + i)) for i in range(n_slots)]
    if shared:
        members = [m._replace(feat1=members[0].feat1, feat2=members[0].feat2)
                   for m in members]
    st = jax.vmap(jpong.reset, in_axes=(None, 0))(
        jpong.env_params_from_config(CFG),
        jax.random.split(jax.random.PRNGKey(seed + 50), B))
    rng = np.random.default_rng(seed)
    opp = np.sort(rng.integers(0, n_slots, B)).astype(np.int32)
    ret = rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32)
    return learner, members, st, opp, ret


@pytest.mark.parametrize("n_slots,shared,eps,eval_mode,mes", [
    (1, False, 0.3, False, 10),       # empty pool, truncation cap
    (3, True, 0.3, False, 4096),      # shared-trunk stack
    (3, False, 0.3, False, 4096),     # full member forwards
    (1, False, 0.0, True, 0),         # gate eval: greedy, no transitions
])
def test_plain_rollout_matches_jax_interpret(n_slots, shared, eps,
                                             eval_mode, mes):
    learner, members, st, opp, ret = setup(n_slots, shared, eval_mode,
                                           seed=3 * n_slots + int(shared))
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = pallas_actor_rollout(
        jpong.env_params_from_config(CFG), st, jnp.asarray(opp),
        jnp.asarray(ret), jpack(learner), jpack(stack, mirror=True),
        seed=jnp.int32(1234567), epsilon=jnp.float32(eps),
        pool_size=jnp.int32(n_slots - 1), steps=T, pool_ratio=0.33,
        max_episode_steps=mes, tile_rows=TILE, interpret=True,
        emit_transitions=not eval_mode, member_shared_trunk=shared)
    tst = tpong.EnvState(*(torch.from_numpy(np.array(getattr(st, f)))
                           for f in tpong.EnvState._fields))
    got = tar.actor_rollout(
        tpong.env_params_from_config(CFG), tst, torch.from_numpy(opp),
        torch.from_numpy(ret), tar.pack_qnet(qnet_from_numpy(np_tree(learner))),
        tar.pack_qnet([qnet_from_numpy(np_tree(m)) for m in members],
                      mirror=True),
        seed=1234567, epsilon=eps, steps=T, max_episode_steps=mes,
        tile_rows=TILE, emit_transitions=not eval_mode,
        member_shared_trunk=shared)
    (js, jopp, jret, jtr, jcounts, jrsum, jended) = want
    (ts, topp, tret, ttr, tcounts, trsum, tended) = got
    if not eval_mode:
        for k in ("action", "reward", "done"):
            np.testing.assert_array_equal(ttr[k].numpy(), np.asarray(jtr[k]),
                                          err_msg=k)
        for k in ("obs", "next_obs"):
            np.testing.assert_allclose(ttr[k].numpy(), np.asarray(jtr[k]),
                                       rtol=0, atol=1e-5, err_msg=k)
        assert int(np.asarray(jtr["done"]).sum()) > 0   # resets exercised
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(float(trsum), float(jrsum), atol=1e-5)
    np.testing.assert_array_equal(tended.numpy(), np.asarray(jended))
    np.testing.assert_array_equal(topp.numpy(), np.asarray(jopp))
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-5)
    for f in tpong.EnvState._fields[:-1]:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f)


def test_hash_uniform_bit_parity():
    for seed in (0, 7, 2**31 - 1, 0xDEADBEEF):
        for ctr, k in ((0, 1), (16 * 63, 2), (16 * 5 + 8, 4), (1024, 6)):
            want = np.asarray(_hash_uniform(
                (8, 128), 0.0, 1.0, jnp.uint32(seed), jnp.int32(ctr), k))
            row = torch.arange(8)[:, None]
            col = torch.arange(128)[None, :]
            got = tar.hash_u01(seed, ctr, k, row, col).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mirror", [False, True])
def test_pack_qnet_matches_jax(mirror):
    members = [jinit(jax.random.PRNGKey(i)) for i in range(3)]
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = jpack(stack, mirror=mirror)
    got = tar.pack_qnet([qnet_from_numpy(np_tree(m)) for m in members],
                        mirror=mirror)
    for name in tar.PackedQNet._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    flat = tar.packed_flat(got)
    assert flat.shape == (3, tar.NET)
    # the kernel reads layer 2 input-major: 4 hidden units a 16-byte load
    w2 = flat[:, 576:576 + 64 * 64].reshape(3, 64, 64)
    assert torch.equal(w2, got.w2t.transpose(1, 2))
    assert torch.equal(flat[:, :512], got.w1t.reshape(3, -1))


def test_epsilon_quantization():
    # the TPU kernel receives int32(eps * 1e6)
    assert tar.epsilon_to_int(0.3) == int(np.float32(0.3) * np.float32(1e6))
    assert tar.epsilon_to_int(0.02) == 20000
    assert tar.epsilon_to_int(1.0) == 1_000_000

