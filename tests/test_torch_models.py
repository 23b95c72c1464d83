"""PyTorch port: QNet forward, greedy actions and checkpoint interchange
vs the JAX package. Weights and noise cross over as numpy."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.checkpoint import serialize as jser
from pingpong_tpu.checkpoint import store as jstore
from pingpong_tpu.models.qnet import (
    qnet_apply as japply,
    qnet_fold_noise as jfold,
    qnet_init as jinit,
    qnet_sample_noise as jnoise,
)
from pingpong_tpu.selfplay.pool import load_params_any as jload
from pingpong_tpu_torch.checkpoint.serialize import (
    opt_state_to_leaves,
    qnet_from_numpy,
    qnet_to_dict,
    qnet_to_numpy,
)
from pingpong_tpu_torch.checkpoint.store import save_checkpoint
from pingpong_tpu_torch.models import (
    QNetNoise,
    NoisyNoise,
    qnet_act_greedy,
    qnet_act_train,
    qnet_apply,
    qnet_fold_noise,
    qnet_init,
)
from pingpong_tpu_torch.models.qnet import qnet_from_flat, qnet_to_flat
from pingpong_tpu_torch.selfplay.pool import load_params_any, load_pool

DEMO = Path(__file__).resolve().parent.parent / "demo" / "checkpoints"


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_noise(jn):
    t = lambda x: torch.from_numpy(np.array(x))
    return QNetNoise(v=NoisyNoise(t(jn.v.eps_w), t(jn.v.eps_b)),
                     a=NoisyNoise(t(jn.a.eps_w), t(jn.a.eps_b)))


def obs_batch(n, seed):
    rng = np.random.default_rng(seed)
    lo = np.array([0, 0, -0.06, -0.06, 0, 0, -5], np.float32)
    hi = np.array([1, 1, 0.06, 0.06, 1, 1, 5], np.float32)
    return rng.uniform(lo, hi, (n, 7)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_q_values_match_jax(seed):
    jp = jinit(jax.random.PRNGKey(seed))
    jn = jnoise(jax.random.PRNGKey(seed + 10), jp)
    tp = qnet_from_numpy(np_tree(jp))
    obs = obs_batch(1024, seed)
    for noise_j, noise_t in ((None, None), (jn, port_noise(jn))):
        want = np.asarray(japply(jp, jnp.asarray(obs), noise_j))
        got = qnet_apply(tp, torch.from_numpy(obs), noise_t).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    folded_j = jfold(jp, jn)
    folded_t = qnet_fold_noise(tp, port_noise(jn))
    np.testing.assert_allclose(
        qnet_apply(folded_t, torch.from_numpy(obs)).numpy(),
        np.asarray(japply(folded_j, jnp.asarray(obs))), rtol=0, atol=1e-6)


def test_flat_vector_is_ravel_pytree_order():
    from jax.flatten_util import ravel_pytree

    jp = jinit(jax.random.PRNGKey(4))
    tp = qnet_from_numpy(np_tree(jp))
    flat = qnet_to_flat(tp)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    rt = qnet_from_flat(flat * 2, tp)
    np.testing.assert_array_equal(qnet_to_flat(rt).numpy(), 2 * flat.numpy())


@pytest.mark.parametrize("gen", range(1, 9))
def test_demo_checkpoints_greedy_actions_match(gen):
    path = DEMO / f"model5-{gen}"
    obs = obs_batch(4096, gen)
    want = np.asarray(jnp.argmax(japply(jload(path), jnp.asarray(obs)), -1))
    got = qnet_act_greedy(load_params_any(path), torch.from_numpy(obs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_checkpoint_roundtrip_both_directions(tmp_path):
    obs = obs_batch(2048, 7)
    # port -> JAX
    tp = qnet_init(torch.Generator().manual_seed(3))
    flat = qnet_to_flat(tp)
    save_checkpoint(tmp_path / "model5-1", {
        "params_b": qnet_to_dict(tp), "params_a": qnet_to_dict(tp),
        "opt_state": opt_state_to_leaves(5, flat * 0.5, flat * flat),
        "epsilon": 0.5, "episode": 10, "generation": 1, "train_steps": 5,
        "model_kind": "qnet"})
    jp = jload(tmp_path / "model5-1")
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(japply(jp, jnp.asarray(obs)), -1)),
        qnet_act_greedy(tp, torch.from_numpy(obs)).numpy())
    payload = jstore.load_checkpoint(tmp_path / "model5-1")
    assert int(payload["opt_state"][0]) == 5
    np.testing.assert_array_equal(payload["opt_state"][1], flat.numpy() * 0.5)
    # JAX -> port
    jp2 = jinit(jax.random.PRNGKey(9))
    jstore.save_checkpoint(tmp_path / "model5-2",
                           {"params_b": jser.qnet_to_dict(jp2),
                            "model_kind": "qnet"})
    tp2 = load_params_any(tmp_path / "model5-2")
    np.testing.assert_array_equal(
        qnet_act_greedy(tp2, torch.from_numpy(obs)).numpy(),
        np.asarray(jnp.argmax(japply(jp2, jnp.asarray(obs)), -1)))
    for name, arrs in qnet_to_numpy(tp2).items():
        for f, a in arrs.items():
            np.testing.assert_array_equal(
                a, np.asarray(getattr(getattr(jp2, name), f)))
    assert len(load_pool(tmp_path)) == 2


def test_act_train_epsilon_extremes():
    tp = qnet_init(torch.Generator().manual_seed(0))
    obs = torch.from_numpy(obs_batch(4096, 3))
    g = torch.Generator().manual_seed(1)
    a = qnet_act_train(g, tp, obs, 1.0)
    assert set(a.unique().tolist()) == {0, 1, 2}
    # epsilon 0 with zero sigmas is the greedy policy
    for p in (tp.fc_a.w_sigma, tp.fc_a.b_sigma, tp.fc_v.w_sigma,
              tp.fc_v.b_sigma):
        p.data.zero_()
    np.testing.assert_array_equal(qnet_act_train(g, tp, obs, 0.0).numpy(),
                                  qnet_act_greedy(tp, obs).numpy())
