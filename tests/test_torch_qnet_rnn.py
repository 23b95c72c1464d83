"""PyTorch port: the QNetRNN sequence and single-step forwards vs the JAX
package (within 1e-5), greedy recurrent actions on the shipped DRQN
checkpoints at full width, and the npz checkpoint interchange in both
directions. Weights and noise cross over as numpy."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.checkpoint import serialize as jser
from pingpong_tpu.checkpoint import store as jstore
from pingpong_tpu.models.policy import rnn_act_greedy as jgreedy
from pingpong_tpu.models.qnet_rnn import (
    init_hidden as jinit_hidden,
    qnet_rnn_apply as japply,
    qnet_rnn_init as jinit,
    qnet_rnn_sample_noise as jnoise,
    qnet_rnn_step as jstep,
)
from pingpong_tpu.selfplay.pool import load_params_any as jload
from pingpong_tpu.selfplay.pool import load_pool as jload_pool
from pingpong_tpu_torch.checkpoint.serialize import (
    qnet_rnn_from_numpy,
    qnet_rnn_to_dict,
    qnet_rnn_to_numpy,
)
from pingpong_tpu_torch.checkpoint.store import save_checkpoint
from pingpong_tpu_torch.models import (
    Hidden,
    NoisyNoise,
    QNetRNNNoise,
    init_hidden,
    qnet_rnn_apply,
    qnet_rnn_init,
    qnet_rnn_step,
    rnn_act_greedy,
)
from pingpong_tpu_torch.models.qnet_rnn import qnet_rnn_to_flat
from pingpong_tpu_torch.selfplay.pool import load_params_any, load_pool

ROOT = Path(__file__).resolve().parent.parent
CHECKPOINTS = [ROOT / "tests" / "fixtures" / "rnn_agent_4",
               ROOT / "demo" / "rnn" / "checkpoints" / "rnn_pong_soul_1",
               ROOT / "demo" / "rnn" / "checkpoints" / "rnn_pong_soul_2"]
SMALL = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_noise(jn):
    t = lambda x: torch.from_numpy(np.array(x))
    return QNetRNNNoise(shared=NoisyNoise(t(jn.shared.eps_w),
                                          t(jn.shared.eps_b)),
                        v=NoisyNoise(t(jn.v.eps_w), t(jn.v.eps_b)),
                        a=NoisyNoise(t(jn.a.eps_w), t(jn.a.eps_b)))


def obs_seq(shape, seed):
    rng = np.random.default_rng(seed)
    lo = np.array([0, 0, -0.06, -0.06, 0, 0, -5], np.float32)
    hi = np.array([1, 1, 0.06, 0.06, 1, 1, 5], np.float32)
    return rng.uniform(lo, hi, shape + (7,)).astype(np.float32)


@pytest.mark.parametrize("layers", [1, 2])
def test_forwards_match_jax(layers):
    jp = jinit(jax.random.PRNGKey(layers), lstm_layers=layers, **SMALL)
    jn = jnoise(jax.random.PRNGKey(9), jp)
    tp = qnet_rnn_from_numpy(np_tree(jp))
    x = obs_seq((64, 6), layers)
    rng = np.random.default_rng(0)
    h0 = rng.uniform(-0.5, 0.5, (2, layers, 64, 16)).astype(np.float32)
    for noise_j, noise_t in ((None, None), (jn, port_noise(jn))):
        jq, jh = japply(jp, jnp.asarray(x), jinit_hidden(jp, (64,))._replace(
            h=jnp.asarray(h0[0]), c=jnp.asarray(h0[1])), noise_j)
        tq, th = qnet_rnn_apply(tp, torch.from_numpy(x), Hidden(
            torch.from_numpy(h0[0]), torch.from_numpy(h0[1])), noise_t)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
        np.testing.assert_allclose(th.h.numpy(), np.asarray(jh.h), atol=1e-5)
        np.testing.assert_allclose(th.c.numpy(), np.asarray(jh.c), atol=1e-5)
        jq1, jh1 = jstep(jp, jnp.asarray(x[:, 0]), jh, noise_j)
        tq1, th1 = qnet_rnn_step(tp, torch.from_numpy(x[:, 0]), th, noise_t)
        np.testing.assert_allclose(tq1.numpy(), np.asarray(jq1), atol=1e-5)
        np.testing.assert_allclose(th1.c.numpy(), np.asarray(jh1.c),
                                   atol=1e-5)
    # the flat vector is ravel_pytree's
    from jax.flatten_util import ravel_pytree

    np.testing.assert_array_equal(qnet_rnn_to_flat(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))


@pytest.mark.parametrize("path", CHECKPOINTS, ids=lambda p: p.name)
def test_shipped_checkpoints_greedy_actions_match(path):
    jp = jload(path)
    tp = load_params_any(path)
    assert tp.dims == (64, 128, 128, 128)
    obs = obs_seq((8, 1024), CHECKPOINTS.index(path))
    jh = jinit_hidden(jp, (1024,))
    th = init_hidden(tp, (1024,))
    for t in range(8):
        ja, jh = jgreedy(jp, jnp.asarray(obs[t]), jh)
        ta, th = rnn_act_greedy(tp, torch.from_numpy(obs[t]), th)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=f"step {t}")


def test_checkpoint_roundtrip_both_directions(tmp_path):
    obs = obs_seq((4, 512), 7)
    d = tmp_path / "checkpoints_rnn"
    # port -> JAX
    tp = qnet_rnn_init(torch.Generator().manual_seed(3), **SMALL)
    save_checkpoint(d / "rnn_pong_soul_1", {
        "params_b": qnet_rnn_to_dict(tp), "params_a": qnet_rnn_to_dict(tp),
        "epsilon": 0.5, "episode": 10, "generation": 1, "train_steps": 5,
        "model_kind": "qnet_rnn"})
    jp = jload(d / "rnn_pong_soul_1")
    jq, _ = japply(jp, jnp.asarray(obs), jinit_hidden(jp, (4,)))
    tq, _ = qnet_rnn_apply(tp, torch.from_numpy(obs), init_hidden(tp, (4,)))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    # JAX -> port, with a fault checkpoint the DRQN pool must skip
    jp2 = jinit(jax.random.PRNGKey(9), **SMALL)
    for name in ("rnn_pong_soul_2", "rnn_pong_soul_3_fault"):
        jstore.save_checkpoint(d / name, {"params_b": jser.qnet_rnn_to_dict(jp2),
                                          "model_kind": "qnet_rnn"})
    tp2 = load_params_any(d / "rnn_pong_soul_2")
    for name, arrs in qnet_rnn_to_numpy(tp2).items():
        if name == "lstm":
            for f, a in arrs[0].items():
                np.testing.assert_array_equal(a, np.asarray(getattr(jp2.lstm[0], f)))
            continue
        for f, a in arrs.items():
            np.testing.assert_array_equal(a, np.asarray(getattr(getattr(jp2, name), f)))
    pool = load_pool(d, kind="qnet_rnn", skip_fault=True)
    assert len(pool) == 2 == len(jload_pool(d, kind="qnet_rnn", skip_fault=True))
    assert load_pool(d, kind="qnet") == []
