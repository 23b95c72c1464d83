"""PyTorch port: the live viewer (``viewer/live.py``) and its host
policies (``viewer/host_policy.py``), held against the port's torch
forwards and the JAX package's host policies and live viewer.

* The numpy eval forwards equal the port's ``qnet_apply`` /
  ``qnet_rnn_step`` to f32 rounding (rtol 1e-5, atol 1e-6; the recurrent
  stream over 12 steps rtol 2e-5, atol 1e-5, as
  ``tests/test_live_viewer.py`` holds the JAX host policies) and equal the
  JAX host policies exactly (the same numpy code on the same float32
  weights).
* ``run_live`` yields the same frames as the JAX ``run_live`` for the same
  seed and weights (both engines build the same C++ source with the same
  flags).
* Greedy actions of the committed ``demo/strength/model9-1`` agree across
  the port's host policy, the port's ``qnet_apply`` and the JAX forward.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config.schema import EnvConfig as JEnvConfig
from pingpong_tpu.models.qnet import qnet_apply as jqnet_apply
from pingpong_tpu.models.qnet import qnet_init as jqnet_init
from pingpong_tpu.models.qnet_rnn import qnet_rnn_init as jrnn_init
from pingpong_tpu.selfplay.pool import load_params_any as jload
from pingpong_tpu.viewer import host_policy as jhost
from pingpong_tpu_torch.checkpoint.serialize import (
    qnet_from_numpy,
    qnet_rnn_from_numpy,
)
from pingpong_tpu_torch.config.schema import EnvConfig
from pingpong_tpu_torch.models.qnet import argmax3, qnet_apply
from pingpong_tpu_torch.models.qnet_rnn import init_hidden, qnet_rnn_step
from pingpong_tpu_torch.native.engine import SoAState, engine_available
from pingpong_tpu_torch.selfplay.pool import load_params_any
from pingpong_tpu_torch.viewer.host_policy import (
    HostBot,
    HostQNet,
    HostQNetRNN,
    host_policy,
    observe_pair,
)

MODEL9 = (Path(__file__).resolve().parent.parent / "demo" / "strength"
          / "model9-1")


@pytest.fixture(scope="module")
def engines():
    """Both packages' C++ engines build (each from its own source)."""
    from pingpong_tpu.native.engine import engine_available as jax_engine

    if not (engine_available() and jax_engine()):
        pytest.skip("g++ toolchain unavailable")


def nets(layers=2):
    """(JAX params, port params) of a QNet and a QNetRNN."""
    jq = jqnet_init(jax.random.PRNGKey(3))
    jr = jrnn_init(jax.random.PRNGKey(5), feature_dim=32, lstm_hidden_dim=16,
                   lstm_layers=layers, head_hidden_dim=16)
    return ((jq, qnet_from_numpy(jax.device_get(jq))),
            (jr, qnet_rnn_from_numpy(jax.device_get(jr))))


def obs_batch(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 7)).astype(
        np.float32)


def test_host_qnet_matches_torch_and_jax():
    (jq, tq), _ = nets()
    obs = obs_batch(32, 4)
    host = HostQNet(tq)
    q_np = host.q(obs)
    q_torch = qnet_apply(tq, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(q_np, q_torch, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(q_np, jhost.HostQNet(jq).q(obs))


@pytest.mark.parametrize("layers,shared", [(1, True), (2, True), (1, False)])
def test_host_qnet_rnn_stream_matches_torch_and_jax(layers, shared):
    _, (jr, tr) = nets(layers)
    if not shared:
        jr = jr._replace(shared=None)
        tr = qnet_rnn_from_numpy(jax.device_get(jr))
    host, theirs = HostQNetRNN(tr), jhost.HostQNetRNN(jr)
    hid = init_hidden(tr)
    for t, obs in enumerate(obs_batch(12, 6)):
        q_torch, hid = qnet_rnn_step(tr, torch.from_numpy(obs), hid)
        q_np = host.q(obs)
        np.testing.assert_allclose(q_np, q_torch.numpy(), rtol=2e-5,
                                   atol=1e-5, err_msg=f"t={t}")
        np.testing.assert_array_equal(q_np, theirs.q(obs), err_msg=f"t={t}")
        np.testing.assert_array_equal(host.hidden[0], theirs.hidden[0])
    # reset gives back the zero-state response
    host.reset()
    obs0 = np.zeros(7, np.float32)
    np.testing.assert_array_equal(host.q(obs0), HostQNetRNN(tr).q(obs0))


def test_host_policy_dispatch():
    (_, tq), (_, tr) = nets()
    assert isinstance(host_policy(None), HostBot)
    assert isinstance(host_policy(tq), HostQNet)
    assert isinstance(host_policy(tr), HostQNetRNN)
    bot = host_policy(None, tolerance=0.05)
    assert [bot.act(np.array([x, 0, 0, 0, 0.5, 0, 0], np.float32))
            for x in (0.4, 0.5, 0.6)] == [0, 1, 2]


def test_observe_pair_mirror():
    s = SoAState.zeros(1)
    s.ball_x[0], s.ball_y[0] = 0.3, 0.2
    s.ball_vx[0], s.ball_vy[0] = 0.01, -0.02
    s.top_x[0], s.bottom_x[0], s.spin[0] = 0.6, 0.4, 1.5
    a, b = observe_pair(s)
    np.testing.assert_allclose(a, [0.3, 0.8, 0.01, 0.02, 0.6, 0.4, 1.5],
                               rtol=1e-6)
    np.testing.assert_allclose(b, [0.3, 0.2, 0.01, -0.02, 0.4, 0.6, 1.5],
                               rtol=1e-6)
    for mine, theirs in zip((a, b), jhost.observe_pair(s)):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("with_nets", [False, True], ids=["bots", "nets"])
def test_run_live_frames_equal_jax(engines, with_nets):
    pytest.importorskip("PIL")
    from pingpong_tpu.viewer.live import run_live as jrun_live
    from pingpong_tpu_torch.viewer.live import run_live

    kw = dict(paddle_speed=0.03, ball_speed_range=(0.03, 0.05), max_score=1)
    (jq, tq), (jr, tr) = nets()
    pa, pb = (tq, tr) if with_nets else (None, None)
    ja, jb = (jq, jr) if with_nets else (None, None)
    mine = list(run_live(EnvConfig(**kw), pa, pb, episodes=2, seed=1,
                         max_steps=300, size=120))
    theirs = list(jrun_live(JEnvConfig(**kw), ja, jb, episodes=2, seed=1,
                            max_steps=300, size=120))
    assert len(mine) == len(theirs) > 20
    assert mine[0].shape == (120, 120, 3) and mine[0].dtype == np.uint8
    for k, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")


def test_model9_greedy_actions_agree_across_forwards():
    """The committed strength demo's ``model9-1``: greedy actions on 4096
    observations through the port's host policy, the port's
    ``qnet_apply`` and the JAX forward are equal."""
    rng = np.random.default_rng(9)
    n = 4096
    obs = np.stack([
        rng.uniform(0, 1, n), rng.uniform(0, 1, n),
        rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(-10, 10, n),
    ], axis=1).astype(np.float32)
    tq = load_params_any(MODEL9)
    host = HostQNet(tq)
    a_host = np.array([host.act(o) for o in obs])
    a_torch = argmax3(qnet_apply(tq, torch.from_numpy(obs))).numpy()
    a_jax = np.asarray(jnp.argmax(jqnet_apply(jload(MODEL9),
                                              jnp.asarray(obs)), axis=-1))
    np.testing.assert_array_equal(a_host, a_torch)
    np.testing.assert_array_equal(a_host, a_jax)
    assert len(set(a_host.tolist())) == 3   # every action is taken
