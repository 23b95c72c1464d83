"""PyTorch port: the DRQN learner's autodiff update against the JAX
package on the CPU: against ``DRQNLearner._update`` (the update draws
recomputed from the JAX state's key) with burn-in, episode-uniform
windows, a target sync inside the block and Polyak averaging (the other
nets are in ``test_torch_drqn_autodiff_nets.py``); and against kernel
4's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pingpong_tpu.checkpoint.serialize import qnet_rnn_from_dict as jfrom_dict
from pingpong_tpu.config import load_config as jload_config
from pingpong_tpu.models.qnet_rnn import qnet_rnn_sample_noise as jsample
from pingpong_tpu.replay import sequence as jseq
from pingpong_tpu.train.drqn import DRQNLearner as JDRQNLearner
from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.models.noisy import NoisyNoise
from pingpong_tpu_torch.models.qnet_rnn import QNetRNNNoise
from pingpong_tpu_torch.ops.drqn_update import flat_noise
from pingpong_tpu_torch.replay import sequence as tseq
from pingpong_tpu_torch.train.drqn import DRQNLearner
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


def chunk(rng, T=64):
    obs = rng.uniform(-1, 1, (T, B, 7)).astype(np.float32)
    act = rng.integers(0, 3, (T, B)).astype(np.int32)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.06
    return obs, act, rew, done


def port_noise(jn):
    conv = lambda n: None if n is None else NoisyNoise(
        torch.from_numpy(np.array(n.eps_w)), torch.from_numpy(np.array(n.eps_b)))
    return flat_noise(QNetRNNNoise(shared=conv(jn.shared), v=conv(jn.v),
                                   a=conv(jn.a)))


def jax_update_draws(jst, K, bs, T, episodic, params):
    """The draws of ``DRQNLearner._update``, recomputed from the state's
    key: the K noise draws and the window candidates of ``seq_sample``."""
    key, k_noise = jax.random.split(jst.key)
    noise = jax.vmap(lambda k: jsample(k, params))(jax.random.split(k_noise, K))
    _, k_samples = jax.random.split(key)
    n = 4 * K * bs
    buf = jst.buffer
    _, k1, k2 = jax.random.split(k_samples, 3)
    if episodic:
        n_dir = jnp.minimum(buf.dir_cursor, buf.dir_env.shape[0])
        a = jax.random.randint(k1, (n,), 0, jnp.maximum(n_dir, 1))
        b = jax.random.randint(k2, (n,), 0, jnp.maximum(
            buf.dir_len[a] - T + 1, 1))
    else:
        a = jax.random.randint(k1, (n,), 0, buf.ep_id.shape[0])
        b = jax.random.randint(k2, (n,), 0, buf.ep_id.shape[1] - T + 1)
    conv = lambda x: torch.from_numpy(np.asarray(x).astype(np.int64))
    return port_noise(noise), (conv(a), conv(b))


def check_update_against_jax(case, seed):
    """K updates against JAX's, from the same state and draws (the JAX
    learner takes its XLA update on the CPU; the port is asked for the
    autodiff update where its net would take kernel 4)."""
    over = small(**case, use_pallas_update=False)
    rng = np.random.default_rng(seed)
    d = np_rnn(rng, F=over["feature_dim"], H=over["lstm_hidden_dim"],
               HH=over["head_hidden_dim"], layers=over.get("lstm_layers", 1))
    jcfg = jload_config(CONFIG)
    jl = JDRQNLearner(jcfg.env, dataclasses.replace(jcfg.drqn, **over))
    assert not jl._pallas_update_ok
    params = jfrom_dict(d)
    jst = jl.init_state(jax.random.PRNGKey(7), params)
    cfg = load_config(CONFIG)
    learner = DRQNLearner(cfg.env, dataclasses.replace(cfg.drqn, **over),
                          device="cpu")
    assert learner.route.update == "autodiff"
    st = learner.init_state(0, qnet_rnn_from_numpy(d))
    jb = jst.buffer
    for _ in range(2):
        c = chunk(rng)
        jb = jseq.seq_push_rollout(jb, *(jnp.asarray(x) for x in c), 8)
        tseq.seq_push_rollout(st.buffer, *(torch.from_numpy(x) for x in c), 8)
    jst = jst._replace(buffer=jb)
    K, bs = over["updates_per_iteration"], over["batch_size"]
    episodic = over.get("episode_uniform_sampling", False)
    assert st.buffer.ep_count == int(jb.ep_count) > bs
    noise, cand = jax_update_draws(jst, K, bs, 8, episodic, params)
    jst2, jloss, jran = jax.jit(jl._update)(jst)
    loss, ran = learner._update(st, noise=noise, candidates=cand)

    assert ran == int(jran) == K and st.train_steps == int(jst2.train_steps)
    assert st.opt_count == K
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _, mu, nu = jax.tree_util.tree_leaves(jst2.opt_state)
    for key, got, want, rtol, atol in (
            ("params", st.params, ravel_pytree(jst2.params_b)[0], 2e-5, 2e-6),
            ("target", st.target, ravel_pytree(jst2.target_b)[0], 2e-5, 2e-6),
            ("m", st.opt_mu, mu, 1e-4, 1e-7), ("v", st.opt_nu, nu, 1e-4, 1e-10)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol, err_msg=key)
    if over.get("target_update_interval", 2000) <= K:
        # a sync inside the block: the later updates read the new target
        assert not torch.equal(st.target, torch.from_numpy(
            np.array(ravel_pytree(params)[0])))


WINDOW_CASES = {
    "burn0_sync": dict(target_update_interval=2),
    "burn4": dict(burn_in_length=4, target_update_interval=3),
    "polyak_episode_uniform": dict(target_tau=0.01,
                                   episode_uniform_sampling=True),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_autodiff_update_matches_jax(case):
    """Burn-in 0 with a hard sync inside the block, burn-in 4, Polyak
    averaging over episode-uniform windows."""
    check_update_against_jax(WINDOW_CASES[case], seed=len(case))


def test_autodiff_update_matches_the_fused_update_plain_version():
    """The CPU twin of the smoke's ``[drqn_update:plain]``: the same
    sampled windows and noise through kernel 4's plain version and the
    autodiff update, with a hard sync inside the block."""
    over = small(batch_size=8, target_update_interval=3)
    cfg = load_config(CONFIG)
    fused = DRQNLearner(cfg.env, dataclasses.replace(cfg.drqn, **over),
                        device="cpu")
    plain = DRQNLearner(cfg.env, dataclasses.replace(
        cfg.drqn, **over, use_pallas_update=False), device="cpu")
    assert (fused.route.update, plain.route.update) == ("kernel", "autodiff")
    rng = np.random.default_rng(3)
    d = np_rnn(rng)
    sf, sp = (lr.init_state(0, qnet_rnn_from_numpy(d)) for lr in (fused, plain))
    c = chunk(rng)
    for s in (sf, sp):
        tseq.seq_push_rollout(s.buffer, *(torch.from_numpy(x) for x in c), 8)
    g = torch.Generator().manual_seed(1)
    cand = tseq.draw_candidates(sf.buffer, g, 4 * 8, 8)
    smp = tseq.seq_sample(sf.buffer, 4 * 8, 8, *cand)
    noise = torch.randn((4, 16 * 16 + 16 + 16 + 1 + 48 + 3), generator=g)
    lf = fused._update_kernel(sf, smp, noise)
    lp = plain._update_autodiff(sp, smp, noise)
    np.testing.assert_allclose(lp.numpy(), lf.numpy(), rtol=1e-5, atol=1e-7)
    for key, rtol, atol in (("params", 2e-5, 2e-6), ("target", 2e-5, 2e-6),
                            ("opt_mu", 1e-4, 1e-7), ("opt_nu", 1e-4, 1e-10)):
        np.testing.assert_allclose(getattr(sp, key).numpy(),
                                   getattr(sf, key).numpy(), rtol=rtol,
                                   atol=atol, err_msg=key)


