"""PyTorch port: the DQN learner's row-layout replay and autodiff update
against the JAX package on the CPU. The row-layout PER (push aligned,
scattered and wrapping; sample; the priority write-back with its
incremental chunk sums), the autodiff update against
``DQNLearner._update`` (the update draws recomputed from the JAX state's
key) and the row update against kernel 2's plain version on the same
replay."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pingpong_tpu.checkpoint.serialize import qnet_from_dict as jfrom_dict
from pingpong_tpu.config import load_config as jload_config
from pingpong_tpu.models.qnet import qnet_sample_noise as jsample_noise
from pingpong_tpu.replay import per as jper
from pingpong_tpu.train.dqn import DQNLearner as JDQNLearner
from pingpong_tpu_torch.checkpoint.serialize import qnet_from_numpy
from pingpong_tpu_torch.config import load_config
from pingpong_tpu_torch.models.noisy import NoisyNoise
from pingpong_tpu_torch.models.qnet import QNetNoise
from pingpong_tpu_torch.ops.dqn_update import pack_dqn_noise
from pingpong_tpu_torch.replay import per as tper
from pingpong_tpu_torch.train.dqn import DQNLearner, dqn_route
from tests.test_torch_learner import np_qnet

CONFIG = "configs/qnet.yaml"
ALPHA = 0.6


def batch(rng, m):
    return dict(
        obs=rng.uniform(-1, 1, (m, 7)).astype(np.float32),
        action=rng.integers(0, 3, m).astype(np.int32),
        reward=rng.normal(size=m).astype(np.float32),
        next_obs=rng.uniform(-1, 1, (m, 7)).astype(np.float32),
        done=rng.random(m) < 0.2)


def j_tr(b):
    return jper.Transition(**{k: jnp.asarray(v) for k, v in b.items()})


def t_tr(b):
    return tper.Transition(**{k: torch.from_numpy(v.copy())
                              for k, v in b.items()})


def heterogeneous(rng, jb, tb):
    """The same random priorities in both buffers (0 beyond the fill)."""
    cap = tb.capacity
    pr = rng.uniform(0.1, 2.0, cap).astype(np.float32)
    pr[int(jb.size):] = 0.0
    pa = np.where(pr > 0, pr ** np.float32(ALPHA), 0).astype(np.float32)
    ch = tb.chunk
    jb = jb._replace(prios=jnp.asarray(pr), p_alpha=jnp.asarray(pa),
                     chunk_sums=jnp.asarray(pa).reshape(-1, ch).sum(1))
    tb.prios.copy_(torch.from_numpy(pr))
    tb.p_alpha.copy_(torch.from_numpy(pa))
    tb.chunk_sums.copy_(torch.from_numpy(np.array(jb.chunk_sums)))
    return jb


def assert_buffers(tb, jb, rtol=1e-6):
    assert tb.pos == int(jb.pos) and tb.size == int(jb.size)
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    np.testing.assert_allclose(tb.prios.numpy(), np.asarray(jb.prios),
                               rtol=rtol)
    np.testing.assert_allclose(tb.p_alpha.numpy(), np.asarray(jb.p_alpha),
                               rtol=rtol)
    np.testing.assert_allclose(tb.chunk_sums.numpy(),
                               np.asarray(jb.chunk_sums), rtol=rtol)


@pytest.fixture
def exact_cdf(monkeypatch):
    """JAX's float32 cumsum with the port's summation: exact, rounded to
    float32 once (``replay/per.py::exact_cumsum``, kernel 2's CDF). The
    row sampler's prefix sums are the one place where the two packages
    sum in another order (XLA's CPU scan adds in tiles of 16): that can
    move a sample across an inverse-CDF boundary, about once in 1e4
    samples here (``test_row_sampler_flip_rate_against_xla_order``), and
    one moved sample changes every later update. Everything else in the
    JAX functions stays JAX's."""
    real = jnp.cumsum

    def cumsum(x, axis=None, dtype=None):
        x = jnp.asarray(x)
        if x.dtype != jnp.float32 or dtype is not None:
            return real(x, axis=axis, dtype=dtype)
        return jax.pure_callback(
            lambda a: np.cumsum(np.asarray(a, np.float64), axis=axis)
            .astype(np.float32), jax.ShapeDtypeStruct(x.shape, jnp.float32),
            x)

    monkeypatch.setattr(jper.jnp, "cumsum", cumsum)


# ---------------------------------------------------------------------------
# row-layout PER
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,chunk", [(4096, 128), (1000, 8), (100000, 32)])
def test_chunk_size_rule(cap, chunk):
    assert tper.chunk_size(cap) == jper._chunk_size(cap) == chunk
    b = tper.per_init(cap)
    assert not b.is_block and b.chunk == chunk
    assert b.data.shape == jper.per_init(cap).data.shape


@pytest.mark.parametrize("cap,m,pushes", [
    (4096, 1024, 3),     # aligned slice writes
    (4096, 384, 13),     # scatter writes that wrap the ring
    (1000, 300, 5),      # chunks of 8, wrapping
])
def test_row_push_sample_and_write_back_match_jax(cap, m, pushes, exact_cdf):
    rng = np.random.default_rng(cap + m)
    jb, tb = jper.per_init(cap), tper.per_init(cap)
    for i in range(pushes):
        b = batch(rng, m)
        jb = jper.per_push(jb, j_tr(b), ALPHA)
        tper.per_push(tb, t_tr(b), ALPHA)
        if i == 1:
            jb = heterogeneous(rng, jb, tb)
    assert_buffers(tb, jb)
    for k in range(3):
        u = rng.random(200).astype(np.float32)
        beta = tper.beta_schedule(100 * k + 7, 0.4, 1000)
        js = jper.per_sample(jb, None, 200, jper.beta_schedule(
            jnp.int32(100 * k + 7), 0.4, 1000), u01=jnp.asarray(u))
        ts = tper.per_sample(tb, 200, beta, torch.from_numpy(u))
        np.testing.assert_array_equal(ts.indices.numpy(),
                                      np.asarray(js.indices))
        np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights),
                                   rtol=0, atol=1e-6)
        for f in ("obs", "action", "reward", "next_obs", "done"):
            np.testing.assert_array_equal(getattr(ts.batch, f).numpy(),
                                          np.asarray(getattr(js.batch, f)))
        # write-back on distinct slots: exactly the JAX result
        idx = np.unique(np.asarray(js.indices))
        td = rng.normal(size=idx.size).astype(np.float32)
        jb = jper.per_update_priorities(jb, jnp.asarray(idx),
                                        jnp.asarray(td), ALPHA, 1e-6)
        tper.per_update_priorities(tb, torch.from_numpy(idx),
                                   torch.from_numpy(td), ALPHA, 1e-6)
        assert_buffers(tb, jb)


@pytest.mark.parametrize("cap", [4096, 1000])
def test_row_sampler_flip_rate_against_xla_order(cap):
    """Against JAX's own sampler, unpatched: the same index for all but a
    few of 24576 samples (boundary flips of the CDF's summation order),
    and the same weights where the index is the same."""
    rng = np.random.default_rng(cap)
    jb, tb = jper.per_init(cap), tper.per_init(cap)
    b = batch(rng, cap)
    jb = jper.per_push(jb, j_tr(b), ALPHA)
    tper.per_push(tb, t_tr(b), ALPHA)
    jb = heterogeneous(rng, jb, tb)
    same = total = 0
    for k in range(12):
        u = rng.random(2048).astype(np.float32)
        js = jper.per_sample(jb, None, 2048, jnp.float32(0.5),
                             u01=jnp.asarray(u))
        ts = tper.per_sample(tb, 2048, torch.tensor(0.5), torch.from_numpy(u))
        eq = ts.indices.numpy() == np.asarray(js.indices)
        same += int(eq.sum())
        total += eq.size
        np.testing.assert_array_equal(
            ts.batch.obs.numpy()[eq], np.asarray(js.batch.obs)[eq])
    assert same >= total - 8, (total - same, total)


def test_row_write_back_on_duplicate_slots_keeps_the_chunk_sums():
    """Duplicated indices: the port writes the last value (the JAX
    package leaves one of them, backend's choice); the chunk sums stay the
    dense segment sums of the port's own ``p_alpha``."""
    rng = np.random.default_rng(5)
    cap = 1000
    tb = tper.per_init(cap)
    tper.per_push(tb, t_tr(batch(rng, cap)), ALPHA)
    for _ in range(20):
        idx = torch.from_numpy(rng.integers(0, 40, 64))   # many repeats
        td = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        tper.per_update_priorities(tb, idx, td, ALPHA, 1e-6)
        last = {int(i): float(v) for i, v in zip(idx, td.abs() + 1e-6)}
        for i, v in last.items():
            assert tb.prios[i].item() == np.float32(v)
        dense = tb.p_alpha.double().view(-1, tb.chunk).sum(dim=1)
        np.testing.assert_allclose(tb.chunk_sums.numpy(), dense.numpy(),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the autodiff update against DQNLearner._update
# ---------------------------------------------------------------------------

B, T, CAP = 128, 16, 4096


def small(**kw):
    return {**dict(num_envs=B, rollout_length=T, batch_size=96,
                   memory_size=CAP, pallas_tile_rows=128,
                   updates_per_iteration=6), **kw}


def port_noise(jnoise):
    conv = lambda n: NoisyNoise(torch.from_numpy(np.array(n.eps_w)),
                                torch.from_numpy(np.array(n.eps_b)))
    return pack_dqn_noise(QNetNoise(v=conv(jnoise.v), a=conv(jnoise.a)))


def copy_jax_state(st, jst):
    """The port's train state set to the JAX learner's, leaf for leaf."""
    count, mu, nu = jax.tree_util.tree_leaves(jst.opt_state)
    t = lambda x: torch.from_numpy(np.array(x))
    st.params = t(ravel_pytree(jst.params_b)[0])
    st.target = t(ravel_pytree(jst.target_b)[0])
    st.opt_count, st.opt_mu, st.opt_nu = int(count), t(mu), t(nu)
    st.train_steps, st.frame_idx = int(jst.train_steps), int(jst.frame_idx)
    buf = st.buffer
    for f in ("data", "prios", "p_alpha", "chunk_sums"):
        setattr(buf, f, t(getattr(jst.buffer, f)))
    buf.pos, buf.size = int(jst.buffer.pos), int(jst.buffer.size)


@pytest.mark.parametrize("heads_only,tau,interval", [
    (True, 0.0, 4),        # a hard sync inside the block
    (False, 0.005, 1000),  # the full backward under Polyak averaging
])
def test_autodiff_update_matches_jax(heads_only, tau, interval, exact_cdf):
    """K updates, each from the JAX learner's state and with its draws
    (``DQNLearner._update`` of one update, the draws recomputed from the
    state's key): the same sampled indices, and parameters, target, Adam
    moments, priorities and loss within the fused path's tolerances. Each
    update starts from JAX's state because a float32 rounding difference
    in a written priority moves a later sample across a CDF boundary now
    and then, and one moved sample changes every later update."""
    rng = np.random.default_rng(17)
    pb = np_qnet(rng)
    over = small(train_heads_only=heads_only, target_tau=tau,
                 target_update_interval=interval, updates_per_iteration=1)
    jcfg = jload_config(CONFIG)
    jl = JDQNLearner(jcfg.env, dataclasses.replace(jcfg.dqn, **over))
    assert not jl._pallas_update_ok
    params = jfrom_dict(pb)
    jst = jl.init_state(jax.random.PRNGKey(3), params)
    cfg = load_config(CONFIG)
    learner = DQNLearner(cfg.env, dataclasses.replace(cfg.dqn, **over),
                         device="cpu")
    assert learner.route.update == "autodiff"
    st = learner.init_state(0, qnet_from_numpy(pb))
    assert not st.buffer.is_block
    jb = jst.buffer
    for _ in range(3):
        jb = jper.per_push(jb, j_tr(batch(rng, 1024)), ALPHA)
    jb = heterogeneous(rng, jb, tper.per_init(CAP))
    jst = jst._replace(buffer=jb)
    bs = over["batch_size"]
    update = jax.jit(jl._update)
    for k in range(6):
        copy_jax_state(st, jst)
        _, k_noise, k_u = jax.random.split(jst.key, 3)
        jnoise = jax.vmap(lambda kk: jsample_noise(kk, params))(
            jax.random.split(k_noise, 1))
        u01 = jax.random.uniform(k_u, (1, bs), jnp.float32)
        jidx = jper.per_sample(jst.buffer, None, bs, jper.beta_schedule(
            jst.frame_idx + 1, jl.cfg.per_beta_start,
            jl.cfg.per_beta_frames), u01=u01[0]).indices
        jst, jloss, jran = update(jst)
        losses, idx = learner._update_autodiff(
            st, torch.from_numpy(np.array(u01)), port_noise(jnoise))
        np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
        assert int(jran) == 1 and st.train_steps == int(jst.train_steps)
        assert st.frame_idx == int(jst.frame_idx) == st.opt_count == k + 1
        np.testing.assert_allclose(float(losses[0]), float(jloss), rtol=1e-5)
        count, mu, nu = jax.tree_util.tree_leaves(jst.opt_state)
        for key, got, want, rtol, atol in (
                ("params", st.params, ravel_pytree(jst.params_b)[0], 2e-5,
                 2e-6),
                ("target", st.target, ravel_pytree(jst.target_b)[0], 2e-5,
                 2e-6),
                ("m", st.opt_mu, mu, 1e-4, 1e-7),
                ("v", st.opt_nu, nu, 1e-4, 1e-9),
                ("prios", st.buffer.prios, jst.buffer.prios, 5e-5, 1e-6),
                ("p_alpha", st.buffer.p_alpha, jst.buffer.p_alpha, 1e-4,
                 1e-5),
                ("chunk_sums", st.buffer.chunk_sums, jst.buffer.chunk_sums,
                 1e-4, 1e-5)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{key} at update {k}")
    assert int(jst.train_steps) == 6
    if heads_only:      # the mask leaves the trunk and its moments at rest
        np.testing.assert_array_equal(st.params[:4672].numpy(),
                                      ravel_pytree(params)[0][:4672])
        assert not st.opt_mu[:4672].any()
    else:
        assert not np.array_equal(st.target.numpy(), st.params.numpy())


def test_autodiff_block_runs_k_updates_once_the_replay_holds_a_batch():
    """One ``_update`` call: K updates in a row on the port's own state,
    skipped while the replay holds less than a batch."""
    cfg = load_config(CONFIG)
    learner = DQNLearner(cfg.env, dataclasses.replace(
        cfg.dqn, **small(target_update_interval=4)), device="cpu")
    st = learner.init_state(1)
    before = st.params.clone()
    rng = np.random.default_rng(4)
    tper.per_push(st.buffer, t_tr(batch(rng, 64)), ALPHA)
    assert learner._update(st) == (0.0, 0) and torch.equal(st.params, before)
    tper.per_push(st.buffer, t_tr(batch(rng, 2048)), ALPHA)
    loss, ran = learner._update(st)
    assert ran == 6 and np.isfinite(loss) and st.opt_count == 6
    assert st.train_steps == st.frame_idx == 6
    assert torch.equal(st.target, st.params) is False  # synced at 4, not 6
    assert not torch.equal(st.params, before)


def test_row_update_matches_the_fused_update_plain_version():
    """The CPU twin of the smoke's ``[update:rows]``: one replay in both
    layouts, the same uniforms and noise, kernel 2's plain version on the
    blocks and the autodiff update on the rows."""
    rng = np.random.default_rng(23)
    pb = np_qnet(rng)
    cfg = load_config(CONFIG)
    over = dict(num_envs=256, rollout_length=16, batch_size=128,
                memory_size=16384, pallas_tile_rows=128,
                updates_per_iteration=8, target_update_interval=5)
    fused = DQNLearner(cfg.env, dataclasses.replace(cfg.dqn, **over),
                       device="cpu")
    rows = DQNLearner(cfg.env, dataclasses.replace(
        cfg.dqn, **over, use_pallas_update=False), device="cpu")
    assert (fused.route.update, rows.route.update) == ("kernel", "autodiff")
    sf = fused.init_state(0, qnet_from_numpy(pb))
    sr = rows.init_state(0, qnet_from_numpy(pb))
    for _ in range(4):
        b = batch(rng, 4096)
        tper.per_push(sf.buffer, t_tr(b), ALPHA)
        tper.per_push(sr.buffer, t_tr(b), ALPHA)
    pr = torch.from_numpy(rng.uniform(0.1, 2.0, 16384).astype(np.float32))
    for buf in (sf.buffer, sr.buffer):
        buf.prios.copy_(pr)
        buf.p_alpha.copy_(pr ** ALPHA)
        buf.chunk_sums.copy_(buf.p_alpha.view(-1, 128).sum(dim=1))
    K, bs = 8, 128
    u01 = torch.rand((K, bs), generator=torch.Generator().manual_seed(1))
    noise = torch.randn((K, 260), generator=torch.Generator().manual_seed(2))
    lf, idx_f = fused._update_kernel(sf, u01, noise)
    lr_, idx_r = rows._update_autodiff(sr, u01, noise)
    assert torch.equal(idx_f[0], idx_r[0])
    assert float((idx_f == idx_r).float().mean()) >= 0.99
    np.testing.assert_allclose(lr_.numpy(), lf.numpy(), rtol=1e-4)
    for key, rtol, atol in (("params", 2e-5, 2e-6), ("target", 2e-5, 2e-6),
                            ("opt_mu", 1e-4, 1e-7), ("opt_nu", 1e-4, 1e-9)):
        np.testing.assert_allclose(getattr(sr, key).numpy(),
                                   getattr(sf, key).numpy(), rtol=rtol,
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(sr.buffer.prios.numpy(),
                               sf.buffer.prios.numpy(), rtol=5e-5, atol=1e-6)


def test_routes_follow_the_config():
    cfg = load_config(CONFIG).dqn
    assert dqn_route(cfg) == ("kernel", "kernel")
    assert dqn_route(dataclasses.replace(cfg, use_pallas_rollout=False)) \
        == ("scan", "kernel")
    for bad in (dict(batch_size=200), dict(batch_size=1024),
                dict(memory_size=1_000_000), dict(use_pallas_update=False)):
        assert dqn_route(dataclasses.replace(cfg, **bad)).update == "autodiff"


