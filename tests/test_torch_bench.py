"""PyTorch port: the headline bench's path on the CPU. The ball-follower
bot and the batched auto-reset step against the JAX package, each bench
function at a tiny size, and the bench refusing to run without a card
unless the CPU is asked for. The fused kernel's plain version is held
against the JAX kernel by ``tests/test_torch_pong_kernel.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.policy import ball_follower_action as j_follower
from pingpong_tpu_torch import bench, cli
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.models.policy import ball_follower_action
from tests.test_torch_env import TUNED, jax_states, to_port


@pytest.mark.parametrize("tol", [0.02, 0.05])
def test_ball_follower_matches_jax_with_exact_ties(tol):
    rng = np.random.default_rng(0)
    obs = rng.uniform(0, 1, (1024, 7)).astype(np.float32)
    tol32 = np.float32(tol)
    # rows 0-99 sit exactly on the dead zone's edges, rows 100-199 one ulp
    # outside them
    paddle = obs[:200, 4]
    edge = np.where(np.arange(100) % 2 == 0, paddle[:100] - tol32,
                    paddle[:100] + tol32).astype(np.float32)
    obs[:100, 0] = edge
    out = np.where(np.arange(100) % 2 == 0,
                   np.nextafter(paddle[100:] - tol32, -np.inf),
                   np.nextafter(paddle[100:] + tol32, np.inf))
    obs[100:200, 0] = out.astype(np.float32)
    want = np.asarray(j_follower(jnp.asarray(obs), tolerance=tol))
    got = ball_follower_action(torch.from_numpy(obs), tolerance=tol)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:100] == 1).all()
    assert set(want[100:200]) == {0, 2}


def test_observe_matches_jax():
    jst = jax_states(TUNED, 256, seed=4, warm_steps=10)
    ja, jb = jpong.observe(jst)
    ta, tb = tpong.observe(to_port(jst))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def ended_fresh(st, ended):
    """Every ended env holds a fresh episode."""
    for f in ("ball_x", "ball_y", "top_paddle_x", "bottom_paddle_x"):
        assert bool((getattr(st, f)[ended] == 0.5).all()), f
    for f in ("score_a", "score_b", "bounce_count", "t"):
        assert bool((getattr(st, f)[ended] == 0).all()), f
    assert not bool(st.done.any())


@pytest.mark.parametrize("max_steps", [0, 40])
def test_step_autoreset_batch_matches_jax(max_steps):
    n = 2048
    rng = np.random.default_rng(max_steps)
    jst = jax_states(TUNED, n, seed=7, warm_steps=30)._replace(
        t=jnp.asarray(rng.integers(0, 45, n), jnp.int32))
    aa, ab = (rng.integers(0, 3, n).astype(np.int32) for _ in range(2))
    jp = jpong.env_params_from_config(TUNED)
    jnext, jout = jpong.step_autoreset_batch(
        jp, jst, jax.random.PRNGKey(1), jnp.asarray(aa), jnp.asarray(ab),
        max_steps)
    tnext, tout = tpong.step_autoreset_batch(
        tpong.env_params_from_config(TUNED), to_port(jst),
        torch.Generator().manual_seed(1), torch.from_numpy(aa),
        torch.from_numpy(ab), max_steps)
    done = np.asarray(jout.done)
    np.testing.assert_array_equal(tout.done.numpy(), done)
    assert 0 < done.sum() < n
    if max_steps:      # some envs end by truncation alone
        assert (done & (np.asarray(jst.t) + 1 >= max_steps)).sum() > 0
    for f in ("obs_a", "obs_b", "reward_a", "reward_b"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    keep = ~done
    for f in tpong.EnvState._fields:
        a = np.asarray(getattr(jnext, f))[keep]
        b = getattr(tnext, f).numpy()[keep]
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=f)
    ended_fresh(tnext, torch.from_numpy(done))


def test_autoreset_serves_match_jax_in_distribution():
    """Every env truncated at its first step, so all 20000 are re-served:
    the draws lie in their ranges and the quantiles of speed, angle and
    spin agree with the JAX package's serves."""
    n = 20000
    p = tpong.env_params_from_config(TUNED)
    st = tpong.reset(p, n, torch.Generator().manual_seed(0))
    stay = torch.ones(n, dtype=torch.int32)
    tnext, tout = tpong.step_autoreset_batch(
        p, st, torch.Generator().manual_seed(5), stay, stay, 1)
    assert bool(tout.done.all())
    ended_fresh(tnext, tout.done)
    jp = jpong.env_params_from_config(TUNED)
    jst = jax.vmap(jpong.reset, in_axes=(None, 0))(
        jp, jax.random.split(jax.random.PRNGKey(0), n))
    jnext, _ = jpong.step_autoreset_batch(
        jp, jst, jax.random.PRNGKey(5), jnp.ones(n, jnp.int32),
        jnp.ones(n, jnp.int32), 1)

    def serve_stats(vx, vy, spin):
        vx, vy, spin = (np.asarray(v, np.float64) for v in (vx, vy, spin))
        return (np.hypot(vx, vy), np.degrees(np.abs(np.arctan2(vy, vx))),
                spin, vy > 0)

    got = serve_stats(tnext.ball_vx.numpy(), tnext.ball_vy.numpy(),
                      tnext.spin.numpy())
    want = serve_stats(jnext.ball_vx, jnext.ball_vy, jnext.spin)
    speed, ang, spin, up = got
    assert speed.min() >= 0.03 - 1e-6 and speed.max() <= 0.05 + 1e-6
    assert ang.min() >= 30 - 1e-3 and ang.max() <= 60 + 1e-3
    assert spin.min() >= -5 and spin.max() <= 5
    q = np.linspace(0.05, 0.95, 19)
    # 20000 draws: a quantile's standard error is below 0.4 % of the range
    for g, w, rng_width in zip(got[:3], want[:3], (0.02, 30.0, 10.0)):
        np.testing.assert_allclose(np.quantile(g, q), np.quantile(w, q),
                                   rtol=0, atol=0.02 * rng_width)
    assert abs(up.mean() - want[3].mean()) < 0.03


TINY = dict(windows=(1, 2), trials=1)


def finite(rate):
    return math.isfinite(rate.steps_per_s) and rate.steps_per_s != 0


def test_rollout_benches_run_on_the_cpu():
    assert finite(bench.bench_env_steps("cpu", batch=256, chunk=16, **TINY))
    assert finite(bench.bench_fused_rollout("cpu", batch=256, chunk=16,
                                            **TINY))


@pytest.mark.parametrize("pool_n", [0, 16])
def test_train_iteration_bench_runs_on_the_cpu(pool_n):
    rate = bench.bench_train_iteration(
        pool_n, "cpu", num_envs=256, rollout_length=16, updates=2,
        batch_size=128, memory_size=16384, **TINY)
    assert finite(rate)
    assert rate.iterations == 3 and rate.updates_run == 6


def test_heads_only_pool_shares_the_trunk():
    from pingpong_tpu_torch.models.qnet import qnet_init
    base = qnet_init(torch.Generator().manual_seed(1))
    pool = bench.heads_only_pool(base, 3)
    assert all(m.feat1 is base.feat1 and m.feat2 is base.feat2 for m in pool)
    assert not torch.equal(pool[0].fc_a.w_mu, pool[1].fc_a.w_mu)


def test_drqn_iteration_bench_runs_on_the_cpu():
    rate = bench.bench_drqn_iteration("cpu", num_envs=64, rollout_length=16,
                                      updates=2, batch_size=8, ring_len=64,
                                      **TINY)
    assert finite(rate) and rate.iterations == 3
    assert rate.updates_run > 0       # the update gate opened


def test_bench_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--trials", "1"])
    assert capsys.readouterr().out == ""   # no result line


def test_smoke_profile_counts_each_kernel_once():
    """The smoke's device time sums kernels and copies only: an op's row
    (device time of the kernels it launched) is not counted again."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    import chip_smoke

    ev = lambda key, dt, us: SimpleNamespace(
        key=key, device_type=dt, self_device_time_total=us)
    events = [ev("aten::add", DeviceType.CPU, 300.0),
              ev("add_kernel", DeviceType.CUDA, 300.0),
              ev("pong_rollout_kernel", DeviceType.CUDA, 900.0),
              ev("aten::empty", DeviceType.CPU, 0.0)]
    rows = chip_smoke.device_rows(events, 3)
    assert [k for _, k in rows] == ["pong_rollout_kernel", "add_kernel"]
    assert sum(ms for ms, _ in rows) == pytest.approx(0.4)
