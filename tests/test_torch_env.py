"""PyTorch port: env step vs the JAX package's step.

Batched states come from the JAX env (reset + random play), pass through
numpy, and step in both packages under all 9 action pairs. Discrete
fields must match exactly, float32 fields within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config import EnvConfig
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.env.physics import collide_sphere_with_moving_plane as jcollide
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.env.physics import collide_sphere_with_moving_plane

TUNED = EnvConfig(
    paddle_speed=0.03, magnus_factor=0.025, restitution=1.0, friction=0.6,
    ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
    speed_scale_every=1, speed_increment=0.1,
)
FIELDS = tpong.EnvState._fields


def jax_states(cfg, n, seed, warm_steps):
    """n JAX states after warm_steps of random play (varied positions,
    paddles, scores, spins)."""
    p = jpong.env_params_from_config(cfg)
    st = jax.vmap(jpong.reset, in_axes=(None, 0))(
        p, jax.random.split(jax.random.PRNGKey(seed), n))
    rng = np.random.default_rng(seed)
    vstep = jax.jit(jax.vmap(jpong.step, in_axes=(None, 0, 0, 0)))
    for _ in range(warm_steps):
        a = jnp.asarray(rng.integers(0, 3, (2, n)), jnp.int32)
        st, _ = vstep(p, st, a[0], a[1])
        st = st._replace(done=jnp.zeros_like(st.done))
    return st


def to_port(jstate):
    return tpong.EnvState(*(torch.from_numpy(np.array(getattr(jstate, f)))
                            for f in FIELDS))


def assert_states_match(jst, tst, atol=1e-6):
    for f in FIELDS:
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("cfg,warm", [(EnvConfig(), 20), (TUNED, 35)])
def test_step_matches_jax_all_action_pairs(cfg, warm):
    n = 512
    jst = jax_states(cfg, n, seed=3, warm_steps=warm)
    jp = jpong.env_params_from_config(cfg)
    tp = tpong.env_params_from_config(cfg)
    vstep = jax.jit(jax.vmap(jpong.step, in_axes=(None, 0, 0, 0)))
    for a_top in range(3):
        for a_bot in range(3):
            aa = np.full(n, a_top, np.int32)
            ab = np.full(n, a_bot, np.int32)
            jnew, jout = vstep(jp, jst, jnp.asarray(aa), jnp.asarray(ab))
            tnew, tout = tpong.step(tp, to_port(jst), torch.from_numpy(aa),
                                    torch.from_numpy(ab))
            assert_states_match(jnew, tnew)
            for f in ("obs_a", "obs_b", "reward_a", "reward_b"):
                np.testing.assert_allclose(
                    getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                    rtol=0, atol=1e-6, err_msg=f)
            np.testing.assert_array_equal(tout.done.numpy(),
                                          np.asarray(jout.done))


def test_collision_matches_jax_and_copysign_at_zero():
    rng = np.random.default_rng(0)
    n = 512
    args = [rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
            rng.choice([-0.03, 0.0, 0.03], n), rng.uniform(-10, 10, n)]
    args = [a.astype(np.float32) for a in args]
    # a few cases with zero contact slip (vrel == +0.0)
    args[1][:4] = 0.0
    args[2][:4] = 0.0
    args[3][:4] = 0.0
    phys = (0.9, 0.2, 1.0, 0.03)
    want = jcollide(*[jnp.asarray(a) for a in args], *phys)
    got = collide_sphere_with_moving_plane(
        *[torch.from_numpy(a) for a in args], *phys)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    # zero slip and zero friction budget: no tangential impulse
    vn, vt, om = collide_sphere_with_moving_plane(
        torch.tensor([0.0]), torch.tensor([0.0]), torch.tensor([0.0]),
        torch.tensor([0.0]), 0.9, 0.0, 1.0, 0.03)
    assert float(vt) == 0.0 and float(om) == 0.0


def test_miss_keeps_scoring_until_done():
    # the reference does not reset a missed ball: it keeps scoring every
    # step until max_score ends the game
    cfg = EnvConfig(enable_spin=False, max_score=3)
    p = tpong.env_params_from_config(cfg)
    f = lambda v: torch.tensor([v], dtype=torch.float32)
    i = lambda v: torch.tensor([v], dtype=torch.int32)
    st = tpong.EnvState(f(0.9), f(0.02), f(0.0), f(-0.05), f(0.0), f(0.1),
                        f(0.5), i(0), i(0), i(0), i(0),
                        torch.tensor([False]))
    rewards = []
    for _ in range(4):
        st, out = tpong.step(p, st, i(1), i(1))
        rewards.append(float(out.reward_b))
        if bool(out.done):
            break
    assert rewards == [1.0, 1.0, 1.0]
    assert int(st.score_b) == 3 and bool(st.done)


def test_reset_serve_ranges():
    cfg = TUNED
    p = tpong.env_params_from_config(cfg)
    st = tpong.reset(p, 4096, torch.Generator().manual_seed(0))
    speed = torch.sqrt(st.ball_vx ** 2 + st.ball_vy ** 2)
    assert float(speed.min()) >= 0.03 - 1e-6
    assert float(speed.max()) <= 0.05 + 1e-6
    ang = torch.rad2deg(torch.atan2(st.ball_vy, st.ball_vx)).abs()
    assert float(ang.min()) >= 30 - 1e-3 and float(ang.max()) <= 60 + 1e-3
    assert float(st.spin.min()) >= -5 and float(st.spin.max()) <= 5
    assert bool((st.ball_x == 0.5).all()) and bool((st.t == 0).all())
    # both serve directions occur
    assert bool((st.ball_vy > 0).any()) and bool((st.ball_vy < 0).any())
