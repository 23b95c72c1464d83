"""PyTorch port: the env-only fused rollout's plain version vs the JAX Pallas
kernel ``pallas_rollout`` in interpret mode, where both draw serves from the
same counter hash. The inputs are one numpy-made batch of mid-rally states
(scores up to 2, so episodes end and serves run early). The CUDA kernel is
held against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config import EnvConfig
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.ops.pong_kernel import pallas_rollout
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.ops import pong_kernel as tpk

# the headline bench's env (bench.py::bench_pallas_rollout)
CFG = EnvConfig(
    paddle_speed=0.03, magnus_factor=0.025, restitution=1.0, friction=0.6,
    ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
    speed_scale_every=1, speed_increment=0.1,
)
FLOATS = ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin", "top_paddle_x",
          "bottom_paddle_x")
INTS = ("score_a", "score_b", "bounce_count", "t")


def np_state(B, seed):
    rng = np.random.default_rng(seed)
    speed = rng.uniform(0.03, 0.05, B)
    ang = np.deg2rad(rng.uniform(30.0, 60.0, B)) * rng.choice([-1.0, 1.0], B)
    f = dict(
        ball_x=rng.uniform(0.1, 0.9, B), ball_y=rng.uniform(0.2, 0.8, B),
        ball_vx=speed * np.cos(ang) * rng.choice([-1.0, 1.0], B),
        ball_vy=speed * np.sin(ang), spin=rng.uniform(-5.0, 5.0, B),
        top_paddle_x=rng.uniform(0.1, 0.9, B),
        bottom_paddle_x=rng.uniform(0.1, 0.9, B))
    i = dict(score_a=rng.integers(0, 3, B), score_b=rng.integers(0, 3, B),
             bounce_count=rng.integers(0, 6, B), t=rng.integers(0, 60, B))
    out = {k: v.astype(np.float32) for k, v in f.items()}
    out.update({k: v.astype(np.int32) for k, v in i.items()})
    out["done"] = np.zeros(B, bool)
    return out


def run_both(B, tile_rows, steps, seed):
    st = np_state(B, seed)
    jstate = jpong.EnvState(**{k: jnp.asarray(v) for k, v in st.items()})
    js, jr = pallas_rollout(jpong.env_params_from_config(CFG), jstate, steps,
                            seed, bot_tolerance=0.02, tile_rows=tile_rows,
                            interpret=True)
    tstate = tpong.EnvState(**{k: torch.from_numpy(v) for k, v in st.items()})
    ts, tr = tpk.pong_rollout(tpong.env_params_from_config(CFG), tstate,
                              steps, seed, bot_tolerance=0.02,
                              tile_rows=tile_rows)
    return js, jr, ts, tr


@pytest.mark.parametrize("B,tile_rows,steps,seed", [
    (256, 1, 400, 3), (256, 1, 300, 1234567), (256, 2, 400, 11),
    (512, 2, 350, 7), (512, 2, 300, 2**31 - 5)])
def test_plain_matches_pallas_interpret(B, tile_rows, steps, seed):
    js, jr, ts, tr = run_both(B, tile_rows, steps, seed)
    # Discrete fields and reward sums: XLA's and torch's CPU cos/sin may
    # differ by one ulp on a rare serve angle, which can then flip one of
    # that env's later compares, so the bar is 99.9 % of envs.
    ok = np.ones(B, bool)
    for k in INTS:
        ok &= np.asarray(getattr(js, k)) == getattr(ts, k).numpy()
    ok &= np.asarray(jr) == tr.numpy()
    assert ok.mean() >= 0.999, ok.mean()
    # Floats: XLA's CPU backend contracts the Magnus update vx + (mf *
    # spin) * vy into one FMA, where the port (and its CUDA kernel) rounds
    # the product first. That is up to one ulp of vx a step, which the
    # position integrates: about 4e-8 a step on these batches, so the bar
    # is 1e-7 a step (4e-5 at 400 steps). A paddle hit carries the drift
    # into the spin, and on a rare env (1 in about 1500 here) it grows
    # until a bot's compare flips and the rally takes another course: the
    # bar is 99 % of envs in every field.
    close = ok.copy()
    for k in FLOATS:
        close &= np.abs(getattr(ts, k).numpy()
                        - np.asarray(getattr(js, k))) <= 1e-7 * steps
    assert close.mean() >= 0.99, np.nonzero(~close)[0]
    assert not ts.done.any()
    # the chunk ran serves and scored: the test reaches the reset path
    assert (np.asarray(js.t) < steps).mean() > 0.5
    assert np.abs(np.asarray(jr)).sum() > 0


def test_hash_cells_follow_the_tile_layout():
    mix, row, col = tpk.hash_cells(1024, 9, 2, "cpu")
    env = np.arange(1024)
    np.testing.assert_array_equal(row.numpy(), (env % 256) // 128)
    np.testing.assert_array_equal(col.numpy(), env % 128)
    np.testing.assert_array_equal(
        mix.numpy(), 9 ^ ((env // 256) * 747796405 & 0xFFFFFFFF))


def test_batch_must_fill_whole_tiles():
    st = np_state(256, 0)
    state = tpong.EnvState(**{k: torch.from_numpy(v) for k, v in st.items()})
    params = tpong.env_params_from_config(CFG)
    with pytest.raises(ValueError, match="multiple of 512"):
        tpk.pong_rollout(params, state, 4, 0, tile_rows=4)
    with pytest.raises(ValueError, match="multiple of 8192"):
        tpk.pong_rollout_plain(params, state, 4, 0)
