"""Env-only fused rollout: ``steps`` env steps of a whole batch in one CUDA
launch, both seats played by the ball-follower bot.

Port of ``pingpong_tpu/ops/pong_kernel.py::pallas_rollout``, the kernel
behind the headline bench (``bench.py``; here ``pingpong_tpu_torch/
bench.py``). Per env and step: both seats act with the ball-follower bot
on the raw state, the env steps (``env/pong.py::step``, no
``max_episode_steps`` cap), ``reward_b`` adds to the env's sum, and an env
whose episode ended is re-served in place. The function returns the final
state (``done`` all False) and the per-env ``reward_b`` sums.

Two versions compute the same function:

* :func:`pong_rollout_plain`, step by step in PyTorch. It runs for tensors
  on the CPU (the tests hold it against the JAX kernel in interpret mode),
  and ``chip_smoke.py`` holds the kernel against it on the card;
* the CUDA kernel ``csrc/pong_kernel.cu``, launched for tensors on the
  card. There is no fallback between the two. The kernel divides by the
  two collision constants through their reciprocals and computes the
  serve's sine and cosine with its own copy of the fast path of CUDA's
  ``sinf``/``cosf``; :func:`pong_exactness_check` holds both against the
  card's own functions on every float they can take.

Serves follow the JAX kernel's interpret path: its counter hash
(``_hash_uniform``) with ``seed_mix = seed ^ (tile * 747796405)``, ``ctr``
= the step, ``k`` 1-4 for speed, side pick, angle and spin, and the env's
``(row, col)`` in its ``(tile_rows, 128)`` tile. The hash and the env
constants of the CUDA kernels' shared header live here as well: the other
rollouts (``ops/actor_rollout.py``, ``ops/recurrent_rollout.py``) import
them, as the JAX kernels import ``_hash_uniform`` from this module.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    serve_from_uniforms,
    step,
)
from pingpong_tpu_torch.ops.build import (
    CudaKernel,
    check_cuda,
    ptr,
    stream_ptr,
)

LANE = 128
SUBLANE_TILE = 64     # rows of 128 envs per tile (8192 envs), the JAX default

# ---------------------------------------------------------------------------
# Counter-hash RNG (pingpong_tpu/ops/pong_kernel.py::_hash_uniform)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def hash_u01(seed_mix, ctr, k, row, col) -> torch.Tensor:
    """U[0,1) float32 from the xorshift counter hash. Arguments broadcast;
    uint32 arithmetic is carried in int64 with ``& 0xFFFFFFFF`` (CPU
    torch lacks most uint32 ops)."""
    x = (torch.as_tensor(seed_mix, dtype=torch.int64)
         + ctr * 2654435761 + k * 0x9E3779B9
         + torch.as_tensor(row, dtype=torch.int64) * 40503
         + torch.as_tensor(col, dtype=torch.int64) * 69069) & _M32
    for _ in range(2):
        x = x ^ ((x << 13) & _M32)
        x = x ^ (x >> 17)
        x = x ^ ((x << 5) & _M32)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def tile_seed_mix(seed: int, n_tiles: int, device,
                  tile0: int = 0) -> torch.Tensor:
    """``seed ^ (tile * 747796405)`` per tile, as uint32 in int64, for the
    global tiles ``tile0 .. tile0 + n_tiles - 1``."""
    tiles = torch.arange(tile0, tile0 + n_tiles, dtype=torch.int64,
                         device=device)
    return (seed & _M32) ^ ((tiles * 747796405) & _M32)


# ---------------------------------------------------------------------------
# Env constants of the kernels' shared header (csrc/pong_env.cuh::EnvP)
# ---------------------------------------------------------------------------

class EnvConsts(ctypes.Structure):
    """The kernels' ``EnvP``: each constant is evaluated in double from the
    float32-rounded env params and rounded to float32 once, as the JAX
    kernels' Python-float constants are."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "ps", "mf_spin", "half_w", "e", "mu", "m", "R", "m1e", "inertia",
        "c27", "scale_up", "spd_lo", "spd_rng", "lo0", "rng0", "lo1", "rng1",
        "deg2rad", "spin_lo", "spin_rng", "u1_lo", "u1_rng", "two_pi")] + [
        (n, ctypes.c_int) for n in (
            "max_score", "speed_scale_every", "max_episode_steps")]

    @classmethod
    def build(cls, p: EnvParams, max_episode_steps: int) -> "EnvConsts":
        (lo0, hi0), (lo1, hi1) = p.angle_intervals
        m, e, R = p.ball_mass, p.restitution, p.ball_radius
        return cls(
            ps=p.paddle_speed, mf_spin=p.enable_spin * p.magnus_factor,
            half_w=p.paddle_width * 0.5, e=e, mu=p.friction, m=m, R=R,
            m1e=m * (1.0 + e), inertia=0.4 * m * R * R, c27=2.0 * m / 7.0,
            scale_up=1.0 + p.speed_increment,
            spd_lo=p.speed_min, spd_rng=p.speed_max - p.speed_min,
            lo0=lo0, rng0=hi0 - lo0, lo1=lo1, rng1=hi1 - lo1,
            deg2rad=math.pi / 180.0, spin_lo=p.spin_min,
            spin_rng=p.spin_max - p.spin_min,
            u1_lo=1e-7, u1_rng=1.0 - 1e-7, two_pi=2.0 * math.pi,
            max_score=p.max_score, speed_scale_every=p.speed_scale_every,
            max_episode_steps=max_episode_steps,
        )


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def bot_actions(ball_x, paddle_x, tol: float) -> torch.Tensor:
    """The ball-follower bot: left (0) when the ball is left of the paddle
    by more than ``tol``, right (2) when right of it, else stay (1)."""
    return torch.where(
        ball_x < paddle_x - tol, 0,
        torch.where(ball_x > paddle_x + tol, 2, 1)).to(torch.int32)


def _check_batch(B: int, tile_rows: int) -> None:
    if B % (tile_rows * LANE):
        raise ValueError(f"batch {B} must be a multiple of {tile_rows * LANE}")


def hash_cells(B: int, seed: int, tile_rows: int, device):
    """Each env's serve cell ``(seed_mix, row, col)``: its tile's seed mix
    and its place in the ``(tile_rows, 128)`` tile."""
    env = torch.arange(B, device=device)
    tile_envs = tile_rows * LANE
    mix = tile_seed_mix(seed, B // tile_envs, device)[env // tile_envs]
    return mix, (env % tile_envs) // LANE, env % LANE


def plain_step(params: EnvParams, st: EnvState, i: int, cells, tol: float):
    """Step ``i`` of the rollout for every env: both bots act, the env
    steps, and an env that ended is re-served from the hash at ``(ctr=i,
    cells)``. Returns ``(state, reward_b, done, hit)``, ``hit`` the envs
    whose ball met a paddle."""
    act_a = bot_actions(st.ball_x, st.top_paddle_x, tol)
    act_b = bot_actions(st.ball_x, st.bottom_paddle_x, tol)
    new, out = step(params, st, act_a, act_b)
    mix, row, col = cells
    u = [hash_u01(mix, i, k, row, col) for k in (1, 2, 3, 4)]
    svx, svy, ssp = serve_from_uniforms(params, *u)
    d = out.done
    zi = torch.zeros_like(new.t)
    nxt = EnvState(
        ball_x=torch.where(d, 0.5, new.ball_x),
        ball_y=torch.where(d, 0.5, new.ball_y),
        ball_vx=torch.where(d, svx, new.ball_vx),
        ball_vy=torch.where(d, svy, new.ball_vy),
        spin=torch.where(d, ssp, new.spin),
        top_paddle_x=torch.where(d, 0.5, new.top_paddle_x),
        bottom_paddle_x=torch.where(d, 0.5, new.bottom_paddle_x),
        score_a=torch.where(d, zi, new.score_a),
        score_b=torch.where(d, zi, new.score_b),
        bounce_count=torch.where(d, zi, new.bounce_count),
        t=torch.where(d, zi, new.t),
        done=torch.zeros_like(d),
    )
    return nxt, out.reward_b, d, new.bounce_count != st.bounce_count


def pong_rollout_plain(params: EnvParams, state: EnvState, steps: int,
                       seed: int, bot_tolerance: float = 0.02,
                       tile_rows: int = SUBLANE_TILE
                       ) -> Tuple[EnvState, torch.Tensor]:
    """Step-by-step version of the kernel (same contract as
    :func:`pong_rollout`)."""
    B = state.ball_x.shape[0]
    _check_batch(B, tile_rows)
    cells = hash_cells(B, seed, tile_rows, state.ball_x.device)
    tol = float(np.float32(bot_tolerance))
    st = state
    acc = torch.zeros_like(state.ball_x)
    for i in range(steps):
        st, reward_b, _, _ = plain_step(params, st, i, cells, tol)
        acc = acc + reward_b
    return st, acc


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

# the kernel's order of the state fields (csrc/pong_env.cuh::EnvRow)
_F_FIELDS = ("ball_x", "ball_y", "ball_vx", "ball_vy", "bottom_paddle_x",
             "top_paddle_x", "spin")
_I_FIELDS = ("score_a", "score_b", "bounce_count", "t")

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "pong_kernel", "pong_rollout_launch",
    [ctypes.POINTER(EnvConsts), ctypes.POINTER(_vp), ctypes.POINTER(_vp),
     _vp, _vp, _i, _i, _i, ctypes.c_uint, ctypes.c_float, _vp],
)


# the serve angles the kernel's sine and cosine take (csrc/pong_kernel.cu::
# sincos_small, CUDA's fast path, exact below 105615 rad)
MAX_SERVE_RAD = 1e5


def check_serve_angles(params: EnvParams) -> None:
    """Refuse serve angle intervals beyond :data:`MAX_SERVE_RAD`."""
    deg = max(abs(a) for iv in params.angle_intervals for a in iv)
    if deg * math.pi / 180.0 >= MAX_SERVE_RAD:
        raise ValueError(f"serve angles up to {deg} degrees: the kernel "
                         f"takes angles below {MAX_SERVE_RAD:g} rad")


def pong_exactness_check(params: EnvParams, device) -> Tuple[int, ...]:
    """Run the kernel library's exactness check on the card: its division
    by ``m`` and by ``inertia`` against ``__fdiv_rn`` on every float, and
    its sine and cosine against ``sinf`` and ``cosf`` on every float of
    magnitude below 105615. Returns six counts of differing results: the
    two divisions where the kernel uses them, the two elsewhere (where it
    divides by ``__fdiv_rn`` instead), sine, cosine. The kernel is exact
    when the first two and the last two are 0."""
    counts = torch.zeros(6, dtype=torch.int64, device=device)
    fn = KERNEL.library_fn("pong_exactness_check",
                           [ctypes.POINTER(EnvConsts), _vp, _vp], ctypes.c_int)
    rc = fn(ctypes.byref(EnvConsts.build(params, 0)), ptr(counts),
            stream_ptr(torch.device(device)))
    if rc != 0:
        raise RuntimeError(f"pong exactness check launch failed (cudaError "
                           f"{rc})")
    return tuple(int(c) for c in counts.cpu())


def pong_rollout_cuda(params: EnvParams, state: EnvState, steps: int,
                      seed: int, bot_tolerance: float = 0.02,
                      tile_rows: int = SUBLANE_TILE
                      ) -> Tuple[EnvState, torch.Tensor]:
    """Launch the CUDA kernel; same contract as :func:`pong_rollout`. The
    kernel reads each state field where it lies (no copy) and writes the
    final state and the reward sums into one ``(8, B)`` float and one
    ``(4, B)`` int block, whose rows the returned state holds."""
    dev = state.ball_x.device
    B = state.ball_x.shape[0]
    _check_batch(B, tile_rows)
    check_serve_angles(params)
    if steps > 1 << 24:
        raise ValueError(f"steps {steps} > 2^24: the kernel's int32 "
                         f"reward sum equals the float sum up to 2^24 steps")
    if bot_tolerance < 0:
        raise ValueError(f"bot_tolerance {bot_tolerance} must be >= 0")
    for names, dtype in ((_F_FIELDS, torch.float32), (_I_FIELDS, torch.int32)):
        for n in names:
            check_cuda(n, getattr(state, n), dtype, (B,))
    f_in = (_vp * 7)(*(getattr(state, n).data_ptr() for n in _F_FIELDS))
    i_in = (_vp * 4)(*(getattr(state, n).data_ptr() for n in _I_FIELDS))
    f_out = torch.empty((8, B), dtype=torch.float32, device=dev)
    i_out = torch.empty((4, B), dtype=torch.int32, device=dev)
    KERNEL.launch(ctypes.byref(EnvConsts.build(params, 0)), f_in, i_in,
                  ptr(f_out), ptr(i_out), B, steps, tile_rows * LANE,
                  int(seed) & _M32, float(np.float32(bot_tolerance)),
                  stream_ptr(dev))
    new_state = EnvState(
        ball_x=f_out[0], ball_y=f_out[1], ball_vx=f_out[2], ball_vy=f_out[3],
        bottom_paddle_x=f_out[4], top_paddle_x=f_out[5], spin=f_out[6],
        score_a=i_out[0], score_b=i_out[1], bounce_count=i_out[2],
        t=i_out[3], done=torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    return new_state, f_out[7]


def pong_rollout(params: EnvParams, state: EnvState, steps: int, seed: int,
                 bot_tolerance: float = 0.02, tile_rows: int = SUBLANE_TILE
                 ) -> Tuple[EnvState, torch.Tensor]:
    """Run ``steps`` fused env steps on a batched ``(B,)`` state, ``B`` a
    multiple of ``tile_rows * 128``. Returns ``(final state with done all
    False, per-env reward_b sum (B,) f32)``. Runs the CUDA kernel for CUDA
    tensors and the plain version for CPU tensors."""
    fn = pong_rollout_cuda if state.ball_x.is_cuda else pong_rollout_plain
    return fn(params, state, steps, seed, bot_tolerance, tile_rows)
