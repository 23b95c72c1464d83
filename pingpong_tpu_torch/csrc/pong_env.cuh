// Device-side Pong env shared by the rollout kernels (actor_rollout.cu,
// recurrent_rollout.cu, pong_kernel.cu): the counter-hash RNG, the paddle
// collision, the env step, the accounting with the auto-reset serve, and a
// serve at any hash cell. A training rollout runs env_transition, emits the
// transition, then env_account_reset; the env-only rollout runs
// env_transition and, for an env that ended, env_serve.
//
// Semantics are the JAX package's fused kernels' (pingpong_tpu/ops/
// actor_rollout.py::_env_transition, ops/pong_kernel.py::_hash_uniform and
// _serve_fields, env/pong.py::step). Float ops whose rounding would change
// under FMA contraction use the _rn intrinsics, so the step rounds as the
// JAX kernels (and the port's plain versions) do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Env constants, float32-rounded on the host exactly as the JAX kernels
// bake them (ops/pong_kernel.py::EnvConsts builds the same struct).
struct EnvP {
  float ps, mf_spin, half_w, e, mu, m, R, m1e, inertia, c27, scale_up;
  float spd_lo, spd_rng, lo0, rng0, lo1, rng1, deg2rad, spin_lo, spin_rng;
  float u1_lo, u1_rng, two_pi;
  int max_score, speed_scale_every, max_episode_steps;
};

// One env's dynamic state and its running return.
struct EnvRow {
  float x, y, vx, vy, bot, top, spin, ret;
  int sa, sb, bc, t;
};

__device__ __forceinline__ float hash_u01(uint32_t seed, uint32_t ctr,
                                          uint32_t k, uint32_t row,
                                          uint32_t col) {
  uint32_t x = seed + ctr * 2654435761u + k * 0x9E3779B9u + row * 40503u +
               col * 69069u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
  }
  return __fmul_rn(__uint2float_rn(x), 2.3283064365386963e-10f);  // 2^-32
}

__device__ __forceinline__ float affine(float lo, float u, float rng) {
  return __fadd_rn(lo, __fmul_rn(u, rng));
}

__device__ __forceinline__ float scale_noise(float x) {
  float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return __fmul_rn(s, sqrtf(fabsf(x)));
}

// f(N(0,1)) from the hash at (k_u1, k_u2) of one grid cell: Box-Muller,
// cos half only, then sign(x) sqrt|x|.
__device__ __forceinline__ float hash_noise(const EnvP& p, uint32_t seed,
                                            uint32_t ctr, uint32_t k_u1,
                                            uint32_t k_u2, uint32_t row,
                                            uint32_t col) {
  float u1 = affine(p.u1_lo, hash_u01(seed, ctr, k_u1, row, col), p.u1_rng);
  float u2 = hash_u01(seed, ctr, k_u2, row, col);
  float nrm = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                        cosf(__fmul_rn(p.two_pi, u2)));
  return scale_noise(nrm);
}

// argmax of three, ties to the lowest index by strict '>'
__device__ __forceinline__ int argmax3(const float* a) {
  int i01 = a[1] > a[0] ? 1 : 0;
  return a[2] > fmaxf(a[0], a[1]) ? 2 : i01;
}

__device__ __forceinline__ void collide(const EnvP& p, float vn, float vt,
                                        float u, float omega, float& vn_post,
                                        float& vt_post, float& om_post) {
  vn_post = __fmul_rn(-p.e, vn);
  float jn = __fmul_rn(p.m1e, fabsf(vn));
  float r_om = __fmul_rn(p.R, omega);
  float jt_star = __fmul_rn(p.c27, __fsub_rn(__fadd_rn(u, r_om), vt));
  float max_fi = __fmul_rn(p.mu, jn);
  float vrel = __fsub_rn(__fsub_rn(vt, u), r_om);
  float sign = vrel >= 0.f ? 1.f : -1.f;
  float jt = fabsf(jt_star) <= max_fi ? jt_star : __fmul_rn(-max_fi, sign);
  vt_post = __fadd_rn(vt, __fdiv_rn(jt, p.m));
  om_post = __fsub_rn(omega, __fdiv_rn(__fmul_rn(p.R, jt), p.inertia));
}

// The outcome of one env step before accounting and reset: player B's
// next observation [x, y, vx, vy, bot, top, spin], the reward and done of
// the step, and the scores, bounce count and step count it leads to.
struct StepOut {
  float next[7];
  float reward_b;
  bool done;
  int sa, sb, bc, t;
};

// One env step (pingpong_tpu/env/pong.py::step) with the
// max_episode_steps cap.
__device__ __forceinline__ StepOut env_transition(const EnvP& p,
                                                  const EnvRow& s, int act_a,
                                                  int act_b) {
  StepOut o;
  const float u_a = __fmul_rn((float)act_a - 1.0f, p.ps);
  const float u_b = __fmul_rn((float)act_b - 1.0f, p.ps);
  const float ntop = fminf(fmaxf(s.top + u_a, 0.f), 1.f);
  const float nbot = fminf(fmaxf(s.bot + u_b, 0.f), 1.f);
  float nvx = __fadd_rn(s.vx, __fmul_rn(__fmul_rn(p.mf_spin, s.spin), s.vy));
  float nvy = s.vy;
  float nx = s.x + nvx;
  float ny = s.y + nvy;
  const bool hl = nx < 0.f, hr = nx > 1.f;
  nx = hl ? -nx : (hr ? 2.0f - nx : nx);
  nvx = (hl || hr) ? -nvx : nvx;

  const bool cross_top = ny < 0.f;
  const bool in_top = (ntop - p.half_w <= nx) && (nx <= ntop + p.half_w);
  const bool hit_top = cross_top && in_top, miss_top = cross_top && !in_top;
  const bool cross_bot = ny > 1.f;
  const bool in_bot = (nbot - p.half_w <= nx) && (nx <= nbot + p.half_w);
  const bool hit_bot = cross_bot && in_bot, miss_bot = cross_bot && !in_bot;
  float nspin = s.spin;
  if (hit_top) {
    collide(p, nvy, nvx, u_a, s.spin, nvy, nvx, nspin);
    ny = 0.f;
  } else if (hit_bot) {
    float vn_b;
    collide(p, -nvy, nvx, u_b, s.spin, vn_b, nvx, nspin);
    nvy = -vn_b;
    ny = 1.f;
  }
  const bool hit_any = hit_top || hit_bot;
  o.bc = s.bc + (hit_any ? 1 : 0);
  if (hit_any && o.bc % p.speed_scale_every == 0) {
    nvx = __fmul_rn(nvx, p.scale_up);
    nvy = __fmul_rn(nvy, p.scale_up);
  }
  o.reward_b = (miss_top ? 1.f : 0.f) - (miss_bot ? 1.f : 0.f);
  o.sa = s.sa + (miss_bot ? 1 : 0);
  o.sb = s.sb + (miss_top ? 1 : 0);
  o.t = s.t + 1;
  o.done = o.sa >= p.max_score || o.sb >= p.max_score ||
           (p.max_episode_steps > 0 && o.t >= p.max_episode_steps);
  o.next[0] = nx; o.next[1] = ny; o.next[2] = nvx; o.next[3] = nvy;
  o.next[4] = nbot; o.next[5] = ntop; o.next[6] = nspin;
  return o;
}

// The accounting rows st[0:7] = [games/wins vs A, games/wins vs pool,
// return sum, ended, draws] of a step, then s <- the step's outcome, or a
// fresh episode with an in-kernel serve (hash counter ctr + 8, column =
// lane) when it ended.
__device__ __forceinline__ void env_account_reset(const EnvP& p, EnvRow& s,
                                                  const StepOut& o,
                                                  uint32_t seed_mix,
                                                  uint32_t ctr, uint32_t lane,
                                                  float pool_f, float* st) {
  const float ep_ret = s.ret + o.reward_b;
  const float d_f = o.done ? 1.f : 0.f;
  const float w_f = (o.done && ep_ret > 0.f) ? 1.f : 0.f;
  st[0] += d_f * (1.f - pool_f);
  st[1] += w_f * (1.f - pool_f);
  st[2] += d_f * pool_f;
  st[3] += w_f * pool_f;
  st[4] += o.done ? ep_ret : 0.f;
  st[5] += d_f;
  st[6] += (o.done && ep_ret == 0.f) ? 1.f : 0.f;

  if (o.done) {
    const uint32_t c2 = ctr + 8u;
    const float speed = affine(p.spd_lo, hash_u01(seed_mix, c2, 1, 0, lane), p.spd_rng);
    const bool pick = hash_u01(seed_mix, c2, 2, 0, lane) >= 0.5f;
    const float ua = hash_u01(seed_mix, c2, 3, 0, lane);
    float ang = pick ? affine(p.lo1, ua, p.rng1) : affine(p.lo0, ua, p.rng0);
    ang = __fmul_rn(ang, p.deg2rad);
    s.spin = affine(p.spin_lo, hash_u01(seed_mix, c2, 4, 0, lane), p.spin_rng);
    s.vx = __fmul_rn(speed, cosf(ang));
    s.vy = __fmul_rn(speed, sinf(ang));
    s.x = 0.5f; s.y = 0.5f; s.bot = 0.5f; s.top = 0.5f; s.ret = 0.f;
    s.sa = 0; s.sb = 0; s.bc = 0; s.t = 0;
  } else {
    s.x = o.next[0]; s.y = o.next[1]; s.vx = o.next[2]; s.vy = o.next[3];
    s.bot = o.next[4]; s.top = o.next[5]; s.spin = o.next[6]; s.ret = ep_ret;
    s.sa = o.sa; s.sb = o.sb; s.bc = o.bc; s.t = o.t;
  }
}

// A serve's (vx, vy, spin) (pingpong_tpu/ops/pong_kernel.py::_serve_fields)
// from the hash at k = 1..4 (speed, side pick, angle, spin) of the cell
// (seed_mix, ctr, row, col).
__device__ __forceinline__ void env_serve(const EnvP& p, uint32_t seed_mix,
                                          uint32_t ctr, uint32_t row,
                                          uint32_t col, float& vx, float& vy,
                                          float& spin) {
  const float speed =
      affine(p.spd_lo, hash_u01(seed_mix, ctr, 1, row, col), p.spd_rng);
  const bool pick = hash_u01(seed_mix, ctr, 2, row, col) >= 0.5f;
  const float ua = hash_u01(seed_mix, ctr, 3, row, col);
  float ang = pick ? affine(p.lo1, ua, p.rng1) : affine(p.lo0, ua, p.rng0);
  ang = __fmul_rn(ang, p.deg2rad);
  spin = affine(p.spin_lo, hash_u01(seed_mix, ctr, 4, row, col), p.spin_rng);
  vx = __fmul_rn(speed, cosf(ang));
  vy = __fmul_rn(speed, sinf(ang));
}

// Load / store one env's row from the (8, B) float and (>= 4, B) int blocks
// in the order [x, y, vx, vy, bot, top, spin, ret] and [sa, sb, bc, t].
__device__ __forceinline__ EnvRow load_env(const float* f_in, const int* i_in,
                                           int B, int env) {
  EnvRow s;
  s.x = f_in[0 * B + env]; s.y = f_in[1 * B + env];
  s.vx = f_in[2 * B + env]; s.vy = f_in[3 * B + env];
  s.bot = f_in[4 * B + env]; s.top = f_in[5 * B + env];
  s.spin = f_in[6 * B + env]; s.ret = f_in[7 * B + env];
  s.sa = i_in[0 * B + env]; s.sb = i_in[1 * B + env];
  s.bc = i_in[2 * B + env]; s.t = i_in[3 * B + env];
  return s;
}

__device__ __forceinline__ void store_env(const EnvRow& s, float* f_out,
                                          int* i_out, int B, int env) {
  f_out[0 * B + env] = s.x; f_out[1 * B + env] = s.y;
  f_out[2 * B + env] = s.vx; f_out[3 * B + env] = s.vy;
  f_out[4 * B + env] = s.bot; f_out[5 * B + env] = s.top;
  f_out[6 * B + env] = s.spin; f_out[7 * B + env] = s.ret;
  i_out[0 * B + env] = s.sa; i_out[1 * B + env] = s.sb;
  i_out[2 * B + env] = s.bc; i_out[3 * B + env] = s.t;
}
