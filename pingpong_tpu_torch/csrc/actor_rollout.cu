// Fused DQN actor rollout: one launch runs a whole rollout chunk.
//
// Replaces the TPU kernel pingpong_tpu/ops/actor_rollout.py::
// pallas_actor_rollout (bodies _actor_kernel_grid / _actor_kernel, step
// _one_step, env transition _env_transition). Per env and step: the bound
// opponent's greedy action (mu weights, mirror folded into layer 1 at pack
// time), the learner's NoisyNet + epsilon-greedy action from the advantage
// head, the env step, auto-reset with a counter-hash serve, the
// max_episode_steps cap, transition emission and the episode statistics.
//
// What bounds it on an H100: arithmetic. Each env-step runs two
// 7->64->64->3 forwards, about 19 kFLOP, against 56 bytes of transition
// output, so the chunk is FLOP-bound (a few GFLOP against ~18 MB). The
// design keeps every byte of state on chip: one thread per env holds its
// env state, statistics and first hidden layer in registers for all T
// steps; the learner's net and, when a block's envs are all bound to one
// opponent (envs are sorted or bucketed by opponent), that opponent's net
// sit in shared memory and are read as warp-wide broadcasts. HBM sees the
// state once in, once out, and the transitions. It is a simple first
// design: a thread runs its forwards serially, and 4096 envs give only 32
// blocks of 128 threads, so most of the card idles (see PERF.md).
//
// Semantics kept from the TPU kernel: the learner's head noise is one
// factorized draw per (tile of tile_rows envs, step), shared by the tile;
// epsilon arrives as int32(eps * 1e6); argmax ties go to the lowest index
// by strict '>'; the random draws are the JAX interpreter's counter hash
// (ops/pong_kernel.py::_hash_uniform) with seed_mix = seed ^ (tile *
// 747796405) and ctr = 16 * step, so kernel, plain version and the JAX
// kernel in interpret mode draw identical bits. Float ops whose rounding
// would change under FMA contraction in the env step, the serve and the
// noise use the _rn intrinsics; the forwards use FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

// Env constants, float32-rounded on the host exactly as the JAX kernels
// bake them (ops/actor_rollout.py::EnvConsts builds the same struct).
struct EnvP {
  float ps, mf_spin, half_w, e, mu, m, R, m1e, inertia, c27, scale_up;
  float spd_lo, spd_rng, lo0, rng0, lo1, rng1, deg2rad, spin_lo, spin_rng;
  float u1_lo, u1_rng, two_pi;
  int max_score, speed_scale_every, max_episode_steps;
};

namespace {

constexpr int H = 64;
// packed net layout (floats): w1t (64,8) b1t (64) w2t (64,64) b2t (64)
// wat_mu (8,64) bat_mu (8) wat_sigma (8,64) bat_sigma (8)
constexpr int O_W1T = 0;
constexpr int O_B1T = 512;
constexpr int O_W2T = 576;
constexpr int O_B2T = 4672;
constexpr int O_WAMU = 4736;
constexpr int O_BAMU = 5248;
constexpr int O_WASIG = 5256;
constexpr int O_BASIG = 5768;
constexpr int NET = 5776;
constexpr int THREADS = 128;

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

// 7 -> 64 -> 64 -> 3 advantage forward; trunk/head may live in shared or
// global memory (generic pointers)
__device__ __forceinline__ void mlp_adv(const float* trunk, const float* wa,
                                        const float* ba, const float* obs,
                                        float* adv) {
  float h1[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i) acc = fmaf(trunk[O_W1T + j * 8 + i], obs[i], acc);
    h1[j] = fmaxf(acc + trunk[O_B1T + j], 0.f);
  }
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 2
  for (int j = 0; j < H; ++j) {
    const float* w = trunk + O_W2T + j * H;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) acc = fmaf(w[i], h1[i], acc);
    float h2 = fmaxf(acc + trunk[O_B2T + j], 0.f);
    a0 = fmaf(wa[j], h2, a0);
    a1 = fmaf(wa[H + j], h2, a1);
    a2 = fmaf(wa[2 * H + j], h2, a2);
  }
  adv[0] = a0 + ba[0];
  adv[1] = a1 + ba[1];
  adv[2] = a2 + ba[2];
}

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

__device__ __forceinline__ float scale_noise(float x) {
  float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return __fmul_rn(s, sqrtf(fabsf(x)));
}

__global__ void __launch_bounds__(THREADS)
actor_rollout_kernel(EnvP p, const float* __restrict__ f_in,
                     const int* __restrict__ i_in,
                     const float* __restrict__ learner,
                     const float* __restrict__ opp, int shared_trunk,
                     float* __restrict__ f_out, int* __restrict__ i_out,
                     float* __restrict__ tr_obs, float* __restrict__ tr_next,
                     int* __restrict__ tr_act, float* __restrict__ tr_rew,
                     int* __restrict__ tr_done, float* __restrict__ stats,
                     int B, int T, int tile_rows, uint32_t seed, int eps_i) {
  __shared__ float s_learner[NET];
  __shared__ float s_opp[O_WASIG];
  __shared__ float s_wa[3 * H];
  __shared__ float s_ba[3];
  __shared__ float s_ein[H];
  __shared__ float s_eout[3];

  const int tid = threadIdx.x;
  const int env = blockIdx.x * THREADS + tid;
  const int gtile = env / tile_rows;
  const uint32_t lane = (uint32_t)(env % tile_rows);
  // every thread of a block lies in the same tile (tile_rows % THREADS == 0)
  const uint32_t seed_mix = seed ^ ((uint32_t)gtile * 747796405u);
  const float eps = __fmul_rn(__int2float_rn(eps_i), 1e-6f);

  const int member = i_in[4 * B + env];
  const int first = i_in[4 * B + blockIdx.x * THREADS];
  const bool uniform = __syncthreads_and(member == first);

  for (int i = tid; i < NET; i += THREADS) s_learner[i] = learner[i];
  if (uniform) {
    for (int i = tid; i < O_WASIG; i += THREADS)
      s_opp[i] = (shared_trunk && i < O_WAMU) ? opp[i]
                                              : opp[(size_t)first * NET + i];
  }
  const float* o_head = uniform ? s_opp : opp + (size_t)member * NET;
  const float* o_trunk = uniform ? s_opp : (shared_trunk ? opp : o_head);

  float x = f_in[0 * B + env], y = f_in[1 * B + env];
  float vx = f_in[2 * B + env], vy = f_in[3 * B + env];
  float bot = f_in[4 * B + env], top = f_in[5 * B + env];
  float spin = f_in[6 * B + env], ret = f_in[7 * B + env];
  int sa = i_in[0 * B + env], sb = i_in[1 * B + env];
  int bc = i_in[2 * B + env], t = i_in[3 * B + env];
  const float pool_f = member > 0 ? 1.f : 0.f;
  float st[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int s = 0; s < T; ++s) {
    const uint32_t ctr = (uint32_t)s * 16u;
    __syncthreads();  // previous step's readers of s_wa / s_ba are done
    if (tid < H + 3) {  // the tile's factorized noise: eps_in, eps_out[0:3]
      uint32_t row = tid < H ? 0u : (uint32_t)(tid - H);
      uint32_t col = tid < H ? (uint32_t)tid : (uint32_t)H;
      float u1 = affine(p.u1_lo, hash_u01(seed_mix, ctr, 1, row, col), p.u1_rng);
      float u2 = hash_u01(seed_mix, ctr, 2, row, col);
      float nrm = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                            cosf(__fmul_rn(p.two_pi, u2)));
      if (tid < H) s_ein[tid] = scale_noise(nrm);
      else s_eout[tid - H] = scale_noise(nrm);
    }
    __syncthreads();
    for (int i = tid; i < 3 * H; i += THREADS) {
      int a = i / H, j = i % H;
      s_wa[i] = __fadd_rn(s_learner[O_WAMU + i],
                          __fmul_rn(s_learner[O_WASIG + i],
                                    __fmul_rn(s_eout[a], s_ein[j])));
    }
    if (tid < 3)
      s_ba[tid] = __fadd_rn(s_learner[O_BAMU + tid],
                            __fmul_rn(s_learner[O_BASIG + tid], s_eout[tid]));
    __syncthreads();

    const float obs[7] = {x, y, vx, vy, bot, top, spin};
    float adv[3];
    mlp_adv(o_trunk, o_head + O_WAMU, o_head + O_BAMU, obs, adv);
    const int act_a = argmax3(adv);
    mlp_adv(s_learner, s_wa, s_ba, obs, adv);
    const int greedy_b = argmax3(adv);
    const float u_expl = hash_u01(seed_mix, ctr, 5, 0, lane);
    int rand_a = (int)__fmul_rn(hash_u01(seed_mix, ctr, 6, 0, lane), 3.0f);
    rand_a = rand_a < 0 ? 0 : (rand_a > 2 ? 2 : rand_a);
    const int act_b = u_expl < eps ? rand_a : greedy_b;

    // ---- env step (pingpong_tpu/env/pong.py::step)
    const float u_a = __fmul_rn((float)act_a - 1.0f, p.ps);
    const float u_b = __fmul_rn((float)act_b - 1.0f, p.ps);
    const float ntop = fminf(fmaxf(top + u_a, 0.f), 1.f);
    const float nbot = fminf(fmaxf(bot + u_b, 0.f), 1.f);
    float nvx = __fadd_rn(vx, __fmul_rn(__fmul_rn(p.mf_spin, spin), vy));
    float nvy = vy;
    float nx = x + nvx;
    float ny = y + nvy;
    const bool hl = nx < 0.f, hr = nx > 1.f;
    nx = hl ? -nx : (hr ? 2.0f - nx : nx);
    nvx = (hl || hr) ? -nvx : nvx;

    const bool cross_top = ny < 0.f;
    const bool in_top = (ntop - p.half_w <= nx) && (nx <= ntop + p.half_w);
    const bool hit_top = cross_top && in_top, miss_top = cross_top && !in_top;
    const bool cross_bot = ny > 1.f;
    const bool in_bot = (nbot - p.half_w <= nx) && (nx <= nbot + p.half_w);
    const bool hit_bot = cross_bot && in_bot, miss_bot = cross_bot && !in_bot;
    float nspin = spin;
    if (hit_top) {
      collide(p, nvy, nvx, u_a, spin, nvy, nvx, nspin);
      ny = 0.f;
    } else if (hit_bot) {
      float vn_b;
      collide(p, -nvy, nvx, u_b, spin, vn_b, nvx, nspin);
      nvy = -vn_b;
      ny = 1.f;
    }
    const bool hit_any = hit_top || hit_bot;
    const int nbc = bc + (hit_any ? 1 : 0);
    if (hit_any && nbc % p.speed_scale_every == 0) {
      nvx = __fmul_rn(nvx, p.scale_up);
      nvy = __fmul_rn(nvy, p.scale_up);
    }
    const float reward_b = (miss_top ? 1.f : 0.f) - (miss_bot ? 1.f : 0.f);
    const int nsa = sa + (miss_bot ? 1 : 0);
    const int nsb = sb + (miss_top ? 1 : 0);
    const int nt = t + 1;
    const bool done = nsa >= p.max_score || nsb >= p.max_score ||
                      (p.max_episode_steps > 0 && nt >= p.max_episode_steps);

    if (tr_obs != nullptr) {
      const size_t r = (size_t)s * B + env;
      float* o = tr_obs + r * 7;
      float* n = tr_next + r * 7;
#pragma unroll
      for (int i = 0; i < 7; ++i) o[i] = obs[i];
      n[0] = nx; n[1] = ny; n[2] = nvx; n[3] = nvy;
      n[4] = nbot; n[5] = ntop; n[6] = nspin;
      tr_act[r] = act_b;
      tr_rew[r] = reward_b;
      tr_done[r] = done ? 1 : 0;
    }

    // ---- accounting: [games/wins vs A, games/wins vs pool, ret sum,
    // ended, draws]
    const float ep_ret = ret + reward_b;
    const float d_f = done ? 1.f : 0.f;
    const float w_f = (done && ep_ret > 0.f) ? 1.f : 0.f;
    st[0] += d_f * (1.f - pool_f);
    st[1] += w_f * (1.f - pool_f);
    st[2] += d_f * pool_f;
    st[3] += w_f * pool_f;
    st[4] += done ? ep_ret : 0.f;
    st[5] += d_f;
    st[6] += (done && ep_ret == 0.f) ? 1.f : 0.f;

    if (done) {  // auto-reset with an in-kernel serve (ctr + 8)
      const uint32_t c2 = ctr + 8u;
      const float speed = affine(p.spd_lo, hash_u01(seed_mix, c2, 1, 0, lane), p.spd_rng);
      const bool pick = hash_u01(seed_mix, c2, 2, 0, lane) >= 0.5f;
      const float ua = hash_u01(seed_mix, c2, 3, 0, lane);
      float ang = pick ? affine(p.lo1, ua, p.rng1) : affine(p.lo0, ua, p.rng0);
      ang = __fmul_rn(ang, p.deg2rad);
      spin = affine(p.spin_lo, hash_u01(seed_mix, c2, 4, 0, lane), p.spin_rng);
      vx = __fmul_rn(speed, cosf(ang));
      vy = __fmul_rn(speed, sinf(ang));
      x = 0.5f; y = 0.5f; bot = 0.5f; top = 0.5f; ret = 0.f;
      sa = 0; sb = 0; bc = 0; t = 0;
    } else {
      x = nx; y = ny; vx = nvx; vy = nvy; bot = nbot; top = ntop;
      spin = nspin; ret = ep_ret;
      sa = nsa; sb = nsb; bc = nbc; t = nt;
    }
  }

  f_out[0 * B + env] = x; f_out[1 * B + env] = y;
  f_out[2 * B + env] = vx; f_out[3 * B + env] = vy;
  f_out[4 * B + env] = bot; f_out[5 * B + env] = top;
  f_out[6 * B + env] = spin; f_out[7 * B + env] = ret;
  i_out[0 * B + env] = sa; i_out[1 * B + env] = sb;
  i_out[2 * B + env] = bc; i_out[3 * B + env] = t;
  i_out[4 * B + env] = member;
#pragma unroll
  for (int r = 0; r < 7; ++r) stats[r * B + env] = st[r];
  stats[7 * B + env] = 0.f;
}

}  // namespace

extern "C" {

// Launch one rollout chunk on `stream`. B % 128 == 0 and
// tile_rows % 128 == 0 (checked by the Python wrapper). Transition
// pointers may all be null (eval mode). Returns the cudaError_t of the
// launch.
int actor_rollout_launch(const EnvP* p, const float* f_in, const int* i_in,
                         const float* learner, const float* opp,
                         int shared_trunk, float* f_out, int* i_out,
                         float* tr_obs, float* tr_next, int* tr_act,
                         float* tr_rew, int* tr_done, float* stats, int B,
                         int T, int tile_rows, unsigned int seed, int eps_i,
                         cudaStream_t stream) {
  actor_rollout_kernel<<<B / THREADS, THREADS, 0, stream>>>(
      *p, f_in, i_in, learner, opp, shared_trunk, f_out, i_out, tr_obs,
      tr_next, tr_act, tr_rew, tr_done, stats, B, T, tile_rows, seed, eps_i);
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
