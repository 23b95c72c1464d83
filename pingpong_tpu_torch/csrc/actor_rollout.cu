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

#include "pong_env.cuh"

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

  EnvRow es = load_env(f_in, i_in, B, env);
  const float pool_f = member > 0 ? 1.f : 0.f;
  float st[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int s = 0; s < T; ++s) {
    const uint32_t ctr = (uint32_t)s * 16u;
    __syncthreads();  // previous step's readers of s_wa / s_ba are done
    if (tid < H + 3) {  // the tile's factorized noise: eps_in, eps_out[0:3]
      uint32_t row = tid < H ? 0u : (uint32_t)(tid - H);
      uint32_t col = tid < H ? (uint32_t)tid : (uint32_t)H;
      const float n = hash_noise(p, seed_mix, ctr, 1, 2, row, col);
      if (tid < H) s_ein[tid] = n;
      else s_eout[tid - H] = n;
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

    const float obs[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
    float adv[3];
    mlp_adv(o_trunk, o_head + O_WAMU, o_head + O_BAMU, obs, adv);
    const int act_a = argmax3(adv);
    mlp_adv(s_learner, s_wa, s_ba, obs, adv);
    const int greedy_b = argmax3(adv);
    const float u_expl = hash_u01(seed_mix, ctr, 5, 0, lane);
    int rand_a = (int)__fmul_rn(hash_u01(seed_mix, ctr, 6, 0, lane), 3.0f);
    rand_a = rand_a < 0 ? 0 : (rand_a > 2 ? 2 : rand_a);
    const int act_b = u_expl < eps ? rand_a : greedy_b;

    // ---- env step (pong_env.cuh), emission, accounting and auto-reset
    const StepOut o = env_transition(p, es, act_a, act_b);
    if (tr_obs != nullptr) {
      const size_t r = (size_t)s * B + env;
      float* ob = tr_obs + r * 7;
      float* n = tr_next + r * 7;
#pragma unroll
      for (int i = 0; i < 7; ++i) ob[i] = obs[i];
#pragma unroll
      for (int i = 0; i < 7; ++i) n[i] = o.next[i];
      tr_act[r] = act_b;
      tr_rew[r] = o.reward_b;
      tr_done[r] = o.done ? 1 : 0;
    }
    env_account_reset(p, es, o, seed_mix, ctr, lane, pool_f, st);
  }

  store_env(es, f_out, i_out, B, env);
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
