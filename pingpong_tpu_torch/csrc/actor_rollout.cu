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
// first design ran one thread an env, each forward serially, 4096 envs in
// 32 blocks of 128 threads: most of the card idled. Here a block of 128
// threads takes 16 envs (4096 envs -> 256 blocks, two or more an SM, so
// one block's env step overlaps another's forwards), the opponent's
// forward on warps 0-1 and the learner's on warps 2-3, and
// each net's layers are register tiles of 4 hidden units x 4 envs a
// thread: layer 1 into shared memory, layer 2 from float4 loads of the
// weights (stored input-major, 4 units a load) and of h1 (4 envs a load),
// 16 FMAs per two 16-byte loads. The A head's partial sums over a thread's
// 4 units are reduced over the 16 unit lanes with shuffles in a fixed
// order, so a run is reproducible bit for bit. Env state and statistics
// stay in the registers of threads 0-31 for all T steps; HBM sees the
// state once in, once out, and the transitions.
//
// Opponents: when a block's envs are all bound to one member, or every
// member shares slot 0's trunk (the heads-only pool), the trunk sits in
// shared memory; a uniform block's head does too, a mixed block reads each
// env's member head from global memory (L1). A mixed block of full members
// runs a member loop from global memory with layer 1 computed on the fly,
// masked per env (the TPU kernel's [lo, hi] loop); bucketed binding makes
// such blocks rare.
//
// Semantics kept from the TPU kernel: the learner's head noise is one
// factorized draw per (tile of tile_rows envs, step), shared by the tile
// (a block's 16 envs lie in one tile: tile_rows % 16 == 0); epsilon
// arrives as int32(eps * 1e6); argmax ties go to the lowest index by
// strict '>'; the random draws are the JAX interpreter's counter hash
// (ops/pong_kernel.py::_hash_uniform) with seed_mix = seed ^ (global tile
// * 747796405) and ctr = 16 * step, so kernel, plain version and the JAX
// kernel in interpret mode draw identical bits. Float ops whose rounding
// would change under FMA contraction in the env step, the serve and the
// noise use the _rn intrinsics; the forwards use FMAs.

#include "pong_env.cuh"

namespace {

constexpr int H = 64;
// packed net layout (floats, ops/actor_rollout.py::packed_flat): w1t (64,8)
// b1t (64) w2 (64 in, 64 out) b2t (64) wat_mu (8,64) bat_mu (8)
// wat_sigma (8,64) bat_sigma (8)
constexpr int O_W1T = 0;
constexpr int O_B1T = 512;
constexpr int O_W2 = 576;
constexpr int O_B2T = 4672;
constexpr int O_WAMU = 4736;
constexpr int O_BAMU = 5248;
constexpr int O_WASIG = 5256;
constexpr int O_BASIG = 5768;
constexpr int NET = 5776;
constexpr int EB = 16;               // envs a block
constexpr int NET_THREADS = 4 * EB;  // 16 unit groups x EB / 4 env quads
constexpr int THREADS = 2 * NET_THREADS;   // opponent, then learner

struct Smem {
  float* learner;   // NET
  float* opp;       // O_WASIG: trunk (+ head when the block is uniform)
  float* h1;        // [2][64][EB]
  float* wa;        // [3][64] this step's noisy learner A head
  float* ba;        // [4]
  float* ein;       // [64]
  float* eout;      // [4]
  float* obs;       // [8][EB]
  float* adv;       // [2][3][EB]
  int* member;      // [EB]
  static constexpr size_t floats =
      NET + O_WASIG + 2 * H * EB + 3 * H + 4 + H + 4 + 8 * EB + 6 * EB;
  static constexpr size_t bytes = floats * sizeof(float) + EB * sizeof(int);

  __device__ explicit Smem(float* q) {
    learner = q; q += NET;
    opp = q; q += O_WASIG;
    h1 = q; q += 2 * H * EB;
    wa = q; q += 3 * H;
    ba = q; q += 4;
    ein = q; q += H;
    eout = q; q += 4;
    obs = q; q += 8 * EB;
    adv = q; q += 6 * EB;
    member = reinterpret_cast<int*>(q);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// h1 of units 4u..4u+3 for envs 4q..4q+3 into shared memory, from the
// thread's rows of layer 1 held in registers (w1[unit][input], b1[unit])
__device__ __forceinline__ void layer1(const float (*w1)[7], const float* b1,
                                       const float* obs, int u, int q,
                                       float* h1) {
  float o[7][4];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float4 v = ld4(obs + i * EB + 4 * q);
    o[i][0] = v.x; o[i][1] = v.y; o[i][2] = v.z; o[i][3] = v.w;
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = fmaf(w1[jj][i], o[i][e], a[e]);
    *reinterpret_cast<float4*>(h1 + (4 * u + jj) * EB + 4 * q) =
        make_float4(fmaxf(a[0] + b1[jj], 0.f), fmaxf(a[1] + b1[jj], 0.f),
                    fmaxf(a[2] + b1[jj], 0.f), fmaxf(a[3] + b1[jj], 0.f));
  }
}

// h2 of units 4u..4u+3 for envs 4q..4q+3 from h1 in shared memory:
// acc[4 * unit + env]
__device__ __forceinline__ void layer2(const float* trunk, const float* h1,
                                       int u, int q, float* acc) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float4 w = ld4(trunk + O_W2 + k * H + 4 * u);
    const float4 v = ld4(h1 + k * EB + 4 * q);
    const float wv[4] = {w.x, w.y, w.z, w.w};
    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * jj + e] = fmaf(wv[jj], xv[e], acc[4 * jj + e]);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float b = trunk[O_B2T + 4 * u + jj];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * jj + e] = fmaxf(acc[4 * jj + e] + b, 0.f);
  }
}

// The same h2 from global memory, layer 1 computed on the fly per input
// unit (the mixed-member loop of full nets).
__device__ __forceinline__ void trunk_global(const float* __restrict__ trunk,
                                             const float* obs, int u, int q,
                                             float* acc) {
  float o[7][4];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float4 v = ld4(obs + i * EB + 4 * q);
    o[i][0] = v.x; o[i][1] = v.y; o[i][2] = v.z; o[i][3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int k = 0; k < H; ++k) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const float w = __ldg(trunk + O_W1T + k * 8 + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = fmaf(w, o[i][e], a[e]);
    }
    const float b1 = __ldg(trunk + O_B1T + k);
    float h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = fmaxf(a[e] + b1, 0.f);
    const float4 w = __ldg(reinterpret_cast<const float4*>(trunk + O_W2 + k * H + 4 * u));
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * jj + e] = fmaf(wv[jj], h[e], acc[4 * jj + e]);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float b = __ldg(trunk + O_B2T + 4 * u + jj);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * jj + e] = fmaxf(acc[4 * jj + e] + b, 0.f);
  }
}

// partial advantages over units 4u..4u+3: pa[4 * action + env] for the
// envs whose head is `head[env]` (wa (8, 64) then ba follows at +512)
__device__ __forceinline__ void head_partial(const float* const* head,
                                             const float* h2, int u,
                                             const bool* keep, float* pa) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!keep[e]) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float s = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        s = fmaf(head[e][a * H + 4 * u + jj], h2[4 * jj + e], s);
      pa[4 * a + e] = s;
    }
  }
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
                     int B, int T, int tile_rows, int tile0, uint32_t seed,
                     int eps_i) {
  extern __shared__ float4 smem4[];
  const Smem sm(reinterpret_cast<float*>(smem4));
  const int tid = threadIdx.x;
  const int net = tid / NET_THREADS;   // 0 opponent, 1 learner
  const int li = tid % NET_THREADS;
  const int u = li & 15, q = li >> 4;   // unit group, env quad
  const int env0 = blockIdx.x * EB;
  // every env of a block lies in one tile (tile_rows % EB == 0); the hash
  // is keyed by the global tile, tile0 + local tile (a rank's first tile)
  const uint32_t seed_mix =
      seed ^ ((uint32_t)(tile0 + env0 / tile_rows) * 747796405u);
  const float eps = __fmul_rn(__int2float_rn(eps_i), 1e-6f);

  if (tid < EB) sm.member[tid] = i_in[4 * B + env0 + tid];
  __syncthreads();
  const int first = sm.member[0];
  int lo = first, hi = first;
  for (int e = 1; e < EB; ++e) {
    lo = min(lo, sm.member[e]);
    hi = max(hi, sm.member[e]);
  }
  const bool uniform = lo == hi;
  const bool staged = uniform || shared_trunk;
  for (int i = tid; i < NET; i += THREADS) sm.learner[i] = learner[i];
  if (staged) {
    for (int i = tid; i < O_WASIG; i += THREADS) {
      const bool trunk = i < O_WAMU;
      if (trunk || uniform)
        sm.opp[i] = opp[(size_t)(trunk && shared_trunk ? 0 : first) * NET + i];
    }
  }
  __syncthreads();
  // this thread's rows of layer 1 stay in registers
  float w1r[4][7], b1r[4];
  {
    const float* tr = net == 1 ? sm.learner : sm.opp;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int i = 0; i < 7; ++i)
        w1r[jj][i] = (net == 1 || staged) ? tr[O_W1T + (4 * u + jj) * 8 + i] : 0.f;
      b1r[jj] = (net == 1 || staged) ? tr[O_B1T + 4 * u + jj] : 0.f;
    }
  }
  // each env's opponent head: shared memory when uniform, else its member's
  const float* o_head[4];
  bool keep_all[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o_head[e] = uniform ? sm.opp + O_WAMU
                        : opp + (size_t)sm.member[4 * q + e] * NET + O_WAMU;
    keep_all[e] = true;
  }

  const bool env_thread = tid < EB;
  const int env = env0 + (env_thread ? tid : 0);
  const uint32_t lane = (uint32_t)(env % tile_rows);
  EnvRow es = load_env(f_in, i_in, B, env);
  const float pool_f = sm.member[env - env0] > 0 ? 1.f : 0.f;
  float st[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (env_thread) {
    const float o7[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
#pragma unroll
    for (int i = 0; i < 7; ++i) sm.obs[i * EB + tid] = o7[i];
  }

  for (int s = 0; s < T; ++s) {
    const uint32_t ctr = (uint32_t)s * 16u;
    for (int i = li; net == 1 && i < H + 3; i += NET_THREADS) {
      // the tile's factorized noise
      const uint32_t row = i < H ? 0u : (uint32_t)(i - H);
      const uint32_t col = i < H ? (uint32_t)i : (uint32_t)H;
      const float n = hash_noise(p, seed_mix, ctr, 1, 2, row, col);
      if (i < H) sm.ein[i] = n;
      else sm.eout[i - H] = n;
    }
    __syncthreads();   // obs and noise of this step

    float* h1 = sm.h1 + net * H * EB;
    if (net == 1 || staged) layer1(w1r, b1r, sm.obs, u, q, h1);
    if (net == 1) {
      for (int i = li; i < 3 * H + 3; i += NET_THREADS) {
        if (i < 3 * H) {
          const int a = i / H, j = i % H;
          sm.wa[i] = __fadd_rn(sm.learner[O_WAMU + i],
                               __fmul_rn(sm.learner[O_WASIG + i],
                                         __fmul_rn(sm.eout[a], sm.ein[j])));
        } else {
          const int a = i - 3 * H;
          sm.ba[a] = __fadd_rn(sm.learner[O_BAMU + a],
                               __fmul_rn(sm.learner[O_BASIG + a], sm.eout[a]));
        }
      }
    }
    __syncthreads();   // h1 of both nets, the noisy A head

    float pa[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) pa[i] = 0.f;
    float h2[16];
    if (net == 1) {
      layer2(sm.learner, h1, u, q, h2);
      const float* lh[4] = {sm.wa, sm.wa, sm.wa, sm.wa};
      head_partial(lh, h2, u, keep_all, pa);
    } else if (staged) {
      layer2(sm.opp, h1, u, q, h2);
      head_partial(o_head, h2, u, keep_all, pa);
    } else {
      for (int m = lo; m <= hi; ++m) {
        bool keep[4], any = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          keep[e] = sm.member[4 * q + e] == m;
          any |= keep[e];
        }
        if (!any) continue;
        trunk_global(opp + (size_t)m * NET, sm.obs, u, q, h2);
        head_partial(o_head, h2, u, keep, pa);
      }
    }
    // sum over the 16 unit lanes of the quad, a fixed butterfly
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 12; ++i)
        pa[i] += __shfl_xor_sync(0xffffffffu, pa[i], off);
    if (u == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float b = net == 1 ? sm.ba[a] : o_head[e][512 + a];
          sm.adv[(net * 3 + a) * EB + 4 * q + e] = pa[4 * a + e] + b;
        }
    }
    __syncthreads();   // advantages of both nets

    if (env_thread) {
      const float obs[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
      const float a3[3] = {sm.adv[tid], sm.adv[EB + tid], sm.adv[2 * EB + tid]};
      const int act_a = argmax3(a3);
      const float b3[3] = {sm.adv[3 * EB + tid], sm.adv[4 * EB + tid],
                           sm.adv[5 * EB + tid]};
      const int greedy_b = argmax3(b3);
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
      const float o7[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
#pragma unroll
      for (int i = 0; i < 7; ++i) sm.obs[i * EB + tid] = o7[i];
    }
  }

  if (env_thread) {
    store_env(es, f_out, i_out, B, env);
    i_out[4 * B + env] = sm.member[tid];
#pragma unroll
    for (int r = 0; r < 7; ++r) stats[r * B + env] = st[r];
    stats[7 * B + env] = 0.f;
  }
}

}  // namespace

extern "C" {

// Launch one rollout chunk on `stream`, B / 16 blocks. B % tile_rows == 0
// and tile_rows % 16 == 0 (checked by the Python wrapper too); tile0 is the
// global index of this call's first tile. Transition pointers may all be
// null (eval mode).
// Returns the cudaError_t of the launch.
int actor_rollout_launch(const EnvP* p, const float* f_in, const int* i_in,
                         const float* learner, const float* opp,
                         int shared_trunk, float* f_out, int* i_out,
                         float* tr_obs, float* tr_next, int* tr_act,
                         float* tr_rew, int* tr_done, float* stats, int B,
                         int T, int tile_rows, int tile0, unsigned int seed,
                         int eps_i, cudaStream_t stream) {
  if (B % EB || tile_rows % EB) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      actor_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem::bytes);
  if (err != cudaSuccess) return (int)err;
  actor_rollout_kernel<<<B / EB, THREADS, Smem::bytes, stream>>>(
      *p, f_in, i_in, learner, opp, shared_trunk, f_out, i_out, tr_obs,
      tr_next, tr_act, tr_rew, tr_done, stats, B, T, tile_rows, tile0, seed,
      eps_i);
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
