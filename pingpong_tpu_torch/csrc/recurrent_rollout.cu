// Fused DRQN actor rollout: one launch runs a whole recurrent rollout chunk.
//
// Replaces the TPU kernel pingpong_tpu/ops/recurrent_rollout.py::
// pallas_recurrent_rollout (interpret-mode body _rnn_kernel, step
// _one_step_rnn, forward _rnn_advantage, noise _draw_noise). Per env and
// step: the bound opponent's recurrent forward (mu weights, player A's
// mirror folded into its first layer at pack time), the learner's
// recurrent forward with this step's factorized noise on the shared and A
// heads (the V head is skipped: argmax(V + A - mean A) == argmax(A)),
// epsilon-greedy, the env step with auto-reset (pong_env.cuh), the
// zero-reset of both LSTM streams on done, the emission of obs / action /
// reward / done, and the per-env statistics.
//
// What bounds it on an H100: the latency of the weight stream from L2. A
// net's step is the feature MLP (7 -> F1 -> F), ONE gates product [w_ih |
// w_hh] (4H x (F+H)), the LSTM cell, the shared head (HH x H) and the A
// head (3 x HH): about 313 kFLOP at the shipped widths (64, 128, 128, 128),
// two nets per env-step, so the arithmetic bound of a 1024 x 128 chunk is
// about 1.2 ms. The packed gates matrix alone is 4H x (F+H) floats (512
// KB), more than a block's shared memory, so the TPU design (one program
// holding a tile's envs and every net in VMEM) and kernel 1's design (net
// in shared memory) do not carry over. Here a block of 512 threads takes
// ENVS = 8 envs (1024 envs -> 128 blocks on 132 SMs): their env state
// lives in the registers of threads 0-7, both LSTM streams and every
// activation in shared memory, and each product runs in the kernel's own
// body with one thread per output row accumulating all 8 envs, reading
// the weights from global memory (L2-resident) once per block and step,
// coalesced across threads. A block-step streams about 1.3 MB from L2 with
// 8 FMAs a load, so the three weight loops (f2, gates, shared head) are
// unrolled 32 deep to keep that many independent loads in flight a thread.
// (Designs that kept the gate weights resident in shared memory across an
// 8-CTA cluster, split by LSTM unit, were built and measured slower on the
// card: every CTA must hold x = [f2; h] of the envs it serves, so a
// cluster serves only some 70 envs at a time, and each step becomes a
// chain of short phases (DSMEM pushes, cluster barriers, the head, the env
// step) that costs more than the resident weights save; PERF.md.) The
// learner's noisy head weights are formed on the fly (mu +
// sigma * eps_out * eps_in), never materialized. A block whose envs are
// bound to several pool members runs the opponent pass once per member
// present and keeps each env's own member's result (the TPU kernel's [lo,
// hi] member loop). Every sum runs in a fixed order and nothing uses
// atomics: a run is reproducible bit for bit.
//
// Semantics kept from the TPU kernel's interpret path: seed_mix = seed ^
// (tile * 747796405), ctr = 16 * step; the learner noise of a step is one
// factorized draw shared by a tile of tile_rows envs: eps_in of the shared
// head at hash (k 10, 11) row 0 cols 0..H-1, eps_in of the A head row 1
// cols 0..HH-1, eps_out of the shared head at (k 12, 13) col 0 rows
// 0..HH-1, eps_out of the A head col 1 rows 0..2; exploration at (k 5, 6)
// and serves as in kernel 1. Transcendentals are the precise expf / tanhf
// (no fast math). The TPU's grid variant (_rnn_kernel_grid) draws other
// bits (per-cell seed_mix, batched noise); the port follows the interpret
// path, which equals the grid variant in distribution.

#include "pong_env.cuh"

namespace {

constexpr int ENVS = 8;       // envs per block
constexpr int THREADS = 512;

// packed net (floats): w1 (F1, 8) b1 (F1) w2 (F1, F) b2 (F)
// wg (F+H, 4H) bg (4H) ws (H, HH) bs (HH) wa (3, HH) ba (3)
// learner sigmas: ws (H, HH) bs (HH) wa (3, HH) ba (3)
struct Layout {
  int F1, F, H, HH;
  int w1, b1, w2, b2, wg, bg, ws, bs, wa, ba, net;
  int sws, sbs, swa, sba;
  __host__ __device__ Layout(int f1, int f, int h, int hh)
      : F1(f1), F(f), H(h), HH(hh) {
    w1 = 0; b1 = w1 + F1 * 8; w2 = b1 + F1; b2 = w2 + F1 * F;
    wg = b2 + F; bg = wg + (F + H) * 4 * H; ws = bg + 4 * H;
    bs = ws + H * HH; wa = bs + HH; ba = wa + 3 * HH; net = ba + 3;
    sws = 0; sbs = H * HH; swa = sbs + HH; sba = swa + 3 * HH;
  }
};

struct Smem {
  float *obs, *f1, *x, *g, *h, *c, *s, *adv, *ein_s, *eout_s, *ein_a,
      *eout_a;
  int *member, *act_a;
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// One recurrent forward of net `w` for the block's envs whose member is
// `m` (all envs when m < 0), on LSTM stream `stream` (0 learner, 1
// opponent). With `noisy`, the shared and A heads carry this step's noise.
// Leaves the advantages in sm.adv and the new h / c in the stream.
__device__ void rnn_forward(const Layout& L, const float* __restrict__ w,
                            const float* __restrict__ sig, bool noisy,
                            int stream, int m, const Smem& sm) {
  const int tid = threadIdx.x;
  const int F1 = L.F1, F = L.F, H = L.H, HH = L.HH, G4 = 4 * H;
  float* h = sm.h + stream * H * ENVS;
  float* c = sm.c + stream * H * ENVS;
  for (int j = tid; j < F1; j += THREADS) {
    float acc[ENVS] = {};
    for (int i = 0; i < 7; ++i) {
      const float wv = w[L.w1 + j * 8 + i];
#pragma unroll
      for (int e = 0; e < ENVS; ++e) acc[e] = fmaf(wv, sm.obs[i * ENVS + e], acc[e]);
    }
    const float b = w[L.b1 + j];
#pragma unroll
    for (int e = 0; e < ENVS; ++e) sm.f1[j * ENVS + e] = fmaxf(acc[e] + b, 0.f);
  }
  for (int o = tid; o < H * ENVS; o += THREADS) sm.x[F * ENVS + o] = h[o];
  __syncthreads();
  for (int j = tid; j < F; j += THREADS) {
    float acc[ENVS] = {};
#pragma unroll 32
    for (int i = 0; i < F1; ++i) {
      const float wv = w[L.w2 + i * F + j];
#pragma unroll
      for (int e = 0; e < ENVS; ++e) acc[e] = fmaf(wv, sm.f1[i * ENVS + e], acc[e]);
    }
    const float b = w[L.b2 + j];
#pragma unroll
    for (int e = 0; e < ENVS; ++e) sm.x[j * ENVS + e] = fmaxf(acc[e] + b, 0.f);
  }
  __syncthreads();
  for (int r = tid; r < G4; r += THREADS) {  // gates = [w_ih | w_hh] [f2; h]
    float acc[ENVS] = {};
#pragma unroll 32
    for (int k = 0; k < F + H; ++k) {
      const float wv = w[L.wg + k * G4 + r];
#pragma unroll
      for (int e = 0; e < ENVS; ++e) acc[e] = fmaf(wv, sm.x[k * ENVS + e], acc[e]);
    }
    const float b = w[L.bg + r];
#pragma unroll
    for (int e = 0; e < ENVS; ++e) sm.g[r * ENVS + e] = acc[e] + b;
  }
  __syncthreads();
  for (int o = tid; o < H * ENVS; o += THREADS) {  // cell, gate order i f g o
    const int j = o / ENVS, e = o % ENVS;
    if (m >= 0 && sm.member[e] != m) continue;
    const float gi = sigmoid(sm.g[j * ENVS + e]);
    const float gf = sigmoid(sm.g[(H + j) * ENVS + e]);
    const float gg = tanhf(sm.g[(2 * H + j) * ENVS + e]);
    const float go = sigmoid(sm.g[(3 * H + j) * ENVS + e]);
    const float cn = gf * c[o] + gi * gg;
    c[o] = cn;
    h[o] = go * tanhf(cn);
  }
  __syncthreads();
  for (int j = tid; j < HH; j += THREADS) {  // shared head
    float acc[ENVS] = {};
    const float eo = noisy ? sm.eout_s[j] : 0.f;
#pragma unroll 32
    for (int i = 0; i < H; ++i) {
      float wv = w[L.ws + i * HH + j];
      if (noisy)
        wv = __fadd_rn(wv, __fmul_rn(sig[L.sws + i * HH + j],
                                     __fmul_rn(eo, sm.ein_s[i])));
#pragma unroll
      for (int e = 0; e < ENVS; ++e) acc[e] = fmaf(wv, h[i * ENVS + e], acc[e]);
    }
    float b = w[L.bs + j];
    if (noisy) b = __fadd_rn(b, __fmul_rn(sig[L.sbs + j], eo));
#pragma unroll
    for (int e = 0; e < ENVS; ++e) sm.s[j * ENVS + e] = fmaxf(acc[e] + b, 0.f);
  }
  __syncthreads();
  // A head: one warp per (action, env) output, lanes split the HH terms
  const int warp = tid >> 5, lane = tid & 31;
  for (int o = warp; o < 3 * ENVS; o += THREADS / 32) {
    const int a = o / ENVS, e = o % ENVS;
    const float eo = noisy ? sm.eout_a[a] : 0.f;
    float acc = 0.f;
    for (int j = lane; j < HH; j += 32) {
      float wv = w[L.wa + a * HH + j];
      if (noisy)
        wv = __fadd_rn(wv, __fmul_rn(sig[L.swa + a * HH + j],
                                     __fmul_rn(eo, sm.ein_a[j])));
      acc = fmaf(wv, sm.s[j * ENVS + e], acc);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float b = w[L.ba + a];
      if (noisy) b = __fadd_rn(b, __fmul_rn(sig[L.sba + a], eo));
      sm.adv[a * ENVS + e] = acc + b;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
recurrent_rollout_kernel(EnvP p, const float* __restrict__ f_in,
                         const int* __restrict__ i_in,
                         const float* __restrict__ hid_in,
                         const float* __restrict__ learner,
                         const float* __restrict__ sigma,
                         const float* __restrict__ opp,
                         float* __restrict__ f_out, int* __restrict__ i_out,
                         float* __restrict__ hid_out,
                         float* __restrict__ tr_obs, int* __restrict__ tr_act,
                         float* __restrict__ tr_rew, int* __restrict__ tr_done,
                         float* __restrict__ stats, int B, int T,
                         int tile_rows, uint32_t seed, int eps_i, int F1,
                         int F, int H, int HH) {
  extern __shared__ float smem[];
  const Layout L(F1, F, H, HH);
  Smem sm;
  float* q = smem;
  sm.obs = q; q += 8 * ENVS;
  sm.f1 = q; q += F1 * ENVS;
  sm.x = q; q += (F + H) * ENVS;
  sm.g = q; q += 4 * H * ENVS;
  sm.h = q; q += 2 * H * ENVS;
  sm.c = q; q += 2 * H * ENVS;
  sm.s = q; q += HH * ENVS;
  sm.adv = q; q += 3 * ENVS;
  sm.ein_s = q; q += H;
  sm.eout_s = q; q += HH;
  sm.ein_a = q; q += HH;
  sm.eout_a = q; q += 4;
  sm.member = (int*)q;
  sm.act_a = sm.member + ENVS;

  const int tid = threadIdx.x;
  const int env0 = blockIdx.x * ENVS;
  // every env of a block lies in one tile (tile_rows % ENVS == 0)
  const uint32_t seed_mix = seed ^ ((uint32_t)(env0 / tile_rows) * 747796405u);
  const float eps = __fmul_rn(__int2float_rn(eps_i), 1e-6f);

  // both streams: hid rows [h_b; c_b; h_opp; c_opp], column = env
  for (int o = tid; o < H * ENVS; o += THREADS) {
    const int j = o / ENVS, e = o % ENVS;
    const size_t col = (size_t)env0 + e;
    sm.h[o] = hid_in[(size_t)j * B + col];
    sm.c[o] = hid_in[(size_t)(H + j) * B + col];
    sm.h[H * ENVS + o] = hid_in[(size_t)(2 * H + j) * B + col];
    sm.c[H * ENVS + o] = hid_in[(size_t)(3 * H + j) * B + col];
  }
  EnvRow es;
  float st[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int env = env0 + (tid < ENVS ? tid : 0);
  const uint32_t lane = (uint32_t)(env % tile_rows);
  if (tid < ENVS) {
    es = load_env(f_in, i_in, B, env);
    sm.member[tid] = i_in[4 * B + env];
  }
  __syncthreads();
  int lo = sm.member[0], hi = sm.member[0];
  for (int e = 1; e < ENVS; ++e) {
    lo = min(lo, sm.member[e]);
    hi = max(hi, sm.member[e]);
  }
  const float pool_f = (tid < ENVS && sm.member[tid] > 0) ? 1.f : 0.f;

  for (int s = 0; s < T; ++s) {
    const uint32_t ctr = (uint32_t)s * 16u;
    // this step's learner noise (the tile's draw) and the observations
    for (int i = tid; i < H + 2 * HH + 3; i += THREADS) {
      if (i < H) sm.ein_s[i] = hash_noise(p, seed_mix, ctr, 10, 11, 0, i);
      else if (i < H + HH) sm.ein_a[i - H] = hash_noise(p, seed_mix, ctr, 10, 11, 1, i - H);
      else if (i < H + 2 * HH) sm.eout_s[i - H - HH] = hash_noise(p, seed_mix, ctr, 12, 13, i - H - HH, 0);
      else sm.eout_a[i - H - 2 * HH] = hash_noise(p, seed_mix, ctr, 12, 13, i - H - 2 * HH, 1);
    }
    if (tid < ENVS) {
      const float o7[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
#pragma unroll
      for (int i = 0; i < 7; ++i) sm.obs[i * ENVS + tid] = o7[i];
    }
    __syncthreads();

    // the bound opponent: one pass per member present in the block
    for (int m = lo; m <= hi; ++m) {
      bool present = false;
      for (int e = 0; e < ENVS; ++e) present |= sm.member[e] == m;
      if (!present) continue;
      rnn_forward(L, opp + (size_t)m * L.net, nullptr, false, 1, m, sm);
      if (tid < ENVS && sm.member[tid] == m) {
        const float a3[3] = {sm.adv[tid], sm.adv[ENVS + tid], sm.adv[2 * ENVS + tid]};
        sm.act_a[tid] = argmax3(a3);
      }
    }
    // the learner: noisy heads, epsilon-greedy
    rnn_forward(L, learner, sigma, true, 0, -1, sm);

    if (tid < ENVS) {
      const float a3[3] = {sm.adv[tid], sm.adv[ENVS + tid], sm.adv[2 * ENVS + tid]};
      const int greedy_b = argmax3(a3);
      const float u_expl = hash_u01(seed_mix, ctr, 5, 0, lane);
      int rand_a = (int)__fmul_rn(hash_u01(seed_mix, ctr, 6, 0, lane), 3.0f);
      rand_a = rand_a < 0 ? 0 : (rand_a > 2 ? 2 : rand_a);
      const int act_b = u_expl < eps ? rand_a : greedy_b;
      const StepOut o = env_transition(p, es, sm.act_a[tid], act_b);
      if (tr_obs != nullptr) {
        const size_t r = (size_t)s * B + env;
        const float obs7[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
#pragma unroll
        for (int i = 0; i < 7; ++i) tr_obs[r * 7 + i] = obs7[i];
        tr_act[r] = act_b;
        tr_rew[r] = o.reward_b;
        tr_done[r] = o.done ? 1 : 0;
      }
      env_account_reset(p, es, o, seed_mix, ctr, lane, pool_f, st);
      sm.act_a[tid] = o.done ? 1 : 0;   // reused as this step's done flag
    }
    __syncthreads();
    // a new episode starts both streams from zero
    for (int o = tid; o < H * ENVS; o += THREADS) {
      if (sm.act_a[o % ENVS]) {
        sm.h[o] = 0.f; sm.c[o] = 0.f;
        sm.h[H * ENVS + o] = 0.f; sm.c[H * ENVS + o] = 0.f;
      }
    }
    __syncthreads();
  }

  for (int o = tid; o < H * ENVS; o += THREADS) {
    const int j = o / ENVS, e = o % ENVS;
    const size_t col = (size_t)env0 + e;
    hid_out[(size_t)j * B + col] = sm.h[o];
    hid_out[(size_t)(H + j) * B + col] = sm.c[o];
    hid_out[(size_t)(2 * H + j) * B + col] = sm.h[H * ENVS + o];
    hid_out[(size_t)(3 * H + j) * B + col] = sm.c[H * ENVS + o];
  }
  if (tid < ENVS) {
    store_env(es, f_out, i_out, B, env);
    i_out[4 * B + env] = sm.member[tid];
#pragma unroll
    for (int r = 0; r < 7; ++r) stats[r * B + env] = st[r];
    stats[7 * B + env] = 0.f;
  }
}

size_t smem_bytes(int F1, int F, int H, int HH) {
  const size_t floats = 8 * ENVS + (size_t)(F1 + F + H + 4 * H + 4 * H + HH + 3) * ENVS +
                        H + 2 * HH + 4;
  return floats * sizeof(float) + 2 * ENVS * sizeof(int);
}

}  // namespace

extern "C" {

// Launch one recurrent rollout chunk on `stream`. B % 8 == 0,
// tile_rows % 8 == 0, every width <= 128 (checked by the Python wrapper).
// Transition pointers may all be null (eval mode). Returns the
// cudaError_t of the launch.
int recurrent_rollout_launch(const EnvP* p, const float* f_in, const int* i_in,
                             const float* hid_in, const float* learner,
                             const float* sigma, const float* opp,
                             float* f_out, int* i_out, float* hid_out,
                             float* tr_obs, int* tr_act, float* tr_rew,
                             int* tr_done, float* stats, int B, int T,
                             int tile_rows, unsigned int seed, int eps_i,
                             int F1, int F, int H, int HH,
                             cudaStream_t stream) {
  const size_t smem = smem_bytes(F1, F, H, HH);
  cudaError_t err = cudaFuncSetAttribute(
      recurrent_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  recurrent_rollout_kernel<<<B / ENVS, THREADS, smem, stream>>>(
      *p, f_in, i_in, hid_in, learner, sigma, opp, f_out, i_out, hid_out,
      tr_obs, tr_act, tr_rew, tr_done, stats, B, T, tile_rows, seed, eps_i,
      F1, F, H, HH);
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
