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
// What bounds it on an H100: moving the weights through shared memory. A
// net's step is the feature MLP (7 -> F1 -> F), one gates product [w_ih |
// w_hh] (4H x (F+H)), the LSTM cell, the shared head (HH x H) and the A
// head (3 x HH): about 313 kFLOP at the shipped widths (64, 128, 128, 128),
// two nets per env-step. The nets (630 KB each) do not fit a block's shared
// memory, so every block-step streams both through it once and spreads
// each weight over the block's envs: at 8 envs a block the bulk writes of
// the stream and the reads of weights and inputs take about as many
// shared-memory cycles as the FMAs take issue slots. The design:
//
// * One opponent per block. The wrapper sorts the envs by (member, tile)
//   and cuts each (member, tile) segment into blocks of E envs (a block
//   table built on the card by block_table_kernel below: row = [member, env
//   ids], -1 for idle lanes), so a block runs one opponent pass and one
//   learner pass a step (the TPU kernel's [lo, hi] member loop is gone). An
//   env's arithmetic does not depend on the block or lane that holds it.
// * One producer warp streams every matrix of both nets (w2, the gates
//   matrix, the shared head and its sigmas) through a ring of two
//   shared-memory stages with 1-D bulk asynchronous copies (cp.async.bulk),
//   full / empty mbarrier pairs a stage, and runs ahead across layers, nets
//   and steps. The 8 consumer warps meet at a named barrier (bar.sync 1,
//   256), never at one that waits for the producer. The small tensors (w1,
//   the biases, the A heads) stay resident for the round.
// * Each block streams the weights for itself. On an H100 the L2 is not
//   what bounds the kernel: clusters of 2 and 4 CTAs fed by one multicast
//   stream were measured slower than single blocks (PERF.md).
// * E envs a block (8, 16 or 32; the wrapper picks the smallest whose
//   blocks are all resident at once), so a 4096-env chunk is 128 blocks of
//   32 envs in one wave, not 512 blocks of 8 in four. A grid larger than
//   the card walks rounds of blocks.
// * Products from shared memory: lane l of consumer warp w owns output j =
//   32 (w % 4) + l, so a warp's 16-byte weight loads are distinct and
//   contiguous; in the gates product a thread owns the unit's four gates
//   (the flat layout stores the gates matrix unit-major, so one 16-byte
//   load gives them) and the cell runs in its registers. Warp group w / 4
//   takes half of the envs, or at 8 envs the rows of one parity, the two
//   groups then adding their partial sums through shared memory (even rows
//   + odd rows). Every sum runs in a fixed order and nothing uses atomics:
//   a run is reproducible bit for bit.
//
// The learner's noisy head weights are formed on the fly (mu + sigma *
// eps_out * eps_in) from the streamed mu and sigma with each block's own
// tile noise; a launch whose sigmas are all zero (a gate's greedy
// evaluation) streams no sigmas and draws no noise, with the same result.
// Semantics kept from the TPU kernel's interpret path: seed_mix = seed ^
// (tile * 747796405), ctr = 16 * step; the learner noise of a step is one
// factorized draw shared by a tile of tile_rows envs:
// eps_in of the shared head at hash (k 10, 11) row 0 cols 0..H-1, eps_in
// of the A head row 1 cols 0..HH-1, eps_out of the shared head at (k 12,
// 13) col 0 rows 0..HH-1, eps_out of the A head col 1 rows 0..2;
// exploration at (k 5, 6) and serves as in kernel 1, hashed on env %
// tile_rows. Transcendentals are the precise expf / tanhf (no fast math).
// The TPU's grid variant (_rnn_kernel_grid) draws other bits (per-cell
// seed_mix, batched noise); the port follows the interpret path, which
// equals the grid variant in distribution.

#include "pong_env.cuh"

namespace {

constexpr int ALIGN = 32;            // floats: each flat section starts on 128 bytes
constexpr int MAXW = 128;            // every width the kernel takes
constexpr int NCW = 8;               // consumer warps
constexpr int NC = NCW * 32;         // consumer threads
constexpr int THREADS = NC + 32;     // + the producer warp
constexpr int MAX_STAGES = 16;
constexpr int MAX_SMEM = 232448;     // a block's dynamic shared memory on an H100
constexpr int N_SEGS = 6;            // streamed matrices a step

__host__ __device__ constexpr int rup(int n) {
  return (n + ALIGN - 1) / ALIGN * ALIGN;
}

// floats a ring stage holds: 64 KB up to 16 envs a block, 32 KB at 32
template <int E>
__host__ __device__ constexpr int stage_floats() {
  return E <= 16 ? 16384 : 8192;
}

// Flat net (ops/recurrent_rollout.py::net_layout) at widths that are
// multiples of 4 (the wrapper adds zero units), each section padded to 128
// bytes: the resident part w1 (F1, 8) b1 (F1) b2 (F) bg (H, 4: unit-
// major) bs (HH) wa (3, HH) ba (3), then the streamed part w2 (F1 in, F
// out) wg (F+H in, H units, 4 gates) ws (H in, HH out). Learner sigmas
// (sigma_layout): sbs (HH) swa (3, HH) sba (3), then sws (H in, HH out).
struct Layout {
  int F1, F, H, HH;
  int w1, b1, b2, bg, bs, wa, ba, w2, wg, ws, net;
  int sbs, swa, sba, sws, sig;
  __host__ __device__ Layout(int f1, int f, int h, int hh)
      : F1(f1), F(f), H(h), HH(hh) {
    w1 = 0; b1 = w1 + rup(F1 * 8); b2 = b1 + rup(F1); bg = b2 + rup(F);
    bs = bg + rup(4 * H); wa = bs + rup(HH); ba = wa + rup(3 * HH);
    w2 = ba + rup(3); wg = w2 + rup(F1 * F); ws = wg + rup((F + H) * 4 * H);
    net = ws + rup(H * HH);
    sbs = 0; swa = rup(HH); sba = swa + rup(3 * HH); sws = sba + rup(3);
    sig = sws + rup(H * HH);
  }
};

// One streamed matrix: `rows` rows of `len` floats, `rps` rows a stage;
// with `sg` each stage holds the rows of mu and then the same rows of sigma.
struct Seg {
  const float* mu;
  const float* sg;
  int rows, len, rps;
};

// Segment i of a step: 0-2 the opponent's w2, wg, ws; 3-5 the learner's,
// the last with its sigmas when they are not all zero (`noisy`). Producer
// and consumers walk the same list.
__device__ __forceinline__ Seg segment(int i, const Layout& L,
                                       const float* ow, const float* lw,
                                       const float* sig, int sf,
                                       bool noisy) {
  const float* w = i < 3 ? ow : lw;
  Seg g;
  g.sg = nullptr;
  if (i % 3 == 0) {
    g.mu = w + L.w2; g.rows = L.F1; g.len = L.F;
  } else if (i % 3 == 1) {
    g.mu = w + L.wg; g.rows = L.F + L.H; g.len = 4 * L.H;
  } else {
    g.mu = w + L.ws; g.rows = L.H; g.len = L.HH;
    if (i == 5 && noisy) g.sg = sig + L.sws;
  }
  g.rps = sf / (g.len * (g.sg ? 2 : 1));
  return g;
}

__host__ __device__ inline size_t take(size_t& o, size_t bytes, size_t al) {
  o = (o + al - 1) / al * al;
  const size_t r = o;
  o += bytes;
  return r;
}

// Shared memory of a block of E envs; with base == nullptr only the sizes.
template <int E>
struct Smem {
  unsigned long long* bar;   // full[MAX_STAGES], empty[MAX_STAGES]
  int *env, *done;
  float *res_o, *res_l, *res_s, *ein_s, *eout_s, *ein_a, *eout_a, *obs,
      *adv, *f1s, *xf2, *h, *c, *xch, *ring;
  int stages;
  size_t bytes;
  __host__ __device__ Smem(char* base, const Layout& L) {
    size_t o = 0;
    const size_t f = sizeof(float);
    bar = (unsigned long long*)(base + take(o, 2 * MAX_STAGES * 8, 8));
    env = (int*)(base + take(o, E * sizeof(int), 16));
    done = (int*)(base + take(o, E * sizeof(int), 16));
    res_o = (float*)(base + take(o, L.w2 * f, 16));
    res_l = (float*)(base + take(o, L.w2 * f, 16));
    res_s = (float*)(base + take(o, L.sws * f, 16));
    ein_s = (float*)(base + take(o, MAXW * f, 16));
    eout_s = (float*)(base + take(o, MAXW * f, 16));
    ein_a = (float*)(base + take(o, MAXW * f, 16));
    eout_a = (float*)(base + take(o, 4 * f, 16));
    obs = (float*)(base + take(o, 8 * E * f, 16));
    adv = (float*)(base + take(o, 4 * E * f, 16));
    // f1 (F1 x E) and the shared head's output s (HH x E) share a buffer
    f1s = (float*)(base + take(o, (L.F1 > L.HH ? L.F1 : L.HH) * E * f, 16));
    xf2 = (float*)(base + take(o, L.F * E * f, 16));
    h = (float*)(base + take(o, 4 * L.H * E * f, 16));   // [stream][buffer]
    c = (float*)(base + take(o, 2 * L.H * E * f, 16));   // [stream]
    // the two warp groups' traded partial sums (8 envs a block only)
    xch = (float*)(base + take(o, (E == 8 ? 2 * MAXW * 4 * 4 : 0) * f, 16));
    o = (o + 127) / 128 * 128;
    const size_t sb = stage_floats<E>() * f;
    const size_t fit = o < (size_t)MAX_SMEM ? (MAX_SMEM - o) / sb : 0;
    stages = fit < (size_t)MAX_STAGES ? (int)fit : MAX_STAGES;
    ring = (float*)(base + o);
    bytes = o + stages * sb;
  }
};

struct Args {
  EnvP p;
  const float *f_in;
  const int* i_in;
  const float *hid_in, *learner, *sigma, *opp;
  float* f_out;
  int* i_out;
  float *hid_out, *tr_obs;
  int* tr_act;
  float* tr_rew;
  int* tr_done;
  float* stats;
  const int* table;   // (rows, 1 + E): member, then env ids (-1 idle)
  const int* info;    // info[2]: the table's blocks (block_table_kernel)
  int B, T, tile_rows, tile0;   // tile0: global index of the first tile
  uint32_t seed;
  int eps_i, F1, F, H, HH;
};

// ---- mbarriers, bulk copies, barriers ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity. A wait
// of 2 s means a stage that never comes (a chunk takes milliseconds): the
// kernel traps, and the launch reports an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > 2000000000ull) __trap();
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// the consumers' barrier (named barrier 1, the producer warp not counted)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// Copy `bytes` (a multiple of 16) from global to the ring; `bar` counts
// the bytes.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A consumer warp is done with a stage.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---- the producer --------------------------------------------------------

template <int E>
__device__ void produce(const Args& a, const Layout& L, const Smem<E>& S,
                        uint32_t full0, uint32_t empty0, bool noisy) {
  constexpr int SF = stage_floats<E>();
  uint32_t n = 0;   // chunks issued
  for (int blk = blockIdx.x; blk < a.info[2]; blk += gridDim.x) {
    const int m = a.table[(size_t)blk * (E + 1)];
    const float* ow = a.opp + (size_t)m * L.net;
    for (int s = 0; s < a.T; ++s) {
      for (int i = 0; i < N_SEGS; ++i) {
        const Seg g = segment(i, L, ow, a.learner, a.sigma, SF, noisy);
        for (int r0 = 0; r0 < g.rows; r0 += g.rps, ++n) {
          const int nr = min(g.rps, g.rows - r0);
          const uint32_t st = n % (uint32_t)S.stages;
          const uint32_t round = n / (uint32_t)S.stages;
          mbar_wait(empty0 + 8 * st, (round & 1u) ^ 1u);
          const uint32_t piece = (uint32_t)(nr * g.len) * 4u;
          mbar_expect_tx(full0 + 8 * st, g.sg ? 2u * piece : piece);
          float* dst = S.ring + (size_t)st * SF;
          bulk_copy(dst, g.mu + (size_t)r0 * g.len, piece, full0 + 8 * st);
          if (g.sg)
            bulk_copy(dst + nr * g.len, g.sg + (size_t)r0 * g.len, piece,
                      full0 + 8 * st);
        }
      }
    }
  }
}

// ---- the consumers --------------------------------------------------------

// Walk one streamed segment chunk by chunk: wait for the stage, fn(stage,
// rows in it, first row), release the stage.
template <int E, class Fn>
__device__ __forceinline__ void stream_rows(const Seg& g, const Smem<E>& S,
                                            uint32_t full0, uint32_t empty0,
                                            uint32_t& n, int lane, Fn fn) {
  constexpr int SF = stage_floats<E>();
  for (int r0 = 0; r0 < g.rows; r0 += g.rps, ++n) {
    const int nr = min(g.rps, g.rows - r0);
    const uint32_t st = n % (uint32_t)S.stages;
    mbar_wait(full0 + 8 * st, (n / (uint32_t)S.stages) & 1u);
    fn(S.ring + (size_t)st * SF, nr, r0);
    release(empty0 + 8 * st, lane);
  }
}

// Per-thread consumer context: unit (or output) j = 32 (warp % 4) + lane,
// envs ebase + 4 q + [0, 4) for q < E / 8, ebase = E / 2 (warp / 4).
struct Ctx {
  int t, warp, lane, j, ebase;
  uint32_t full0, empty0;
};

// Split of a product over the consumers. Thread (warp w, lane l) owns
// output j = 32 (w % 4) + l; warp group g = w / 4. From 16 envs up, group
// g takes envs [g E / 2, (g + 1) E / 2) over every row. At 8 envs, each
// group takes all 8 envs over the rows of parity g (so each weight is read
// once a block), and the two groups then trade halves: group g keeps envs
// 4 g .. 4 g + 3 as (even rows) + (odd rows).
template <int E>
struct Split {
  static constexpr bool KS = E == 8;            // split the rows
  static constexpr int NQ = KS ? 2 : E / 8;     // float4 env groups summed
  static constexpr int NQO = KS ? 1 : NQ;       // ... and finalized
  static constexpr int UNROLL = NQ >= 4 ? 1 : 8;   // 168 registers at most
};

// At 8 envs: trade the row-parity partial sums of G outputs x 8 envs with
// the other warp group through `xch`; acc[0] ends as the thread's 4 envs.
template <int E, int G>
__device__ __forceinline__ void trade_halves(float (&acc)[Split<E>::NQ][G][4],
                                             float* xch, int j, int g) {
  if constexpr (Split<E>::KS) {
    float* give = xch + ((g * 128 + j) * G) * 4;
    const float* from = xch + (((1 - g) * 128 + j) * G) * 4;
#pragma unroll
    for (int o = 0; o < G; ++o) {
      float v[4];   // the other group's envs: 4-7 from group 0, 0-3 from 1
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = g == 0 ? acc[1][o][e] : acc[0][o][e];
      *reinterpret_cast<float4*>(give + o * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    consumers_sync();
#pragma unroll
    for (int o = 0; o < G; ++o) {
      const float4 t = ld4(from + o * 4);
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[0][o][e] = g == 0 ? acc[0][o][e] + tv[e] : tv[e] + acc[1][o][e];
    }
  }
}

// One recurrent forward of a net (residents R, learner sigmas Rs and this
// step's noise when NOISY) over the block's envs on LSTM stream `strm` (0
// learner, 1 opponent): h is read from buffer p and written to buffer p ^
// 1. Leaves the advantages in S.adv. Ends at a consumer barrier.
template <int E, bool NOISY>
__device__ __forceinline__ void net_pass(const Ctx& x, const Layout& L,
                                         const Smem<E>& S, const float* R,
                                         const float* Rs, const Seg* segs,
                                         int strm, int p, uint32_t& n) {
  using SP = Split<E>;
  constexpr int NQ = SP::NQ, NQO = SP::NQO, KSTEP = SP::KS ? 2 : 1;
  const int F1 = L.F1, F = L.F, H = L.H, HH = L.HH;
  const int HE = H * E;
  float* hold = S.h + (strm * 2 + p) * HE;
  float* hnew = S.h + (strm * 2 + (p ^ 1)) * HE;
  float* cs = S.c + strm * HE;
  const int g = x.warp >> 2;
  const int ein = SP::KS ? 0 : x.ebase;        // first env summed
  const int eout = SP::KS ? 4 * g : x.ebase;   // first env finalized
  // the first row of a stage this thread takes (rows of its parity at 8 envs)
  auto kfirst = [&](int r0) { return SP::KS ? ((g ^ r0) & 1) : 0; };

  // f1 = relu(w1 obs + b1), resident weights
  for (int o = x.t; o < F1 * E; o += NC) {
    const int jj = o / E, e = o % E;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i)
      acc = fmaf(R[L.w1 + jj * 8 + i], S.obs[i * E + e], acc);
    S.f1s[o] = fmaxf(acc + R[L.b1 + jj], 0.f);
  }
  consumers_sync();  // phase: f1

  // f2 = relu(w2 f1 + b2), w2 streamed
  {
    const int jj = x.j < F ? x.j : 0;
    float acc[NQ][1][4] = {};
    stream_rows<E>(segs[0], S, x.full0, x.empty0, n, x.lane,
                      [&](const float* buf, int nr, int r0) {
#pragma unroll (SP::UNROLL)
      for (int k = kfirst(r0); k < nr; k += KSTEP) {
        const float wv = buf[k * F + jj];
        const float* xr = S.f1s + (r0 + k) * E + ein;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 v = ld4(xr + q * 4);
          acc[q][0][0] = fmaf(wv, v.x, acc[q][0][0]);
          acc[q][0][1] = fmaf(wv, v.y, acc[q][0][1]);
          acc[q][0][2] = fmaf(wv, v.z, acc[q][0][2]);
          acc[q][0][3] = fmaf(wv, v.w, acc[q][0][3]);
        }
      }
    });
    trade_halves<E, 1>(acc, S.xch, x.j, g);
    if (x.j < F) {
      const float b = R[L.b2 + x.j];
#pragma unroll
      for (int q = 0; q < NQO; ++q)
        *reinterpret_cast<float4*>(S.xf2 + x.j * E + q * 4 + eout) =
            make_float4(fmaxf(acc[q][0][0] + b, 0.f),
                        fmaxf(acc[q][0][1] + b, 0.f),
                        fmaxf(acc[q][0][2] + b, 0.f),
                        fmaxf(acc[q][0][3] + b, 0.f));
    }
  }
  consumers_sync();  // phase: f2

  // gates = wg [f2; h] + bg, then the cell (gate order i f g o) in registers
  {
    const int jj = x.j < H ? x.j : 0;
    const int len = 4 * H;
    float acc[NQ][4][4] = {};
    stream_rows<E>(segs[1], S, x.full0, x.empty0, n, x.lane,
                      [&](const float* buf, int nr, int r0) {
#pragma unroll (SP::UNROLL)
      for (int k = kfirst(r0); k < nr; k += KSTEP) {
        const int K = r0 + k;
        const float4 w = ld4(buf + k * len + jj * 4);
        const float* xr = (K < F ? S.xf2 + K * E : hold + (K - F) * E) + ein;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 v = ld4(xr + q * 4);
          const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[q][0][e] = fmaf(w.x, ve[e], acc[q][0][e]);
            acc[q][1][e] = fmaf(w.y, ve[e], acc[q][1][e]);
            acc[q][2][e] = fmaf(w.z, ve[e], acc[q][2][e]);
            acc[q][3][e] = fmaf(w.w, ve[e], acc[q][3][e]);
          }
        }
      }
    });
    trade_halves<E, 4>(acc, S.xch, x.j, g);
    if (x.j < H) {
      const float4 b = ld4(R + L.bg + x.j * 4);
#pragma unroll
      for (int q = 0; q < NQO; ++q) {
        const int o = x.j * E + q * 4 + eout;
        const float4 c4 = ld4(cs + o);
        const float cin[4] = {c4.x, c4.y, c4.z, c4.w};
        float cn[4], hn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gi = sigmoid(acc[q][0][e] + b.x);
          const float gf = sigmoid(acc[q][1][e] + b.y);
          const float gg = tanhf(acc[q][2][e] + b.z);
          const float go = sigmoid(acc[q][3][e] + b.w);
          cn[e] = gf * cin[e] + gi * gg;
          hn[e] = go * tanhf(cn[e]);
        }
        *reinterpret_cast<float4*>(cs + o) = make_float4(cn[0], cn[1], cn[2], cn[3]);
        *reinterpret_cast<float4*>(hnew + o) = make_float4(hn[0], hn[1], hn[2], hn[3]);
      }
    }
  }
  consumers_sync();  // phase: gates and cell

  // shared head s = relu(ws h + bs), ws streamed (the learner's with noise)
  {
    const int jj = x.j < HH ? x.j : 0;
    const float eo = NOISY ? S.eout_s[jj] : 0.f;
    float acc[NQ][1][4] = {};
    stream_rows<E>(segs[2], S, x.full0, x.empty0, n, x.lane,
                      [&](const float* buf, int nr, int r0) {
#pragma unroll (SP::UNROLL)
      for (int k = kfirst(r0); k < nr; k += KSTEP) {
        float wv = buf[k * HH + jj];
        if (NOISY)
          wv = __fadd_rn(wv, __fmul_rn(buf[(nr + k) * HH + jj],
                                       __fmul_rn(eo, S.ein_s[r0 + k])));
        const float* xr = hnew + (r0 + k) * E + ein;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 v = ld4(xr + q * 4);
          acc[q][0][0] = fmaf(wv, v.x, acc[q][0][0]);
          acc[q][0][1] = fmaf(wv, v.y, acc[q][0][1]);
          acc[q][0][2] = fmaf(wv, v.z, acc[q][0][2]);
          acc[q][0][3] = fmaf(wv, v.w, acc[q][0][3]);
        }
      }
    });
    trade_halves<E, 1>(acc, S.xch, x.j, g);
    if (x.j < HH) {
      float b = R[L.bs + x.j];
      if (NOISY) b = __fadd_rn(b, __fmul_rn(Rs[L.sbs + x.j], eo));
#pragma unroll
      for (int q = 0; q < NQO; ++q)
        *reinterpret_cast<float4*>(S.f1s + x.j * E + q * 4 + eout) =
            make_float4(fmaxf(acc[q][0][0] + b, 0.f),
                        fmaxf(acc[q][0][1] + b, 0.f),
                        fmaxf(acc[q][0][2] + b, 0.f),
                        fmaxf(acc[q][0][3] + b, 0.f));
    }
  }
  consumers_sync();  // phase: shared head

  // A head: a warp per (action, group of 8 envs), lanes split the HH terms,
  // a fixed xor butterfly sums them (every lane ends with the same sums)
  for (int task = x.warp; task < 3 * (E / 8); task += NCW) {
    const int a = task % 3, q = task / 3;
    const float eo = NOISY ? S.eout_a[a] : 0.f;
    float acc[8] = {};
    for (int jh = x.lane; jh < HH; jh += 32) {
      float wv = R[L.wa + a * HH + jh];
      if (NOISY)
        wv = __fadd_rn(wv, __fmul_rn(Rs[L.swa + a * HH + jh],
                                     __fmul_rn(eo, S.ein_a[jh])));
      const float4 s0 = ld4(S.f1s + jh * E + q * 8);
      const float4 s1 = ld4(S.f1s + jh * E + q * 8 + 4);
      acc[0] = fmaf(wv, s0.x, acc[0]); acc[1] = fmaf(wv, s0.y, acc[1]);
      acc[2] = fmaf(wv, s0.z, acc[2]); acc[3] = fmaf(wv, s0.w, acc[3]);
      acc[4] = fmaf(wv, s1.x, acc[4]); acc[5] = fmaf(wv, s1.y, acc[5]);
      acc[6] = fmaf(wv, s1.z, acc[6]); acc[7] = fmaf(wv, s1.w, acc[7]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    if (x.lane == 0) {
      float b = R[L.ba + a];
      if (NOISY) b = __fadd_rn(b, __fmul_rn(Rs[L.sba + a], eo));
      float* out = S.adv + a * E + q * 8;
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[0] + b, acc[1] + b, acc[2] + b, acc[3] + b);
      *reinterpret_cast<float4*>(out + 4) =
          make_float4(acc[4] + b, acc[5] + b, acc[6] + b, acc[7] + b);
    }
  }
  consumers_sync();  // phase: A head
}

template <int E>
__device__ void consume(const Args& a, const Layout& L, const Smem<E>& S,
                        const Ctx& x, bool noisy) {
  constexpr int SF = stage_floats<E>();
  const int B = a.B, H = L.H, HH = L.HH, HE = L.H * E;
  const int t = x.t;
  const float eps = __fmul_rn(__int2float_rn(a.eps_i), 1e-6f);
  uint32_t n = 0;   // chunks consumed
  for (int blk = blockIdx.x; blk < a.info[2]; blk += gridDim.x) {
    const int* row = a.table + (size_t)blk * (E + 1);
    const int m = row[0];
    const float* ow = a.opp + (size_t)m * L.net;
    Seg segs[N_SEGS];
#pragma unroll
    for (int i = 0; i < N_SEGS; ++i)
      segs[i] = segment(i, L, ow, a.learner, a.sigma, SF, noisy);
    if (t < E) S.env[t] = row[1 + t];
    for (int i = t; i < L.w2; i += NC) {
      S.res_o[i] = ow[i];
      S.res_l[i] = a.learner[i];
    }
    for (int i = t; i < L.sws; i += NC) S.res_s[i] = a.sigma[i];
    consumers_sync();  // phase: round start

    // the block's tile (lanes fill from 0; an all-idle block uses tile 0)
    const int env0 = S.env[0] < 0 ? 0 : S.env[0];
    const uint32_t seed_mix =
        a.seed ^ ((uint32_t)(a.tile0 + env0 / a.tile_rows) * 747796405u);
    // both streams in: hid rows [h_b; c_b; h_opp; c_opp], column = env
    for (int o = t; o < HE; o += NC) {
      const int j = o / E, env = S.env[o % E];
      const bool v = env >= 0;
      S.h[o] = v ? a.hid_in[(size_t)j * B + env] : 0.f;
      S.c[o] = v ? a.hid_in[(size_t)(H + j) * B + env] : 0.f;
      S.h[2 * HE + o] = v ? a.hid_in[(size_t)(2 * H + j) * B + env] : 0.f;
      S.c[HE + o] = v ? a.hid_in[(size_t)(3 * H + j) * B + env] : 0.f;
    }
    EnvRow es = {};
    float st[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int env = t < E ? S.env[t] : -1;
    const bool valid = env >= 0;
    const uint32_t lane = valid ? (uint32_t)(env % a.tile_rows) : 0u;
    if (valid) es = load_env(a.f_in, a.i_in, B, env);
    const float pool_f = m > 0 ? 1.f : 0.f;

    int p = 0;
    for (int s = 0; s < a.T; ++s) {
      const uint32_t ctr = (uint32_t)s * 16u;
      // this step's learner noise (the tile's draw) and the observations
      for (int i = t; noisy && i < H + 2 * HH + 3; i += NC) {
        if (i < H) S.ein_s[i] = hash_noise(a.p, seed_mix, ctr, 10, 11, 0, i);
        else if (i < H + HH) S.ein_a[i - H] = hash_noise(a.p, seed_mix, ctr, 10, 11, 1, i - H);
        else if (i < H + 2 * HH) S.eout_s[i - H - HH] = hash_noise(a.p, seed_mix, ctr, 12, 13, i - H - HH, 0);
        else S.eout_a[i - H - 2 * HH] = hash_noise(a.p, seed_mix, ctr, 12, 13, i - H - 2 * HH, 1);
      }
      if (t < E) {
        const float o7[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
#pragma unroll
        for (int i = 0; i < 7; ++i) S.obs[i * E + t] = o7[i];
      }
      consumers_sync();  // phase: noise and obs

      // the block's opponent
      net_pass<E, false>(x, L, S, S.res_o, nullptr, segs, 1, p, n);
      int act_a = 0;
      if (t < E) {
        const float a3[3] = {S.adv[t], S.adv[E + t], S.adv[2 * E + t]};
        act_a = argmax3(a3);
      }
      // the learner, its heads noisy unless its sigmas are all zero
      if (noisy)
        net_pass<E, true>(x, L, S, S.res_l, S.res_s, segs + 3, 0, p, n);
      else
        net_pass<E, false>(x, L, S, S.res_l, nullptr, segs + 3, 0, p, n);

      if (t < E) {
        int done = 0;
        if (valid) {
          const float a3[3] = {S.adv[t], S.adv[E + t], S.adv[2 * E + t]};
          const int greedy_b = argmax3(a3);
          const float u_expl = hash_u01(seed_mix, ctr, 5, 0, lane);
          int rand_a = (int)__fmul_rn(hash_u01(seed_mix, ctr, 6, 0, lane), 3.0f);
          rand_a = rand_a < 0 ? 0 : (rand_a > 2 ? 2 : rand_a);
          const int act_b = u_expl < eps ? rand_a : greedy_b;
          const StepOut o = env_transition(a.p, es, act_a, act_b);
          if (a.tr_obs != nullptr) {
            const size_t r = (size_t)s * B + env;
            const float obs7[7] = {es.x, es.y, es.vx, es.vy, es.bot, es.top, es.spin};
#pragma unroll
            for (int i = 0; i < 7; ++i) a.tr_obs[r * 7 + i] = obs7[i];
            a.tr_act[r] = act_b;
            a.tr_rew[r] = o.reward_b;
            a.tr_done[r] = o.done ? 1 : 0;
          }
          env_account_reset(a.p, es, o, seed_mix, ctr, lane, pool_f, st);
          done = o.done ? 1 : 0;
        }
        S.done[t] = done;
      }
      consumers_sync();  // phase: env step
      p ^= 1;
      // a new episode starts both streams from zero
      for (int o = t; o < HE; o += NC) {
        if (S.done[o % E]) {
          S.h[p * HE + o] = 0.f; S.c[o] = 0.f;
          S.h[(2 + p) * HE + o] = 0.f; S.c[HE + o] = 0.f;
        }
      }
    }
    consumers_sync();

    for (int o = t; o < HE; o += NC) {
      const int j = o / E, e_env = S.env[o % E];
      if (e_env < 0) continue;
      a.hid_out[(size_t)j * B + e_env] = S.h[p * HE + o];
      a.hid_out[(size_t)(H + j) * B + e_env] = S.c[o];
      a.hid_out[(size_t)(2 * H + j) * B + e_env] = S.h[(2 + p) * HE + o];
      a.hid_out[(size_t)(3 * H + j) * B + e_env] = S.c[HE + o];
    }
    if (valid) {
      store_env(es, a.f_out, a.i_out, B, env);
      a.i_out[4 * B + env] = m;
#pragma unroll
      for (int r = 0; r < 7; ++r) a.stats[r * B + env] = st[r];
      a.stats[7 * B + env] = 0.f;
    }
    consumers_sync();  // phase: round end (the next rewrites the block)
  }
}

template <int E>
__global__ void __launch_bounds__(THREADS, 1)
recurrent_rollout_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) char smem_raw[];
  const Layout L(a.F1, a.F, a.H, a.HH);
  const Smem<E> S(smem_raw, L);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t full0 = smem_u32(S.bar);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  if (tid == 0) {
    for (int i = 0; i < S.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // All-zero sigmas (a greedy evaluation) make the noisy heads the mu
  // heads exactly (mu + 0 * eps == mu): the launch then streams no sigmas
  // and draws no noise. The barriers exist before any copy or arrival.
  int nonzero = 0;
  for (int i = tid; i < L.sig && !nonzero; i += THREADS)
    nonzero = a.sigma[i] != 0.f;
  const bool noisy = __syncthreads_or(nonzero) != 0;

  if (warp == NCW) {
    if (lane == 0) produce<E>(a, L, S, full0, empty0, noisy);
    __syncwarp();
  } else {
    Ctx x;
    x.t = tid; x.warp = warp; x.lane = lane;
    x.j = ((warp & 3) << 5) | lane;
    x.ebase = (warp >> 2) * (E / 2);
    x.full0 = full0; x.empty0 = empty0;
    consume<E>(a, L, S, x, noisy);
  }
}

template <int E>
cudaError_t prepare(const Layout& L, size_t* smem) {
  const Smem<E> S(nullptr, L);
  *smem = S.bytes;
  if (S.stages < 2) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(recurrent_rollout_kernel<E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)S.bytes);
}

// out: threads, smem bytes, ring stages, blocks an SM, blocks resident at
// once on the current card, floats a stage
template <int E>
int config_t(const Layout& L, int* out) {
  size_t smem;
  cudaError_t err = prepare<E>(L, &smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, recurrent_rollout_kernel<E>, THREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Smem<E> S(nullptr, L);
  out[0] = THREADS; out[1] = (int)smem; out[2] = S.stages;
  out[3] = per_sm; out[4] = per_sm * sms; out[5] = stage_floats<E>();
  return 0;
}

template <int E>
int launch_t(const Args& a, int grid, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare<E>(Layout(a.F1, a.F, a.H, a.HH), &smem);
  if (err != cudaSuccess) return (int)err;
  recurrent_rollout_kernel<E><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the block table --------------------------------------------------------

constexpr int BT_THREADS = 1024;

// The kernel's env lists on the card, in one block (the plain version is
// ops/recurrent_rollout.py::block_table): row r of `table` (n_rows x (1 +
// E)) = [member, env ids in lane order, -1 on idle lanes] for r < the
// block count, which goes to info[2] with the least and the greatest
// opp_idx (info[0], info[1]). Envs go in (member, tile, index) order: a
// warp walks a tile 32 envs at a time, ranking each env among the tile's
// envs of its member (__match_any_sync); each member's segments then take
// consecutive blocks of E. scratch: B + n_slots * n_tiles ints. Integer work only,
// in a fixed order: the table does not depend on the schedule.
__global__ void __launch_bounds__(BT_THREADS)
block_table_kernel(const int* __restrict__ opp, int B, int tile_rows,
                   int n_slots, int E, int n_rows,
                   int* __restrict__ table, int* __restrict__ info,
                   int* __restrict__ scratch) {
  extern __shared__ int bt_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = BT_THREADS / 32, n_tiles = B / tile_rows;
  int* cnt = bt_smem + warp * n_slots;            // a warp's running counts
  int* member_end = bt_smem + nw * n_slots;       // n_slots
  int* red = member_end + n_slots;                // lo, hi
  int* rank = scratch;                            // B
  int* seg0 = scratch + B;                        // first block of (m, t)
  if (tid == 0) { red[0] = 0x7fffffff; red[1] = -0x7fffffff - 1; }
  __syncthreads();
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int i = tid; i < B; i += BT_THREADS) {
    lo = min(lo, opp[i]);
    hi = max(hi, opp[i]);
  }
  atomicMin(&red[0], lo);
  atomicMax(&red[1], hi);
  // ranks within each (member, tile) segment, and the segments' sizes
  for (int t = warp; t < n_tiles; t += nw) {
    for (int m = lane; m < n_slots; m += 32) cnt[m] = 0;
    __syncwarp();
    for (int e0 = t * tile_rows; e0 < (t + 1) * tile_rows; e0 += 32) {
      const int i = e0 + lane;
      const bool on = i < (t + 1) * tile_rows;
      const int m = on ? min(max(opp[i], 0), n_slots - 1) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, m);
      const int before = __popc(peers & ((1u << lane) - 1u));
      const int base = on ? cnt[m] : 0;
      __syncwarp();
      if (on) {
        rank[i] = base + before;
        if (before == 0) cnt[m] = base + __popc(peers);
      }
      __syncwarp();
    }
    for (int m = lane; m < n_slots; m += 32) seg0[m * n_tiles + t] = cnt[m];
    __syncwarp();
  }
  __syncthreads();
  // each member's first blocks of its segments (a thread a member), then
  // the members' runs in order
  for (int m = tid; m < n_slots; m += BT_THREADS) {
    int acc = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int k = seg0[m * n_tiles + t];
      seg0[m * n_tiles + t] = acc;
      acc += (k + E - 1) / E;
    }
    member_end[m] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    for (int m = 1; m < n_slots; ++m) member_end[m] += member_end[m - 1];
    info[0] = red[0]; info[1] = red[1]; info[2] = member_end[n_slots - 1];
  }
  __syncthreads();
  for (int r = tid; r < n_rows; r += BT_THREADS) {
    int m = 0;
    while (m < n_slots && member_end[m] <= r) ++m;
    table[r * (E + 1)] = m;
    for (int l = 1; l <= E; ++l) table[r * (E + 1) + l] = -1;
  }
  __syncthreads();
  for (int i = tid; i < B; i += BT_THREADS) {
    const int m = min(max(opp[i], 0), n_slots - 1), t = i / tile_rows;
    const int start = m == 0 ? 0 : member_end[m - 1];
    const int blk = start + seg0[m * n_tiles + t] + rank[i] / E;
    table[blk * (E + 1) + 1 + rank[i] % E] = i;
  }
}

#define RR_DISPATCH(FN, ...)                                          \
  switch (envs) {                                                     \
    case 8: return FN<8>(__VA_ARGS__);                                \
    case 16: return FN<16>(__VA_ARGS__);                              \
    case 32: return FN<32>(__VA_ARGS__);                              \
    default: return (int)cudaErrorInvalidValue;                       \
  }

}  // namespace

extern "C" {

// The launch shape of E = envs envs a block at these widths: out[6] =
// threads, dynamic shared memory bytes, ring stages, blocks an SM, blocks
// resident at once on the current card, floats a ring stage. Returns a
// cudaError_t.
int recurrent_rollout_config(int envs, int F1, int F, int H, int HH,
                             int* out) {
  const Layout L(F1, F, H, HH);
  RR_DISPATCH(config_t, L, out)
}

// Launch one recurrent rollout chunk on `stream` as `grid` blocks, each
// walking the table's blocks in turn; the block count is read on the card
// from info[2], where recurrent_rollout_table put it, and blocks beyond it
// have nothing to do. Widths multiples of 4 and <= 128 (the Python wrapper
// pads others with zero units), tile_rows a multiple of 8, envs in {8, 16,
// 32} (checked by the Python wrapper); tile0 is the global index of this
// call's first tile, which keys the hash.
// Transition pointers may all be null (eval mode). Returns the cudaError_t
// of the launch.
int recurrent_rollout_launch(const EnvP* p, const float* f_in, const int* i_in,
                             const float* hid_in, const float* learner,
                             const float* sigma, const float* opp,
                             float* f_out, int* i_out, float* hid_out,
                             float* tr_obs, int* tr_act, float* tr_rew,
                             int* tr_done, float* stats, const int* table,
                             const int* info, int envs, int grid, int B,
                             int T, int tile_rows, int tile0,
                             unsigned int seed,
                             int eps_i, int F1, int F, int H, int HH,
                             cudaStream_t stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.p = *p;
  a.f_in = f_in; a.i_in = i_in; a.hid_in = hid_in; a.learner = learner;
  a.sigma = sigma; a.opp = opp; a.f_out = f_out; a.i_out = i_out;
  a.hid_out = hid_out; a.tr_obs = tr_obs; a.tr_act = tr_act;
  a.tr_rew = tr_rew; a.tr_done = tr_done; a.stats = stats; a.table = table;
  a.info = info;
  a.B = B; a.T = T; a.tile_rows = tile_rows; a.tile0 = tile0; a.seed = seed;
  a.eps_i = eps_i;
  a.F1 = F1; a.F = F; a.H = H; a.HH = HH;
  RR_DISPATCH(launch_t, a, grid, stream)
}

// Build the block table on `stream` (block_table_kernel): table n_rows x
// (1 + envs), info[3] = least and greatest opp_idx and the block count,
// scratch B + n_slots * (B / tile_rows) ints. Returns a cudaError_t.
int recurrent_rollout_table(const int* opp, int B, int tile_rows, int n_slots,
                            int envs, int n_rows, int* table,
                            int* info, int* scratch, cudaStream_t stream) {
  const size_t smem = (size_t)((BT_THREADS / 32 + 1) * n_slots + 2) * 4;
  if (smem > 48 * 1024 || B % tile_rows) return (int)cudaErrorInvalidValue;
  block_table_kernel<<<1, BT_THREADS, smem, stream>>>(
      opp, B, tile_rows, n_slots, envs, n_rows, table, info, scratch);
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
