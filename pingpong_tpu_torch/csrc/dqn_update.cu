// Fused DQN update block: K sequential PER + Double-DQN updates in one
// launch of one thread-block cluster.
//
// Replaces the TPU kernel pingpong_tpu/ops/dqn_update.py::
// pallas_dqn_update_block (body _update_kernel). Each update k: inverse-CDF
// prioritized sample of bs slots from pre-drawn uniforms (chunk level over
// the chunk sums, then slot level inside the chunk), the fetch of each
// sampled transition from the chunk-block ring, the online forward over
// obs and next with this update's head noise, the mu-only target forward,
// the IS-weighted MSE of the Double-DQN TD error, a hand-written backward
// (heads only, or through the trunk), flat Adam (b1 0.9, b2 0.999, eps
// 1e-8), a hard or Polyak target sync, the priority write-back in sample
// order (the last writer of a duplicated slot wins) and an exact refresh
// of the touched chunk sums.
//
// IN PLACE: p_alpha, chunk_sums, params, target, m and v are updated in
// place; newp, idx and losses are outputs. grad is not used (the gradient
// lives in shared memory); it stays in the C interface.
//
// What bounds it on an H100: the serial chain, not bytes or FLOPs. The
// block moves about 8 MB and computes about 0.5 GFLOP (tens of microseconds
// of the card's peak), but update k+1 samples from the priorities update k
// wrote and steps from the parameters it wrote, so the K updates are a
// dependency chain, and an update's time is the latency of its steps and
// barriers. The chain does not need one SM: the design is one cluster of 8
// CTAs (the portable size) of 256 threads on 8 neighbouring SMs, which
// split each update's bs samples (bs / 8 each) and meet at 4 cluster
// barriers an update:
//   B1  each CTA scans its eighth of the chunk sums in double and publishes
//       the total in its shared memory; after B1 every CTA reads the 8
//       totals through distributed shared memory (DSMEM), rounds its slice
//       of the CDF to f32 and stores it into every CTA's CDF. The prefixes
//       are exact in double (see the CDF note below), so the CDF is bit for
//       bit the one-block scan's and the plain version's.
//   B2  every CTA now holds the whole CDF. Eight lanes a sample, four
//       samples a warp at once: a binary search of the CDF, then a double
//       prefix over the chunk's 128 slots (16 a lane, exact for the same
//       reason), the gather of the transition and the raw IS weight. The
//       CTA's weight maximum and sampled slots are published.
//   B3  is split: its arrive comes before the three trunk forwards (target
//       on next, online on next, online on obs) and the TD errors, which
//       need nothing from the other CTAs, and its wait after them. Then
//       the cluster's weight maximum, the loss and gradient partials over
//       the CTA's samples, and the priority write-back: a sample writes
//       only if no later sample of the update has its slot.
//   B4  the parameter step is done once, by owners. The gradient entries
//       (the 260 head mu entries, then the trunk's when it trains) are cut
//       into 8 contiguous slices of about equal items, one item a thread:
//       a head entry with its sigma twin, or a row of 4 trunk entries.
//       CTA r reads only its slice of the 8 partials through DSMEM,
//       sums them in CTA order 0..7, applies Adam to its slice (its moments
//       are the only ones it keeps up to date) and pushes the new
//       parameters into the other CTAs' copies; the next update's B1 makes
//       them visible. Every read of a CTA's parameters in update k comes
//       before its B4 arrive, so no push overwrites a value still in use,
//       and the noisy heads, which read entries that other CTAs own, are
//       built after B1 (during B2). The target step of update k (a hard
//       sync or Polyak) runs on each CTA's own copy during B2 of update
//       k + 1, or after the final cluster barrier, once all of P has
//       landed. Then CTA r re-sums, one warp a chunk, the touched chunks of
//       its eighth, exactly, for its next scan.
// Every reduction runs in a fixed order and nothing uses float atomics, so
// a run is reproducible bit for bit. The barriers are
// barrier.cluster.arrive.release / wait.acquire: they order the global
// p_alpha writes of update k before B4 ahead of every CTA's chunk refresh
// after B4 and its slot search of update k+1, and a CTA's chunk_sums
// writes come before its own next scan (the other CTAs read only the
// published totals). p_alpha and chunk_sums are read with ld.global.cg
// (L2, never a stale L1 line). The three trunk passes are register-tiled:
// a thread computes 2 samples x 4 hidden units from float4 weight rows,
// 0.19 shared loads per FMA. No tensor cores, no TF32: the sampled index
// is a compare against f32 sums.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Hyper-parameters; each is rounded to float32 once on the host
// (ops/dqn_update.py::Hyper builds the same struct).
struct Hyper {
  float lr, gamma, tau, alpha, per_eps, beta_start, beta_slope;
  float b1, b2, one_m_b1, one_m_b2, eps, log_b1, log_b2, inv_bs, two_bs;
  int interval, heads_only;
};

namespace {

constexpr int CLUSTER = 8;
constexpr int THREADS = 256;  // 16 x 16 register tiles of the 64-wide layers
constexpr int WARPS = THREADS / 32;
constexpr int D = 7;       // obs dim
constexpr int H = 64;      // hidden
constexpr int LDA = H + 4; // row stride of the activation buffers (float4)
constexpr int CH = 128;    // slots per chunk
constexpr int R = 16;      // fields per slot in a chunk block
constexpr int MAX_NC = 8192;

// flat parameter vector, ravel_pytree order of the JAX QNetParams
constexpr int P_W1 = 0;               // (7, 64)
constexpr int P_B1 = P_W1 + D * H;    // (64)
constexpr int P_W2 = P_B1 + H;        // (64, 64)
constexpr int P_B2 = P_W2 + H * H;    // (64)
constexpr int P_WV = P_B2 + H;        // fc_v.w_mu (64, 1)
constexpr int P_WVS = P_WV + H;       // fc_v.w_sigma
constexpr int P_BV = P_WVS + H;       // fc_v.b_mu (1)
constexpr int P_BVS = P_BV + 1;       // fc_v.b_sigma
constexpr int P_WA = P_BVS + 1;       // fc_a.w_mu (64, 3)
constexpr int P_WAS = P_WA + 3 * H;   // fc_a.w_sigma
constexpr int P_BA = P_WAS + 3 * H;   // fc_a.b_mu (3)
constexpr int P_BAS = P_BA + 3;       // fc_a.b_sigma
constexpr int NP = P_BAS + 3;         // 5192
constexpr int FEAT_END = P_WV;        // trunk parameters end here
// per-update noise vector: v.eps_w (64) v.eps_b (1) a.eps_w (64,3) a.eps_b (3)
constexpr int N_EV = 0, N_EVB = H, N_EA = H + 1, N_EAB = 4 * H + 1;
constexpr int NN = 4 * H + 4;         // 260: also the head gradient entries
static_assert(NP % CLUSTER == 0 && NN % 4 == 0 && FEAT_END % 4 == 0,
              "owner slices at multiples of 4, write-out by eighths");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// block-wide sum in a fixed order: warp trees, then the warps in order
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += red[w];
    red[WARPS] = t;
  }
  __syncthreads();
  return red[WARPS];
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// out[s, j] = relu(b[j] + sum_i in[s, i] * W[i, j]) for s < n, j < 64.
// Thread (rg, cg) computes samples 2 rg, 2 rg + 1 (+32 per round) x units
// 4 cg..4 cg+3 from float4 rows of W; sums run over i in order.
template <int NIN, int LDIN>
__device__ void dense_relu(const float* in, const float* W, const float* b,
                           float* out, int n) {
  const int cgp = threadIdx.x & 15, rg = threadIdx.x >> 4;
  const float4 bb = *reinterpret_cast<const float4*>(b + 4 * cgp);
  for (int s0 = 2 * rg; s0 < n; s0 += 32) {
    float a[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const float* i0 = in + s0 * LDIN;
    const float* i1 = i0 + LDIN;
    if constexpr (NIN % 4 == 0) {
      for (int i = 0; i < NIN; i += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(i0 + i);
        const float4 x1 = *reinterpret_cast<const float4*>(i1 + i);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 w = *reinterpret_cast<const float4*>(W + (i + u) * H + 4 * cgp);
          const float e0 = comp(x0, u), e1 = comp(x1, u);
          a[0][0] = fmaf(e0, w.x, a[0][0]); a[0][1] = fmaf(e0, w.y, a[0][1]);
          a[0][2] = fmaf(e0, w.z, a[0][2]); a[0][3] = fmaf(e0, w.w, a[0][3]);
          a[1][0] = fmaf(e1, w.x, a[1][0]); a[1][1] = fmaf(e1, w.y, a[1][1]);
          a[1][2] = fmaf(e1, w.z, a[1][2]); a[1][3] = fmaf(e1, w.w, a[1][3]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NIN; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(W + i * H + 4 * cgp);
        const float e0 = i0[i], e1 = i1[i];
        a[0][0] = fmaf(e0, w.x, a[0][0]); a[0][1] = fmaf(e0, w.y, a[0][1]);
        a[0][2] = fmaf(e0, w.z, a[0][2]); a[0][3] = fmaf(e0, w.w, a[0][3]);
        a[1][0] = fmaf(e1, w.x, a[1][0]); a[1][1] = fmaf(e1, w.y, a[1][1]);
        a[1][2] = fmaf(e1, w.z, a[1][2]); a[1][3] = fmaf(e1, w.w, a[1][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(out + (s0 + r) * LDA + 4 * cgp) = make_float4(
          fmaxf(a[r][0] + bb.x, 0.f), fmaxf(a[r][1] + bb.y, 0.f),
          fmaxf(a[r][2] + bb.z, 0.f), fmaxf(a[r][3] + bb.w, 0.f));
  }
  __syncthreads();
}

// dueling Q of sample s from its second hidden layer
__device__ void q_values(const float* f2, const float* wv, float bv,
                         const float* wa, const float* ba, float* q) {
  float v = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int h = 0; h < H; ++h) {
    const float x = f2[h];
    v = fmaf(x, wv[h], v);
    a0 = fmaf(x, wa[h * 3 + 0], a0);
    a1 = fmaf(x, wa[h * 3 + 1], a1);
    a2 = fmaf(x, wa[h * 3 + 2], a2);
  }
  v += bv;
  a0 += ba[0];
  a1 += ba[1];
  a2 += ba[2];
  const float mean = (a0 + a1 + a2) / 3.0f;
  q[0] = (v + a0) - mean;
  q[1] = (v + a1) - mean;
  q[2] = (v + a2) - mean;
}

// First gradient entry of CTA r's owner slice. The step is latency-bound,
// so the slices balance items, one a thread: a head entry with its sigma
// twin (e < NN) or a row of 4 trunk parameters (e >= NN is the trunk's
// parameter e - NN; a slice's trunk part starts at a multiple of 4).
__device__ __forceinline__ int slice_lo(int r, int n_grad) {
  const int t = (NN + (n_grad - NN) / 4) * r / CLUSTER;   // items before slice r
  return t <= NN ? t : NN + 4 * (t - NN);
}

// head gradient entry e < NN: its mu parameter, its sigma twin, its noise
__device__ __forceinline__ int3 head_entry(int e) {
  if (e < H) return make_int3(P_WV + e, P_WVS + e, N_EV + e);
  if (e < 4 * H) return make_int3(P_WA + e - H, P_WAS + e - H, N_EA + e - H);
  if (e == 4 * H) return make_int3(P_BV, P_BVS, N_EVB);
  const int a = e - 4 * H - 1;
  return make_int3(P_BA + a, P_BAS + a, N_EAB + a);
}

__device__ __forceinline__ double warp_scan_inclusive(double v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Shared memory of one CTA for spc samples a CTA, bs samples, nc chunks.
struct Smem {
  double *tot, *tots, *redd;
  float *P, *T, *M, *V, *gp, *cdf, *cs, *bufA, *bufB, *x, *xn, *noise, *wv,
      *wa, *bh, *rew, *done, *wraw, *td, *dv, *da, *qt, *newpa, *red, *pub;
  int *act, *na, *idx, *all_idx;
  size_t bytes;
  __host__ __device__ Smem(char* base, int spc, int bs, int nc) {
    size_t o = 0;
    auto d = [&](int n) { double* p = (double*)(base + o); o += 8 * (size_t)n; return p; };
    auto f = [&](int n) { float* p = (float*)(base + o); o += 4 * (size_t)((n + 3) & ~3); return p; };
    auto i = [&](int n) { int* p = (int*)(base + o); o += 4 * (size_t)((n + 3) & ~3); return p; };
    tot = d(2); tots = d(CLUSTER); redd = d(32);
    P = f(NP); T = f(NP); M = f(NP); V = f(NP); gp = f(NP);
    cdf = f(nc); cs = f(nc / CLUSTER);
    bufA = f(spc * LDA); bufB = f(spc * LDA);
    x = f(spc * 8); xn = f(spc * 8);
    noise = f(NN); wv = f(H); wa = f(3 * H); bh = f(4);
    rew = f(spc); done = f(spc); wraw = f(spc); td = f(spc); dv = f(spc);
    da = f(3 * spc); qt = f(3 * spc); newpa = f(spc);
    red = f(64); pub = f(4);
    act = i(spc); na = i(spc); idx = i(spc); all_idx = i(bs);
    bytes = o;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
dqn_update_kernel(int ts0, int count0, int frame0, int size, int K, int bs,
                  int nc, Hyper hp, const float* __restrict__ u01,
                  const float* __restrict__ noise, float* p_alpha,
                  float* chunk_sums, float* params, float* target, float* m,
                  float* v, const float* __restrict__ data,
                  float* __restrict__ newp_out, int* __restrict__ idx_out,
                  float* __restrict__ losses) {
  extern __shared__ __align__(16) char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int spc = bs / CLUSTER;          // samples of this CTA
  const int ns = nc / CLUSTER;           // chunks of this CTA's CDF share
  const int c_lo = rank * ns;
  const Smem S(smem_raw, spc, bs, nc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this CTA's owner slice: nh head entries from e_lo, then trunk rows of
  // 4 parameters from tr; n_items items in all
  const int n_grad = hp.heads_only ? NN : NN + FEAT_END;
  const int e_lo = slice_lo(rank, n_grad), e_hi = slice_lo(rank + 1, n_grad);
  const int nh = max(0, min(e_hi, NN) - e_lo);
  const int tr = max(e_lo, NN) - NN;
  const int n_items = nh + max(0, e_hi - max(e_lo, NN)) / 4;
  // update kk's target step on [i0, i1), once all of its P is in place
  auto target_step = [&](int kk, int i0, int i1) {
    if (hp.tau > 0.f) {
      for (int i = i0 + tid; i < i1; i += THREADS) S.T[i] = S.T[i] + hp.tau * (S.P[i] - S.T[i]);
    } else if (((ts0 + kk + 1) % hp.interval) == 0) {
      for (int i = i0 + tid; i < i1; i += THREADS) S.T[i] = S.P[i];
    }
  };

  for (int i = tid; i < NP; i += THREADS) {
    S.P[i] = params[i];
    S.T[i] = target[i];
    S.M[i] = m[i];
    S.V[i] = v[i];
  }
  for (int i = tid; i < ns; i += THREADS) S.cs[i] = __ldcg(chunk_sums + c_lo + i);
  __syncthreads();

  for (int k = 0; k < K; ++k) {   // phase: update start
    // ---- B1: this CTA's share of the CDF, exact in double -----------------
    // Thread tid holds chunks 4 tid .. 4 tid + 3 of the share (ns <= 1024).
    const int lo = 4 * tid;
    const bool mine = lo < ns;
    const float4 c4 = mine ? *reinterpret_cast<const float4*>(S.cs + lo)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const double run = (((double)c4.x + (double)c4.y) + (double)c4.z) + (double)c4.w;
    const double inc = warp_scan_inclusive(run, lane);
    const double ex_lane = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 31) S.redd[warp] = inc;
    __syncthreads();
    if (tid == 0) {
      double acc = 0.0;
      for (int w = 0; w < WARPS; ++w) {
        const double t = S.redd[w];
        S.redd[w] = acc;
        acc += t;
      }
      S.tot[0] = acc;
    }
    __syncthreads();
    cluster_arrive();   // phase: B1 arrive
    // meanwhile: this update's head noise
    for (int i = tid; i < NN; i += THREADS) S.noise[i] = noise[k * NN + i];
    cluster_wait();     // phase: B1 wait
    if (tid < CLUSTER) S.tots[tid] = *cluster.map_shared_rank(S.tot, tid);
    __syncthreads();
    double off = 0.0, all = 0.0;
    for (int c = 0; c < CLUSTER; ++c) {
      if (c < rank) off += S.tots[c];
      all += S.tots[c];
    }
    if (mine) {   // this thread's 4 CDF entries, into every CTA's CDF
      double acc = off + S.redd[warp] + (lane == 0 ? 0.0 : ex_lane);
      float4 v4;
      acc += (double)c4.x; v4.x = (float)acc;
      acc += (double)c4.y; v4.y = (float)acc;
      acc += (double)c4.z; v4.z = (float)acc;
      acc += (double)c4.w; v4.w = (float)acc;
      for (int c = 0; c < CLUSTER; ++c)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(S.cdf, c) + c_lo + lo) = v4;
    }
    cluster_arrive();   // phase: B2 arrive
    // meanwhile, all of update k - 1's pushes in place: its target step
    // and this update's noisy heads
    if (k > 0) target_step(k - 1, 0, NP);
    for (int i = tid; i < H; i += THREADS)
      S.wv[i] = S.P[P_WV + i] + S.P[P_WVS + i] * S.noise[N_EV + i];
    for (int i = tid; i < 3 * H; i += THREADS)
      S.wa[i] = S.P[P_WA + i] + S.P[P_WAS + i] * S.noise[N_EA + i];
    if (tid == 0) S.bh[0] = S.P[P_BV] + S.P[P_BVS] * S.noise[N_EVB];
    if (tid < 3) S.bh[1 + tid] = S.P[P_BA + tid] + S.P[P_BAS + tid] * S.noise[N_EAB + tid];
    cluster_wait();     // phase: B2 wait

    // ---- B2: 8 lanes a sample: search, slot prefix, gather ---------------
    const float total = (float)all;
    const int frame_i = frame0 + k + 1;
    const float beta = fminf(1.0f, hp.beta_start + (float)frame_i * hp.beta_slope);
    // 8 lanes a sample (16 slots a lane), 4 samples a warp at a time
    const int sub = lane >> 3, sl = lane & 7;
    for (int ls = warp * 4 + sub; ls < spc; ls += WARPS * 4) {
      const int g = rank * spc + ls;
      const float uu = u01[k * bs + g] * total;
      int l = 0, h = nc;  // first index with cdf >= uu == #(cdf < uu)
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (S.cdf[mid] < uu) l = mid + 1; else h = mid;
      }
      int c = min(l, nc - 1);
      c = min(c, size / CH - 1);
      const float resid = uu - (c > 0 ? S.cdf[c - 1] : 0.f);
      const float4* row4 = reinterpret_cast<const float4*>(p_alpha + (size_t)c * CH) + 4 * sl;
      float e[16];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 q = __ldcg(row4 + u);
        e[4 * u] = q.x; e[4 * u + 1] = q.y; e[4 * u + 2] = q.z; e[4 * u + 3] = q.w;
      }
      double d[16];
      d[0] = (double)e[0];
#pragma unroll
      for (int u = 1; u < 16; ++u) d[u] = d[u - 1] + (double)e[u];
      double incl = d[15];
      for (int o = 1; o < 8; o <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, incl, o, 8);
        if (sl >= o) incl += n;
      }
      double ex = __shfl_up_sync(0xffffffffu, incl, 1, 8);
      if (sl == 0) ex = 0.0;
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < 16; ++u) cnt += (float)(ex + d[u]) < resid ? 1 : 0;
      for (int o = 4; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o, 8);
      const int offs = min(cnt, CH - 1);
      float mine = 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) mine = (offs & 15) == u ? e[u] : mine;
      const float pa_val = __shfl_sync(0xffffffffu, mine, (offs >> 4), 8);
      for (int f = sl; f < R; f += 8) {
        const float fv = __ldg(data + ((size_t)c * R + f) * CH + offs);
        if (f < D) S.x[ls * 8 + f] = fv;
        else if (f < 2 * D) S.xn[ls * 8 + f - D] = fv;
        else if (f == 2 * D) S.rew[ls] = fv;
        else {
          const float done = fv > 3.5f ? 1.f : 0.f;
          S.done[ls] = done;
          S.act[ls] = (int)(fv - 4.0f * done);
        }
      }
      if (sl == 0) {
        const float probs = pa_val / fmaxf(total, 1e-30f);
        S.wraw[ls] = expf(-beta * logf((float)size * fmaxf(probs, 1e-30f)));
        S.idx[ls] = c * CH + offs;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float w = 0.f;
      for (int s = lane; s < spc; s += 32) w = fmaxf(w, S.wraw[s]);
      for (int o = 16; o > 0; o >>= 1) w = fmaxf(w, __shfl_down_sync(0xffffffffu, w, o));
      if (lane == 0) S.pub[0] = w;
    }
    __syncthreads();
    cluster_arrive();   // phase: B3 arrive (weight maximum, slots published)

    // ---- target forward (mu only) on next ------------------------------
    dense_relu<D, 8>(S.xn, S.T + P_W1, S.T + P_B1, S.bufA, spc);
    dense_relu<H, LDA>(S.bufA, S.T + P_W2, S.T + P_B2, S.bufB, spc);
    if (tid < spc) q_values(S.bufB + tid * LDA, S.T + P_WV, S.T[P_BV], S.T + P_WA,
                            S.T + P_BA, S.qt + 3 * tid);
    __syncthreads();
    // ---- online forward on next: the Double-DQN argmax -----------------
    dense_relu<D, 8>(S.xn, S.P + P_W1, S.P + P_B1, S.bufA, spc);
    dense_relu<H, LDA>(S.bufA, S.P + P_W2, S.P + P_B2, S.bufB, spc);
    if (tid < spc) {
      float q[3];
      q_values(S.bufB + tid * LDA, S.wv, S.bh[0], S.wa, S.bh + 1, q);
      const int na0 = q[1] > q[0] ? 1 : 0;
      S.na[tid] = q[2] > fmaxf(q[0], q[1]) ? 2 : na0;
    }
    __syncthreads();
    // ---- online forward on obs: f1 in bufA, f2 in bufB kept; TD ----------
    dense_relu<D, 8>(S.x, S.P + P_W1, S.P + P_B1, S.bufA, spc);
    dense_relu<H, LDA>(S.bufA, S.P + P_W2, S.P + P_B2, S.bufB, spc);
    if (tid < spc) {
      float q[3];
      q_values(S.bufB + tid * LDA, S.wv, S.bh[0], S.wa, S.bh + 1, q);
      const float nq = S.qt[3 * tid + S.na[tid]];
      const float y = S.rew[tid] + hp.gamma * nq * (1.0f - S.done[tid]);
      const float td = q[S.act[tid]] - y;
      S.td[tid] = td;
      const int g = rank * spc + tid;
      const float np_ = fabsf(td) + hp.per_eps;
      newp_out[k * bs + g] = np_;
      idx_out[k * bs + g] = S.idx[tid];
      S.newpa[tid] = expf(hp.alpha * logf(np_));   // p_alpha of the new priority
    }
    cluster_wait();     // phase: B3 wait

    // ---- IS weights, loss and gradient partials, write-back --------------
    if (tid < CLUSTER) S.red[32 + tid] = *cluster.map_shared_rank(S.pub, tid);
    for (int i = tid; i < bs; i += THREADS)
      S.all_idx[i] = cluster.map_shared_rank(S.idx, i / spc)[i % spc];
    __syncthreads();
    float w_max = 0.f;
    for (int c = 0; c < CLUSTER; ++c) w_max = fmaxf(w_max, S.red[32 + c]);
    float lterm = 0.f;
    if (tid < spc) {
      const float w = S.wraw[tid] / fmaxf(w_max, 1e-30f);
      const float td = S.td[tid];
      lterm = w * td * td;
      const float dq = hp.two_bs * w * td;
      S.dv[tid] = dq;
      const int a = S.act[tid];
      for (int j = 0; j < 3; ++j) S.da[3 * tid + j] = (j == a ? dq : 0.f) - dq / 3.0f;
    }
    const float lsum = block_sum(lterm, S.red);
    if (tid == 0) S.pub[1] = lsum;
    // last writer wins: a sample writes unless a later sample has its slot
    for (int ls = warp; ls < spc; ls += WARPS) {
      const int g = rank * spc + ls, slot = S.all_idx[g];
      bool later = false;
      for (int j = g + 1 + lane; j < bs; j += 32) later |= S.all_idx[j] == slot;
      if (!__any_sync(0xffffffffu, later) && lane == 0) p_alpha[slot] = S.newpa[ls];
    }
    // head gradient partials over this CTA's samples (f2 = bufB)
    for (int o = tid; o < NN; o += THREADS) {
      float gsum = 0.f;
      if (o < H) {                                   // dWv[h]
        for (int s = 0; s < spc; ++s) gsum = fmaf(S.dv[s], S.bufB[s * LDA + o], gsum);
        S.gp[P_WV + o] = gsum;
      } else if (o < 4 * H) {                        // dWa[h, a]
        const int hh = (o - H) / 3, a = (o - H) % 3;
        for (int s = 0; s < spc; ++s) gsum = fmaf(S.da[3 * s + a], S.bufB[s * LDA + hh], gsum);
        S.gp[P_WA + o - H] = gsum;
      } else if (o == 4 * H) {                       // dbv
        for (int s = 0; s < spc; ++s) gsum += S.dv[s];
        S.gp[P_BV] = gsum;
      } else {                                       // dba[a]
        const int a = o - 4 * H - 1;
        for (int s = 0; s < spc; ++s) gsum += S.da[3 * s + a];
        S.gp[P_BA + a] = gsum;
      }
    }
    __syncthreads();
    if (!hp.heads_only) {
      // dz2 = (wv dV + wa dA) * (f2 > 0), in place over f2
      for (int o = tid; o < spc * H; o += THREADS) {
        const int s = o / H, hh = o % H;
        float df = S.wv[hh] * S.dv[s];
        df += S.wa[hh * 3 + 0] * S.da[3 * s + 0] + S.wa[hh * 3 + 1] * S.da[3 * s + 1] +
              S.wa[hh * 3 + 2] * S.da[3 * s + 2];
        S.bufB[s * LDA + hh] = S.bufB[s * LDA + hh] > 0.f ? df : 0.f;
      }
      __syncthreads();
      {  // dW2 = f1^T dz2: a 4 x 4 tile a thread; db2 = sum dz2
        const int ig = tid >> 4, jg = tid & 15;
        float acc[4][4] = {};
        for (int s = 0; s < spc; ++s) {
          const float4 a = *reinterpret_cast<const float4*>(S.bufA + s * LDA + 4 * ig);
          const float4 b = *reinterpret_cast<const float4*>(S.bufB + s * LDA + 4 * jg);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float e = comp(a, p);
            acc[p][0] = fmaf(e, b.x, acc[p][0]); acc[p][1] = fmaf(e, b.y, acc[p][1]);
            acc[p][2] = fmaf(e, b.z, acc[p][2]); acc[p][3] = fmaf(e, b.w, acc[p][3]);
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<float4*>(S.gp + P_W2 + (4 * ig + p) * H + 4 * jg) =
              make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
        if (tid < H) {
          float gsum = 0.f;
          for (int s = 0; s < spc; ++s) gsum += S.bufB[s * LDA + tid];
          S.gp[P_B2 + tid] = gsum;
        }
      }
      __syncthreads();
      {  // dz1 = (dz2 W2^T) * (f1 > 0), in place over f1; rotated start
        const int cgp = tid & 15, rg = tid >> 4;
        for (int s0 = 2 * rg; s0 < spc; s0 += 32) {
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int jj = 0; jj < H; jj += 4) {
            const int j = (jj + 4 * cgp) & (H - 1);
            const float4 d0 = *reinterpret_cast<const float4*>(S.bufB + s0 * LDA + j);
            const float4 d1 = *reinterpret_cast<const float4*>(S.bufB + (s0 + 1) * LDA + j);
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              const float4 w = *reinterpret_cast<const float4*>(S.P + P_W2 + (4 * cgp + qq) * H + j);
              acc[0][qq] = fmaf(d0.x, w.x, acc[0][qq]); acc[0][qq] = fmaf(d0.y, w.y, acc[0][qq]);
              acc[0][qq] = fmaf(d0.z, w.z, acc[0][qq]); acc[0][qq] = fmaf(d0.w, w.w, acc[0][qq]);
              acc[1][qq] = fmaf(d1.x, w.x, acc[1][qq]); acc[1][qq] = fmaf(d1.y, w.y, acc[1][qq]);
              acc[1][qq] = fmaf(d1.z, w.z, acc[1][qq]); acc[1][qq] = fmaf(d1.w, w.w, acc[1][qq]);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              float* f = S.bufA + (s0 + r) * LDA + 4 * cgp + qq;
              *f = *f > 0.f ? acc[r][qq] : 0.f;
            }
        }
      }
      __syncthreads();
      if (tid < D * 16) {  // dW1 = x^T dz1, 4 units a thread
        const int i = tid >> 4, jg = tid & 15;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < spc; ++s) {
          const float xv = S.x[s * 8 + i];
          const float4 d = *reinterpret_cast<const float4*>(S.bufA + s * LDA + 4 * jg);
          acc[0] = fmaf(xv, d.x, acc[0]); acc[1] = fmaf(xv, d.y, acc[1]);
          acc[2] = fmaf(xv, d.z, acc[2]); acc[3] = fmaf(xv, d.w, acc[3]);
        }
        *reinterpret_cast<float4*>(S.gp + P_W1 + i * H + 4 * jg) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else if (tid < D * 16 + H) {  // db1 = sum dz1
        const int j = tid - D * 16;
        float gsum = 0.f;
        for (int s = 0; s < spc; ++s) gsum += S.bufA[s * LDA + j];
        S.gp[P_B1 + j] = gsum;
      }
      __syncthreads();
    }
    cluster_arrive();   // phase: B4 arrive (partials, loss, p_alpha writes)
    cluster_wait();     // phase: B4 wait

    // ---- owner step: this CTA's slice summed over the cluster (CTA order)
    // and stepped by Adam, then pushed into the other CTAs' parameters ----
    const float step = (float)(count0 + k + 1);
    const float bc1 = 1.0f - expf(step * hp.log_b1);
    const float bc2 = 1.0f - expf(step * hp.log_b2);
    auto adam = [&](int i, float g) {
      const float mj = S.M[i] * hp.b1 + g * hp.one_m_b1;
      const float vj = S.V[i] * hp.b2 + g * g * hp.one_m_b2;
      S.M[i] = mj;
      S.V[i] = vj;
      S.P[i] = S.P[i] - hp.lr * ((mj / bc1) / (sqrtf(vj / bc2) + hp.eps));
    };
    for (int j = tid; j < n_items; j += THREADS) {
      if (j < nh) {   // a head entry and its sigma twin
        const int3 h = head_entry(e_lo + j);
        float g = 0.f;
#pragma unroll
        for (int c = 0; c < CLUSTER; ++c) g += cluster.map_shared_rank(S.gp, c)[h.x];
        adam(h.x, g);
        adam(h.y, g * S.noise[h.z]);
      } else {        // a row of 4 trunk entries
        const int i = tr + 4 * (j - nh);
        float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < CLUSTER; ++c) {
          const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(S.gp, c) + i);
          g.x += p.x; g.y += p.y; g.z += p.z; g.w += p.w;
        }
        adam(i, g.x); adam(i + 1, g.y); adam(i + 2, g.z); adam(i + 3, g.w);
      }
    }
    // each thread pushes what it stepped: this barrier and the next only
    // mark the phases for update_phases
    __syncthreads();    // phase: owner step
    for (int j = tid; j < n_items; j += THREADS) {   // peers in turn from rank + 1
      if (j < nh) {
        const int3 h = head_entry(e_lo + j);
        const float p = S.P[h.x], ps = S.P[h.y];
        for (int c = 1; c < CLUSTER; ++c) {
          float* dst = cluster.map_shared_rank(S.P, (rank + c) % CLUSTER);
          dst[h.x] = p;
          dst[h.y] = ps;
        }
      } else {
        const int i = tr + 4 * (j - nh);
        const float4 row = *reinterpret_cast<const float4*>(S.P + i);
        for (int c = 1; c < CLUSTER; ++c)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(S.P, (rank + c) % CLUSTER) + i) = row;
      }
    }
    __syncthreads();    // phase: push

    // ---- loss; exact refresh of this CTA's touched chunks ---------------
    if (rank == 0 && tid == 0) {
      float l = 0.f;
      for (int c = 0; c < CLUSTER; ++c) l += cluster.map_shared_rank(S.pub, c)[1];
      losses[k] = l * hp.inv_bs;
    }
    for (int g = warp; g < bs; g += WARPS) {
      const int c = S.all_idx[g] / CH;
      if (c < c_lo || c >= c_lo + ns) continue;
      bool later = false;
      for (int j = g + 1 + lane; j < bs; j += 32) later |= S.all_idx[j] / CH == c;
      if (__any_sync(0xffffffffu, later)) continue;
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p_alpha + (size_t)c * CH) + lane);
      double acc = ((double)q.x + (double)q.y) + ((double)q.z + (double)q.w);
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {   // exact, as in the CDF
        chunk_sums[c] = (float)acc;
        S.cs[c - c_lo] = (float)acc;
      }
    }
    __syncthreads();    // S.cs before the next scan
  }
  cluster.sync();   // phase: end (no CTA leaves while another reads it)
  // the last update's target step; each CTA writes an eighth of the
  // parameters and target, and its slice's moments
  const int w0 = rank * (NP / CLUSTER), w1 = w0 + NP / CLUSTER;
  if (K > 0) target_step(K - 1, w0, w1);   // the same thread writes it out
  for (int i = w0 + tid; i < w1; i += THREADS) {
    params[i] = S.P[i];
    target[i] = S.T[i];
  }
  for (int j = tid; j < n_items; j += THREADS) {
    if (j < nh) {
      const int3 h = head_entry(e_lo + j);
      m[h.x] = S.M[h.x]; v[h.x] = S.V[h.x];
      m[h.y] = S.M[h.y]; v[h.y] = S.V[h.y];
    } else {
      for (int i = tr + 4 * (j - nh), u = 0; u < 4; ++u) {
        m[i + u] = S.M[i + u];
        v[i + u] = S.V[i + u];
      }
    }
  }
}

}  // namespace

extern "C" {

// Run K fused updates on `stream` as one cluster of 8 CTAs. Shapes
// (checked by the Python wrapper): u01 (K, bs), noise (K, 260), p_alpha
// (nc*128), chunk_sums (nc), params/target/m/v/grad (5192), data (nc, 16,
// 128), newp/idx (K, bs), losses (K). bs % 32 == 0, bs <= 512, nc % 128 == 0,
// nc <= 8192. Returns the cudaError_t (a refused cluster launch included).
int dqn_update_launch(int ts0, int count0, int frame0, int size, int K,
                      int bs, int nc, const Hyper* hp, const float* u01,
                      const float* noise, float* p_alpha, float* chunk_sums,
                      float* params, float* target, float* m, float* v,
                      const float* data, float* newp, int* idx,
                      float* losses, float* grad, cudaStream_t stream) {
  (void)grad;
  if (bs % (4 * CLUSTER) != 0 || nc % (16 * CLUSTER) != 0 || nc > MAX_NC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Smem(nullptr, bs / CLUSTER, bs, nc).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      dqn_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dqn_update_kernel, ts0, count0, frame0,
                           size, K, bs, nc, *hp, u01, noise, p_alpha,
                           chunk_sums, params, target, m, v, data, newp, idx,
                           losses);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
