// Fused DRQN update block: K sequential DRQN updates in one launch.
//
// Replaces the TPU kernel pingpong_tpu/ops/drqn_update.py::
// pallas_drqn_update_block (body _update_kernel). Each update k: the online
// forward over obs || next_obs (2*bs sequences of T steps, activations
// stored for BPTT) with this update's noisy heads mu + sigma * eps, the
// target's Q(s') (mu only) from a cache that one wide pass over all K*bs
// next sequences fills at k = 0, refreshed per update after a mid-block
// hard sync ((ts0 % interval) + k >= interval) and under Polyak averaging
// recomputed every update, the Double-DQN TD error on the last step
// (argmax ties to the lowest index), the masked Huber loss with
// denominator max(sum valid, 1), the hand-derived backward with LSTM BPTT
// (b_ih and b_hh get the same gradient; sigma gradients are mu gradients
// times the noise), clip_by_global_norm over every gradient entry, Adam
// (b1 0.9, b2 0.999, eps 1e-8, bias correction at count0 + k + 1) and the
// hard sync at (ts0 + k + 1) % interval == 0 or the Polyak step.
//
// IN PLACE: params, target, m and v (flat vectors in the JAX ravel_pytree
// order of QNetRNNParams) are updated in place; losses is an output and
// scratch is the wrapper's workspace (drqn_update_scratch_floats).
//
// What bounds it on an H100: the serial chain, not bytes or operations.
// The block is about 0.9 GFLOP an update (the 2 x 134 MFLOP input and
// recurrent gate products of the forward, twice that backward) and the
// k = 0 target pass, a few MB of parameters and activations; but update
// k+1 steps from the parameters update k wrote, and each update is a chain
// of T forward and T backward LSTM steps. The online, target and moment
// sets (about 2.8 MB) and the stored activations (about 3.7 MB) do not fit
// one block's shared memory as kernel 2's state did, so the block is ONE
// persistent cooperative launch (cudaLaunchCooperativeKernel, one block of
// 256 threads per SM) with a grid-wide barrier between phases. Parameters,
// moments and activations stay in global memory (L2-resident); every
// product runs in the kernel's own body, split over blocks by 32 x 32
// output tiles (shared-memory staging, sequential sums over the inner
// dimension, no tensor cores, no TF32); the LSTM gate products order their
// rows so that one thread holds a hidden unit's four gates and applies the
// cell in the product's epilogue, and each BPTT product applies the next
// step's elementwise backward in its epilogue, so a time step costs one
// barrier. The global norm is reduced from per-block partial sums in a
// fixed order, and nothing uses float atomics: a run is reproducible bit
// for bit. The backward runs over the obs half only: the next half's
// gradient is exactly zero (the Double-DQN argmax is an integer and the
// target is constant), as in the TPU kernel where those lanes carry zeros.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Hyper-parameters, each rounded to float32 once on the host
// (ops/drqn_update.py::Hyper builds the same struct).
struct Hyper {
  float lr, clip, gamma, tau, b1, b2, one_m_b1, one_m_b2, eps, log_b1, log_b2;
  int interval, ts0, count0;
};

namespace {

constexpr int THREADS = 256;
constexpr int TM = 32, TN = 32, TK = 32;   // product tile; 4 rows a thread

struct Dims {
  int F1, F, H, HH, K, bs, T;
};

// flat parameter vector, ravel_pytree order of the JAX QNetRNNParams
struct POff {
  size_t w1, b1, w2, b2, wih, whh, bih, bhh, ws, wss, bs, bss, wv, wvs, bv,
      bvs, wa, was, ba, bas, n;
  __host__ __device__ explicit POff(const Dims& d) {
    const size_t G = 4 * (size_t)d.H;
    w1 = 0; b1 = w1 + 7 * (size_t)d.F1; w2 = b1 + d.F1;
    b2 = w2 + (size_t)d.F1 * d.F; wih = b2 + d.F; whh = wih + d.F * G;
    bih = whh + d.H * G; bhh = bih + G; ws = bhh + G;
    wss = ws + (size_t)d.H * d.HH; bs = wss + (size_t)d.H * d.HH;
    bss = bs + d.HH; wv = bss + d.HH; wvs = wv + d.HH; bv = wvs + d.HH;
    bvs = bv + 1; wa = bvs + 1; was = wa + 3 * (size_t)d.HH;
    ba = was + 3 * (size_t)d.HH; bas = ba + 3; n = bas + 3;
  }
};

// per-update noise (and effective noisy heads): shared eps_w (H, HH),
// eps_b (HH), V eps_w (HH), eps_b (1), A eps_w (HH, 3), eps_b (3)
struct NOff {
  size_t sw, sb, vw, vb, aw, ab, n;
  __host__ __device__ explicit NOff(const Dims& d) {
    sw = 0; sb = (size_t)d.H * d.HH; vw = sb + d.HH; vb = vw + d.HH;
    aw = vb + 1; ab = aw + 3 * (size_t)d.HH; n = ab + 3;
  }
};

// workspace layout (floats)
struct Scratch {
  size_t f1, f2, xp, act, hs, cs, spre, s, q, eff, dv, da, dspre, dc, dg,
      dz2, dz1, grad, part, qt, tf1, tf2, txp, th, tc, ts, n;
  __host__ __device__ Scratch(const Dims& d, int grid) {
    const size_t B2 = 2 * (size_t)d.bs, N = d.T * B2, NB = (size_t)d.T * d.bs;
    const size_t KB = (size_t)d.K * d.bs, G = 4 * (size_t)d.H;
    size_t o = 0;
    f1 = o; o += d.F1 * N;
    f2 = o; o += d.F * N;
    xp = o; o += G * N;
    act = o; o += G * N;
    hs = o; o += (d.T + 1) * d.H * B2;
    cs = o; o += (d.T + 1) * d.H * B2;
    spre = o; o += d.HH * B2;
    s = o; o += d.HH * B2;
    q = o; o += 3 * B2;
    eff = o; o += NOff(d).n;
    dv = o; o += d.bs;
    da = o; o += 3 * (size_t)d.bs;
    dspre = o; o += (size_t)d.HH * d.bs;
    dc = o; o += (size_t)d.H * d.bs;
    dg = o; o += G * NB;
    dz2 = o; o += d.F * NB;
    dz1 = o; o += d.F1 * NB;
    grad = o; o += POff(d).n;
    part = o; o += grid;
    qt = o; o += 3 * KB;
    tf1 = o; o += d.F1 * d.T * KB;
    tf2 = o; o += d.F * d.T * KB;
    txp = o; o += G * d.T * KB;
    th = o; o += 2 * d.H * KB;
    tc = o; o += d.H * KB;
    ts = o; o += d.HH * KB;
    n = o;
  }
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// C (M x N) = A (M x Kd) . B (Kd x N), split over the grid by TM x TN
// tiles. A(m, k) and B(k, n) are loaders; ep(m, n, acc) receives four
// consecutive rows m..m+3 of column n (rows at or beyond M hold zeros; the
// epilogue checks its bounds). Each output is a sequential fmaf sum over
// k = 0..Kd-1. `sh` holds (TM + TN) * TK floats.
template <class FA, class FB, class EP>
__device__ void gemm(int M, int N, int Kd, FA A, FB B, EP ep, float* sh) {
  float* As = sh;
  float* Bs = sh + TK * TM;
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  for (int tile = blockIdx.x; tile < tiles_m * tiles_n; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * TM, n0 = (tile % tiles_n) * TN;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < Kd; k0 += TK) {
      __syncthreads();
      for (int l = threadIdx.x; l < TK * TM; l += THREADS) {
        const int kk = l / TM, mm = l % TM, m = m0 + mm, k = k0 + kk;
        As[l] = (m < M && k < Kd) ? A(m, k) : 0.f;
      }
      for (int l = threadIdx.x; l < TK * TN; l += THREADS) {
        const int kk = l / TN, nn = l % TN, n = n0 + nn, k = k0 + kk;
        Bs[l] = (n < N && k < Kd) ? B(k, n) : 0.f;
      }
      __syncthreads();
      const int kmax = min(TK, Kd - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float b = Bs[kk * TN + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(As[kk * TM + ty * 4 + i], b, acc[i]);
      }
    }
    if (n0 + tx < N) ep(m0 + ty * 4, n0 + tx, acc);
  }
  __syncthreads();
}

// block-wide sum in a fixed order (tree over THREADS values)
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Target Q (mu weights) of nc sequences of T steps into qt rows
// [(kq * 3 + a) * bs + b]: column col is entry (col / bs + k_base, col %
// bs). x(i, t, col) loads input i of step t.
template <class FX>
__device__ void target_q(const Dims& d, const float* __restrict__ Pt,
                         float* W, const Scratch& S, int nc, int k_base,
                         FX x, float* sh, cg::grid_group& grid) {
  const POff P(d);
  const int H = d.H, G4 = 4 * H, NT = d.T * nc, HH = d.HH;
  float* tf1 = W + S.tf1;
  float* tf2 = W + S.tf2;
  float* txp = W + S.txp;
  float* tc = W + S.tc;
  float* ts = W + S.ts;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int gthreads = gridDim.x * THREADS;
  gemm(d.F1, NT, 7,
       [&](int m, int k) { return Pt[P.w1 + (size_t)k * d.F1 + m]; },
       [&](int k, int n) { return x(k, n / nc, n % nc); },
       [&](int m, int n, const float* acc) {
         for (int i = 0; i < 4 && m + i < d.F1; ++i)
           tf1[(size_t)(m + i) * NT + n] = fmaxf(acc[i] + Pt[P.b1 + m + i], 0.f);
       }, sh);
  for (int i = gtid; i < H * nc; i += gthreads) {
    W[S.th + i] = 0.f;
    tc[i] = 0.f;
  }
  grid.sync();
  gemm(d.F, NT, d.F1,
       [&](int m, int k) { return Pt[P.w2 + (size_t)k * d.F + m]; },
       [&](int k, int n) { return tf1[(size_t)k * NT + n]; },
       [&](int m, int n, const float* acc) {
         for (int i = 0; i < 4 && m + i < d.F; ++i)
           tf2[(size_t)(m + i) * NT + n] = fmaxf(acc[i] + Pt[P.b2 + m + i], 0.f);
       }, sh);
  grid.sync();
  gemm(G4, NT, d.F,
       [&](int m, int k) { return Pt[P.wih + (size_t)k * G4 + m]; },
       [&](int k, int n) { return tf2[(size_t)k * NT + n]; },
       [&](int m, int n, const float* acc) {
         for (int i = 0; i < 4 && m + i < G4; ++i)
           txp[(size_t)(m + i) * NT + n] =
               (acc[i] + Pt[P.bih + m + i]) + Pt[P.bhh + m + i];
       }, sh);
  grid.sync();
  for (int t = 0; t < d.T; ++t) {
    const float* hin = W + S.th + (size_t)(t % 2) * H * nc;
    float* hout = W + S.th + (size_t)((t + 1) % 2) * H * nc;
    // rows ordered 4 j + gate: a thread holds unit j's four gates
    gemm(G4, nc, H,
         [&](int m, int k) { return Pt[P.whh + (size_t)k * G4 + (m % 4) * H + m / 4]; },
         [&](int k, int n) { return hin[(size_t)k * nc + n]; },
         [&](int m, int n, const float* acc) {
           const int j = m / 4;
           if (j >= H) return;
           float g[4];
           for (int a = 0; a < 4; ++a)
             g[a] = txp[(size_t)(a * H + j) * NT + (size_t)t * nc + n] + acc[a];
           const float cn = sigmoid(g[1]) * tc[(size_t)j * nc + n] +
                            sigmoid(g[0]) * tanhf(g[2]);
           tc[(size_t)j * nc + n] = cn;
           hout[(size_t)j * nc + n] = sigmoid(g[3]) * tanhf(cn);
         }, sh);
    grid.sync();
  }
  const float* hT = W + S.th + (size_t)(d.T % 2) * H * nc;
  gemm(HH, nc, H,
       [&](int m, int k) { return Pt[P.ws + (size_t)k * HH + m]; },
       [&](int k, int n) { return hT[(size_t)k * nc + n]; },
       [&](int m, int n, const float* acc) {
         for (int i = 0; i < 4 && m + i < HH; ++i)
           ts[(size_t)(m + i) * nc + n] = fmaxf(acc[i] + Pt[P.bs + m + i], 0.f);
       }, sh);
  grid.sync();
  for (int col = gtid; col < nc; col += gthreads) {
    float v = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < HH; ++j) {
      const float sv = ts[(size_t)j * nc + col];
      v = fmaf(Pt[P.wv + j], sv, v);
      a0 = fmaf(Pt[P.wa + 3 * j + 0], sv, a0);
      a1 = fmaf(Pt[P.wa + 3 * j + 1], sv, a1);
      a2 = fmaf(Pt[P.wa + 3 * j + 2], sv, a2);
    }
    v += Pt[P.bv];
    a0 += Pt[P.ba]; a1 += Pt[P.ba + 1]; a2 += Pt[P.ba + 2];
    const float mean = (a0 + a1 + a2) / 3.0f;
    const int kq = k_base + col / d.bs, b = col % d.bs;
    float* q = W + S.qt + (size_t)kq * 3 * d.bs + b;
    q[0] = (v + a0) - mean;
    q[d.bs] = (v + a1) - mean;
    q[2 * d.bs] = (v + a2) - mean;
  }
  grid.sync();
}

__global__ void __launch_bounds__(THREADS)
drqn_update_kernel(Dims d, Hyper hp, const float* __restrict__ xt,
                   const float* __restrict__ nextt,
                   const float* __restrict__ meta,
                   const float* __restrict__ noise, float* params,
                   float* target, float* m_, float* v_,
                   float* __restrict__ losses, float* W) {
  __shared__ float sh[(TM + TN) * TK];
  __shared__ float red[THREADS];
  cg::grid_group grid = cg::this_grid();
  const POff P(d);
  const NOff NO(d);
  const Scratch S(d, gridDim.x);
  const int H = d.H, G4 = 4 * H, HH = d.HH, bs = d.bs, B2 = 2 * bs;
  const int N = d.T * B2, NB = d.T * bs, KB = d.K * bs;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int gthreads = gridDim.x * THREADS;
  float *f1 = W + S.f1, *f2 = W + S.f2, *xp = W + S.xp, *act = W + S.act;
  float *hs = W + S.hs, *cs = W + S.cs, *spre = W + S.spre, *s = W + S.s;
  float *eff = W + S.eff, *dv = W + S.dv, *da = W + S.da;
  float *dspre = W + S.dspre, *dc = W + S.dc, *dg = W + S.dg;
  float *dz2 = W + S.dz2, *dz1 = W + S.dz1, *grad = W + S.grad;
  float* qt = W + S.qt;
  // column n of the obs half (t = n / bs, b = n % bs) in the obs||next layout
  auto obs_col = [=](int n) { return (n / bs) * B2 + n % bs; };

  for (int k = 0; k < d.K; ++k) {
    const float* x = xt + (size_t)k * 7 * N;
    const float* nz = noise + (size_t)k * NO.n;
    // ---- target Q(s'): the wide pass at k = 0, or this update's entry
    if (hp.tau > 0.f || (hp.ts0 % hp.interval) + k >= hp.interval) {
      target_q(d, target, W, S, bs, k,
               [=](int i, int t, int col) { return x[(size_t)i * N + t * B2 + bs + col]; },
               sh, grid);
    } else if (k == 0) {
      target_q(d, target, W, S, KB, 0,
               [=](int i, int t, int col) { return nextt[((size_t)t * 7 + i) * KB + col]; },
               sh, grid);
    }

    // ---- online forward over obs || next, activations stored ----------
    gemm(d.F1, N, 7,
         [&](int m, int kk) { return params[P.w1 + (size_t)kk * d.F1 + m]; },
         [&](int kk, int n) { return x[(size_t)kk * N + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < d.F1; ++i)
             f1[(size_t)(m + i) * N + n] = fmaxf(acc[i] + params[P.b1 + m + i], 0.f);
         }, sh);
    for (int i = gtid; i < H * B2; i += gthreads) { hs[i] = 0.f; cs[i] = 0.f; }
    for (int i = gtid; i < (int)NO.n; i += gthreads) {  // noisy heads
      const size_t mu = i < (int)NO.sb ? P.ws + i
                      : i < (int)NO.vw ? P.bs + (i - NO.sb)
                      : i < (int)NO.vb ? P.wv + (i - NO.vw)
                      : i < (int)NO.aw ? P.bv
                      : i < (int)NO.ab ? P.wa + (i - NO.aw)
                      : P.ba + (i - NO.ab);
      const size_t sg = i < (int)NO.sb ? P.wss + i
                      : i < (int)NO.vw ? P.bss + (i - NO.sb)
                      : i < (int)NO.vb ? P.wvs + (i - NO.vw)
                      : i < (int)NO.aw ? P.bvs
                      : i < (int)NO.ab ? P.was + (i - NO.aw)
                      : P.bas + (i - NO.ab);
      eff[i] = params[mu] + params[sg] * nz[i];
    }
    grid.sync();
    gemm(d.F, N, d.F1,
         [&](int m, int kk) { return params[P.w2 + (size_t)kk * d.F + m]; },
         [&](int kk, int n) { return f1[(size_t)kk * N + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < d.F; ++i)
             f2[(size_t)(m + i) * N + n] = fmaxf(acc[i] + params[P.b2 + m + i], 0.f);
         }, sh);
    grid.sync();
    gemm(G4, N, d.F,
         [&](int m, int kk) { return params[P.wih + (size_t)kk * G4 + m]; },
         [&](int kk, int n) { return f2[(size_t)kk * N + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < G4; ++i)
             xp[(size_t)(m + i) * N + n] =
                 (acc[i] + params[P.bih + m + i]) + params[P.bhh + m + i];
         }, sh);
    grid.sync();
    for (int t = 0; t < d.T; ++t) {
      const float* hin = hs + (size_t)t * H * B2;
      const float* cin = cs + (size_t)t * H * B2;
      float* hout = hs + (size_t)(t + 1) * H * B2;
      float* cout = cs + (size_t)(t + 1) * H * B2;
      gemm(G4, B2, H,
           [&](int m, int kk) { return params[P.whh + (size_t)kk * G4 + (m % 4) * H + m / 4]; },
           [&](int kk, int n) { return hin[(size_t)kk * B2 + n]; },
           [&](int m, int n, const float* acc) {
             const int j = m / 4;
             if (j >= H) return;
             const size_t col = (size_t)t * B2 + n;
             float g[4];
             for (int a = 0; a < 4; ++a) g[a] = xp[(size_t)(a * H + j) * N + col] + acc[a];
             const float gi = sigmoid(g[0]), gf = sigmoid(g[1]);
             const float gg = tanhf(g[2]), go = sigmoid(g[3]);
             const float cn = gf * cin[(size_t)j * B2 + n] + gi * gg;
             cout[(size_t)j * B2 + n] = cn;
             hout[(size_t)j * B2 + n] = go * tanhf(cn);
             act[(size_t)j * N + col] = gi;
             act[(size_t)(H + j) * N + col] = gf;
             act[(size_t)(2 * H + j) * N + col] = gg;
             act[(size_t)(3 * H + j) * N + col] = go;
           }, sh);
      grid.sync();
    }
    const float* hT = hs + (size_t)d.T * H * B2;
    gemm(HH, B2, H,
         [&](int m, int kk) { return eff[NO.sw + (size_t)kk * HH + m]; },
         [&](int kk, int n) { return hT[(size_t)kk * B2 + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < HH; ++i) {
             const float sp = acc[i] + eff[NO.sb + m + i];
             spre[(size_t)(m + i) * B2 + n] = sp;
             s[(size_t)(m + i) * B2 + n] = fmaxf(sp, 0.f);
           }
         }, sh);
    grid.sync();

    // ---- Q, Double-DQN TD, masked Huber (block 0) -----------------------
    if (blockIdx.x == 0) {
      float* q = W + S.q;
      for (int col = threadIdx.x; col < B2; col += THREADS) {
        float v = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
        for (int j = 0; j < HH; ++j) {
          const float sv = s[(size_t)j * B2 + col];
          v = fmaf(eff[NO.vw + j], sv, v);
          a0 = fmaf(eff[NO.aw + 3 * j + 0], sv, a0);
          a1 = fmaf(eff[NO.aw + 3 * j + 1], sv, a1);
          a2 = fmaf(eff[NO.aw + 3 * j + 2], sv, a2);
        }
        v += eff[NO.vb];
        a0 += eff[NO.ab]; a1 += eff[NO.ab + 1]; a2 += eff[NO.ab + 2];
        const float mean = (a0 + a1 + a2) / 3.0f;
        q[col] = (v + a0) - mean;
        q[B2 + col] = (v + a1) - mean;
        q[2 * B2 + col] = (v + a2) - mean;
      }
      __syncthreads();
      const float* mk = meta + (size_t)k * 4 * bs;   // act, rew, done, valid
      float wsum = 0.f, hsum = 0.f;
      if (threadIdx.x == 0) {
        for (int b = 0; b < bs; ++b) wsum += mk[3 * bs + b];
        red[0] = fmaxf(wsum, 1.0f);
      }
      __syncthreads();
      const float denom = red[0];
      __syncthreads();
      for (int b = threadIdx.x; b < bs; b += THREADS) {
        const float n0 = q[bs + b], n1 = q[B2 + bs + b], n2 = q[2 * B2 + bs + b];
        const int na0 = n1 > n0 ? 1 : 0;
        const int na = n2 > fmaxf(n0, n1) ? 2 : na0;
        const float nq = qt[((size_t)k * 3 + na) * bs + b];
        const int a = (int)mk[b];
        const float qa = q[a * B2 + b];
        const float y = mk[bs + b] + hp.gamma * nq * (1.0f - mk[2 * bs + b]);
        const float td = qa - y;
        const float at = fabsf(td);
        const float hub = at <= 1.0f ? 0.5f * td * td : at - 0.5f;
        const float wm = mk[3 * bs + b];
        dspre[b] = wm * hub;   // staged for the loss sum below
        const float dq = wm * fminf(fmaxf(td, -1.0f), 1.0f) / denom;
        dv[b] = dq;
        for (int x3 = 0; x3 < 3; ++x3) da[x3 * bs + b] = (x3 == a ? dq : 0.f) - dq / 3.0f;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int b = 0; b < bs; ++b) hsum += dspre[b];
        losses[k] = hsum / denom;
      }
    }
    grid.sync();

    // ---- backward: heads ------------------------------------------------
    for (int o = gtid; o < 4 * HH + 4 + HH * bs; o += gthreads) {
      if (o < HH) {                                  // V head weight
        float g = 0.f;
        for (int b = 0; b < bs; ++b) g = fmaf(dv[b], s[(size_t)o * B2 + b], g);
        grad[P.wv + o] = g;
        grad[P.wvs + o] = g * nz[NO.vw + o];
      } else if (o < 4 * HH) {                       // A head weight (j, a)
        const int j = (o - HH) / 3, a = (o - HH) % 3;
        float g = 0.f;
        for (int b = 0; b < bs; ++b) g = fmaf(da[a * bs + b], s[(size_t)j * B2 + b], g);
        grad[P.wa + o - HH] = g;
        grad[P.was + o - HH] = g * nz[NO.aw + o - HH];
      } else if (o == 4 * HH) {                      // V bias
        float g = 0.f;
        for (int b = 0; b < bs; ++b) g += dv[b];
        grad[P.bv] = g;
        grad[P.bvs] = g * nz[NO.vb];
      } else if (o < 4 * HH + 4) {                   // A bias
        const int a = o - 4 * HH - 1;
        float g = 0.f;
        for (int b = 0; b < bs; ++b) g += da[a * bs + b];
        grad[P.ba + a] = g;
        grad[P.bas + a] = g * nz[NO.ab + a];
      } else {                                       // dL/ds_pre (j, b)
        const int r = o - 4 * HH - 4, j = r / bs, b = r % bs;
        const float ds = eff[NO.vw + j] * dv[b] +
                         (eff[NO.aw + 3 * j] * da[b] + eff[NO.aw + 3 * j + 1] * da[bs + b] +
                          eff[NO.aw + 3 * j + 2] * da[2 * bs + b]);
        dspre[(size_t)j * bs + b] = spre[(size_t)j * B2 + b] > 0.f ? ds : 0.f;
      }
    }
    grid.sync();

    // the elementwise BPTT step t at (j, b) from dL/dh (first: dc = 0)
    auto bptt = [&](int t, int j, int b, float dh, bool first) {
      const size_t col = (size_t)t * B2 + b;
      const float gi = act[(size_t)j * N + col], gf = act[(size_t)(H + j) * N + col];
      const float gg = act[(size_t)(2 * H + j) * N + col];
      const float go = act[(size_t)(3 * H + j) * N + col];
      const float cprev = cs[(size_t)t * H * B2 + (size_t)j * B2 + b];
      const float tc = tanhf(cs[(size_t)(t + 1) * H * B2 + (size_t)j * B2 + b]);
      const float dout = dh * tc;
      float dcv = first ? 0.f : dc[(size_t)j * bs + b];
      dcv = dcv + dh * go * (1.0f - tc * tc);
      const size_t c2 = (size_t)t * bs + b;
      dg[(size_t)j * NB + c2] = dcv * gg * gi * (1.0f - gi);
      dg[(size_t)(H + j) * NB + c2] = dcv * cprev * gf * (1.0f - gf);
      dg[(size_t)(2 * H + j) * NB + c2] = dcv * gi * (1.0f - gg * gg);
      dg[(size_t)(3 * H + j) * NB + c2] = dout * go * (1.0f - go);
      dc[(size_t)j * bs + b] = dcv * gf;
    };
    gemm(H, HH, bs,     // shared head weight: h_T (obs half) x dL/ds_pre
         [&](int i, int b) { return hT[(size_t)i * B2 + b]; },
         [&](int b, int j) { return dspre[(size_t)j * bs + b]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < H; ++i) {
             const size_t o = (size_t)(m + i) * HH + n;
             grad[P.ws + o] = acc[i];
             grad[P.wss + o] = acc[i] * nz[NO.sw + o];
           }
         }, sh);
    gemm(H, bs, HH,     // dL/dh_T, then step T-1 of BPTT
         [&](int i, int j) { return eff[NO.sw + (size_t)i * HH + j]; },
         [&](int j, int b) { return dspre[(size_t)j * bs + b]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < H; ++i) bptt(d.T - 1, m + i, n, acc[i], true);
         }, sh);
    for (int j = gtid; j < HH; j += gthreads) {
      float g = 0.f;
      for (int b = 0; b < bs; ++b) g += dspre[(size_t)j * bs + b];
      grad[P.bs + j] = g;
      grad[P.bss + j] = g * nz[NO.sb + j];
    }
    grid.sync();
    for (int t = d.T - 1; t > 0; --t) {   // dL/dh_{t-1} = W_hh dg_t
      gemm(H, bs, G4,
           [&](int i, int r) { return params[P.whh + (size_t)i * G4 + r]; },
           [&](int r, int b) { return dg[(size_t)r * NB + (size_t)t * bs + b]; },
           [&](int m, int n, const float* acc) {
             for (int i = 0; i < 4 && m + i < H; ++i) bptt(t - 1, m + i, n, acc[i], false);
           }, sh);
      grid.sync();
    }

    // ---- backward: LSTM weights, input projection, features -------------
    gemm(H, G4, NB,
         [&](int i, int n) { return hs[(size_t)(n / bs) * H * B2 + (size_t)i * B2 + n % bs]; },
         [&](int n, int r) { return dg[(size_t)r * NB + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < H; ++i) grad[P.whh + (size_t)(m + i) * G4 + n] = acc[i];
         }, sh);
    gemm(d.F, G4, NB,
         [&](int kk, int n) { return f2[(size_t)kk * N + obs_col(n)]; },
         [&](int n, int r) { return dg[(size_t)r * NB + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < d.F; ++i) grad[P.wih + (size_t)(m + i) * G4 + n] = acc[i];
         }, sh);
    gemm(d.F, NB, G4,
         [&](int kk, int r) { return params[P.wih + (size_t)kk * G4 + r]; },
         [&](int r, int n) { return dg[(size_t)r * NB + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < d.F; ++i) {
             const size_t o = (size_t)(m + i) * NB + n;
             dz2[o] = f2[(size_t)(m + i) * N + obs_col(n)] > 0.f ? acc[i] : 0.f;
           }
         }, sh);
    for (int r = gtid; r < G4; r += gthreads) {
      float g = 0.f;
      for (int n = 0; n < NB; ++n) g += dg[(size_t)r * NB + n];
      grad[P.bih + r] = g;
      grad[P.bhh + r] = g;
    }
    grid.sync();
    gemm(d.F1, d.F, NB,
         [&](int i, int n) { return f1[(size_t)i * N + obs_col(n)]; },
         [&](int n, int kk) { return dz2[(size_t)kk * NB + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < d.F1; ++i) grad[P.w2 + (size_t)(m + i) * d.F + n] = acc[i];
         }, sh);
    gemm(d.F1, NB, d.F,
         [&](int i, int kk) { return params[P.w2 + (size_t)i * d.F + kk]; },
         [&](int kk, int n) { return dz2[(size_t)kk * NB + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < d.F1; ++i) {
             const size_t o = (size_t)(m + i) * NB + n;
             dz1[o] = f1[(size_t)(m + i) * N + obs_col(n)] > 0.f ? acc[i] : 0.f;
           }
         }, sh);
    for (int kk = gtid; kk < d.F; kk += gthreads) {
      float g = 0.f;
      for (int n = 0; n < NB; ++n) g += dz2[(size_t)kk * NB + n];
      grad[P.b2 + kk] = g;
    }
    grid.sync();
    gemm(7, d.F1, NB,
         [&](int i, int n) { return x[(size_t)i * N + obs_col(n)]; },
         [&](int n, int j) { return dz1[(size_t)j * NB + n]; },
         [&](int m, int n, const float* acc) {
           for (int i = 0; i < 4 && m + i < 7; ++i) grad[P.w1 + (size_t)(m + i) * d.F1 + n] = acc[i];
         }, sh);
    for (int j = gtid; j < d.F1; j += gthreads) {
      float g = 0.f;
      for (int n = 0; n < NB; ++n) g += dz1[(size_t)j * NB + n];
      grad[P.b1 + j] = g;
    }
    grid.sync();

    // ---- clip_by_global_norm: per-block partials, fixed order ------------
    {
      const size_t per = (P.n + gridDim.x - 1) / gridDim.x;
      const size_t lo = blockIdx.x * per;
      const size_t hi = lo + per < P.n ? lo + per : P.n;
      float acc = 0.f;
      for (size_t i = lo + threadIdx.x; i < hi; i += THREADS) acc = fmaf(grad[i], grad[i], acc);
      const float tot = block_sum(acc, red);
      if (threadIdx.x == 0) W[S.part + blockIdx.x] = tot;
    }
    grid.sync();

    // ---- Adam on the flat vector, target sync ----------------------------
    float gsq = 0.f;
    for (int b = 0; b < (int)gridDim.x; ++b) gsq += W[S.part + b];
    const float scale = hp.clip / fmaxf(sqrtf(gsq), hp.clip);
    const float step = (float)(hp.count0 + k + 1);
    const float bc1 = 1.0f - expf(step * hp.log_b1);
    const float bc2 = 1.0f - expf(step * hp.log_b2);
    const bool sync = ((hp.ts0 + k + 1) % hp.interval) == 0;
    for (size_t i = gtid; i < P.n; i += gthreads) {
      const float g = grad[i] * scale;
      const float mj = m_[i] * hp.b1 + g * hp.one_m_b1;
      const float vj = v_[i] * hp.b2 + g * g * hp.one_m_b2;
      m_[i] = mj;
      v_[i] = vj;
      const float p = params[i] - hp.lr * ((mj / bc1) / (sqrtf(vj / bc2) + hp.eps));
      params[i] = p;
      if (hp.tau > 0.f) target[i] = target[i] + hp.tau * (p - target[i]);
      else if (sync) target[i] = p;
    }
    grid.sync();
  }
}

int grid_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, drqn_update_kernel,
                                                THREADS, 0);
  return per_sm > 0 ? sms : 0;   // one block per SM: cheap grid barriers
}

}  // namespace

extern "C" {

// Floats of the workspace the wrapper allocates for these shapes.
long long drqn_update_scratch_floats(int F1, int F, int H, int HH, int K,
                                     int bs, int T) {
  const Dims d{F1, F, H, HH, K, bs, T};
  return (long long)Scratch(d, grid_blocks()).n;
}

// Run K fused updates on `stream` as one cooperative launch. Shapes
// (checked by the Python wrapper): xt (K, 7, T*2*bs) obs||next with
// T-major columns, nextt (T, 7, K*bs), meta (K, 4, bs) rows act, reward,
// done, valid; noise (K, NN); params/target/m/v (P,); losses (K,). Returns
// the cudaError_t (cudaErrorCooperativeLaunchTooLarge and the like when
// the cooperative launch is refused).
int drqn_update_launch(int F1, int F, int H, int HH, int K, int bs, int T,
                       const Hyper* hp, const float* xt, const float* nextt,
                       const float* meta, const float* noise, float* params,
                       float* target, float* m, float* v, float* losses,
                       float* scratch, cudaStream_t stream) {
  Dims d{F1, F, H, HH, K, bs, T};
  Hyper h = *hp;
  const int grid = grid_blocks();
  if (grid == 0) return (int)cudaErrorLaunchOutOfResources;
  void* args[] = {&d, &h, &xt, &nextt, &meta, &noise, &params, &target, &m,
                  &v, &losses, &scratch};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)drqn_update_kernel, dim3(grid), dim3(THREADS), args, 0,
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
