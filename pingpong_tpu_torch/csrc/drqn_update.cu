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
// What bounds it on an H100: the serial chain and the grid barriers, not
// bytes or operations. An update is about 0.45 GFMA (the gate products of
// the forward over 2*bs sequences and the backward over bs), about 7 us of
// the card's f32 peak, but update k+1 steps from the parameters update k
// wrote, each update is a chain of T forward and T backward LSTM steps,
// and the online, target and moment sets (about 2.8 MB) and the stored
// activations do not fit one SM. So the block is ONE persistent
// cooperative launch (one block of 256 threads per SM) with a grid barrier
// between dependent phases, 2T + 10 an update (26 at T = 8), and the
// design keeps each phase's critical path short:
// - Every product runs in one tiled routine: 64 x 64 output tiles, a 4 x 4
//   register tile a thread from float4 shared loads (0.125 shared loads an
//   FMA), 32-deep k-tiles double-buffered with cp.async, operands addressed
//   by stride descriptors (no loader lambdas). The products of one phase
//   share one index space of (product, tile, k-slice) work items, and the
//   backward's products with an inner dimension of T*bs or 4H are split
//   over k so that all blocks take part; the partials go to the workspace
//   and the next phase sums them in k-slice order before the epilogue, with
//   the bias row sums (one warp a row, a fixed lane order) beside them.
// - The recurrent chain is owned by hidden unit: block j keeps the four
//   gate columns of W_hh for unit j (4 x H floats) in shared memory for
//   the whole update. A forward step reads only h_t (float4 columns) from
//   L2 and applies the cell to its unit. A BPTT step applies the
//   elementwise backward of its unit and multiplies its four dg rows by
//   the same columns: its share of every unit's dL/dh_{t-1}, which the next
//   step sums over units in unit order (4 MB written and read a step,
//   where reading all of dg_{t+1} in every block moved 16 MB).
// - The shared head, Q and the TD error run one block a sample; the head
//   gradients run beside the first BPTT step, and dW1 one warp an entry.
// - The gradient norm is summed per thread over the entries it writes,
//   then per block and over blocks in block order; nothing uses float
//   atomics, so a run is reproducible bit for bit.
// No tensor cores, no TF32: the losses are held to rtol 1e-4. The backward
// runs over the obs half only: the next half's gradient is exactly zero
// (the Double-DQN argmax is an integer and the target is constant), as in
// the TPU kernel where those lanes carry zeros.

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
constexpr int TM = 64, TN = 64, TK = 32;   // product tile; 4 x 4 a thread
constexpr int LPT = TK * TM / THREADS;     // k-tile elements a thread copies
constexpr int LDS = TM + 4;                // shared row stride of a k-tile
constexpr int MAX_H = 128;                 // widths the wrapper admits
constexpr int MAX_PROD = 4;

struct Dims {
  int F1, F, H, HH, K, bs, T;
};

// flat parameter vector, ravel_pytree order of the JAX QNetRNNParams
struct POff {
  size_t w1, b1, w2, b2, wih, whh, bih, bhh, ws, wss, bs, bss, wv, wvs, bv,
      bvs, wa, was, ba, bas, n;
  POff() = default;
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
  NOff() = default;
  __host__ __device__ explicit NOff(const Dims& d) {
    sw = 0; sb = (size_t)d.H * d.HH; vw = sb + d.HH; vb = vw + d.HH;
    aw = vb + 1; ab = aw + 3 * (size_t)d.HH; n = ab + 3;
  }
};

// workspace layout (floats; every region starts on 16 bytes)
struct Scratch {
  size_t f1, f2, xp, act, hs, cs, spre, s, q, eff, dv, da, hub, dspre, dc, bpart,
      dg, dz2, dz1, grad, norm, part, qt, tf1, tf2, txp, th, tc, ts, n;
  Scratch() = default;
  __host__ __device__ Scratch(const Dims& d, int grid) {
    const size_t B2 = 2 * (size_t)d.bs, N = d.T * B2, NB = (size_t)d.T * d.bs;
    const size_t KB = (size_t)d.K * d.bs, G = 4 * (size_t)d.H;
    size_t o = 0;
    auto r4 = [](size_t n) { return (n + 3) & ~(size_t)3; };   // float4 rows
    f1 = o; o += r4(d.F1 * N);
    f2 = o; o += r4(d.F * N);
    xp = o; o += r4(G * N);
    act = o; o += r4(G * N);
    hs = o; o += r4((d.T + 1) * d.H * B2);
    cs = o; o += r4((d.T + 1) * d.H * B2);
    spre = o; o += r4(d.HH * B2);
    s = o; o += r4(d.HH * B2);
    q = o; o += r4(4);                        // the loss denominator
    eff = o; o += r4(NOff(d).n);
    dv = o; o += r4(d.bs);
    da = o; o += r4(3 * (size_t)d.bs);
    hub = o; o += r4(d.bs);
    dspre = o; o += r4((size_t)d.HH * d.bs);
    dc = o; o += r4((size_t)d.H * d.bs);
    bpart = o; o += r4(2 * (size_t)d.H * d.H * d.bs);   // BPTT partials
    dg = o; o += r4(G * NB);
    dz2 = o; o += r4(d.F * NB);
    dz1 = o; o += r4(d.F1 * NB);
    grad = o; o += r4(POff(d).n);
    norm = o; o += r4(grid);
    part = o; o += r4((size_t)grid * TM * TN);  // split-k partials of a phase
    qt = o; o += r4(3 * KB);
    tf1 = o; o += r4(d.F1 * d.T * KB);
    tf2 = o; o += r4(d.F * d.T * KB);
    txp = o; o += r4(G * d.T * KB);
    th = o; o += r4(2 * d.H * KB);
    tc = o; o += r4(d.H * KB);
    ts = o; o += r4(d.HH * KB);
    n = o;
  }
};

// A strided operand: element (r, c) at p[r * rs + (c / cw) * gs + (c % cw)
// * cs]. The column groups address the obs half of the obs || next layout
// (cw = bs, gs = 2 bs) and the T-major next-obs blocks.
struct Mat {
  const float* p;
  int rs, cs, cw, gs;
};

__host__ __device__ inline Mat mat(const float* p, int rs, int cs) {
  return Mat{p, rs, cs, 1 << 30, 0};
}
__host__ __device__ inline Mat gmat(const float* p, int rs, int cw, int gs) {
  return Mat{p, rs, 1, cw, gs};
}

enum Ep { EP_RELU_BIAS, EP_XP, EP_GRAD, EP_GRAD_NOISE, EP_MASK };

// One product C (M x N) = A (M x Kd) B (Kd x N) and its epilogue.
struct Prod {
  Mat A, B, mask;
  int M, N, Kd, ep, ldo, S, tiles_n, items;
  float *out, *out2;
  const float *v1, *v2;
  float* part;   // S > 1: S partial (M, N) sums, k-slice major
};

// One row-sum family: out[r] = sum_c X(r, c), one warp a row.
enum Rs { RS_PLAIN, RS_BIAS2, RS_NOISE };
struct RowSum {
  Mat X;
  int rows, cols, kind;
  float *out, *out2;
  const float* noise;
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Smem {
  union {
    struct {
      float a[2][TK][LDS];   // A k-tiles, m fastest
      float b[2][TK][LDS];   // B k-tiles, n fastest
    } t;
    float4 step[4 * THREADS];  // a recurrent step's split sums
  } u;
  Prod prod[MAX_PROD];
  RowSum rsum[2];
  float4 wcol[MAX_H];      // W_hh gate columns of this block's unit (i, gate)
  float swrow[MAX_H];      // effective shared-head row of this block's unit
  float4 part4[THREADS];   // a BPTT step's split sums
  float red[THREADS];
  POff P;                  // the layouts, set once by thread 0
  NOff NO;
  Scratch S;
};

// The block's shared memory, one instance for the kernel and its helpers.
__shared__ __align__(16) Smem sh;

// Column offset of operand column c (the grouped layout divides).
__device__ __forceinline__ int col_off(const Mat& x, int c) {
  return x.cw < (1 << 30) ? (c / x.cw) * x.gs + (c % x.cw) : c * x.cs;
}
__device__ __forceinline__ const float* at(const Mat& x, int r, int c) {
  return x.p + (size_t)r * x.rs + col_off(x, c);
}

// A thread's LPT elements of each k-tile of one work item: the part of
// each source offset that does not move with k (-1: outside the product).
// Element i sits at tile slot l = threadIdx.x + i * THREADS, the
// operand's contiguous index fastest.
struct Loader {
  Mat A, B;
  int a_fix[LPT], b_fix[LPT];
  bool a_kfast, b_nfast;
  __device__ Loader(const Prod& p, int m0, int n0) : A(p.A), B(p.B) {
    a_kfast = A.cs == 1 && A.rs != 1;
    b_nfast = B.cs == 1 && B.rs != 1;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = threadIdx.x + i * THREADS;
      const int m = m0 + (a_kfast ? l / TK : l % TM);
      a_fix[i] = m < p.M ? m * A.rs : -1;
      const int n = n0 + (b_nfast ? l % TN : l / TK);
      b_fix[i] = n < p.N ? col_off(B, n) : -1;
    }
  }
  // Issue the cp.async copies of the k-tile at k0 (k < kend) into as, bs.
  __device__ void issue(int k0, int kend, float (*as)[LDS], float (*bs)[LDS]) const {
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = threadIdx.x + i * THREADS;
      const int kk = a_kfast ? l % TK : l / TM, mm = a_kfast ? l / TK : l % TM;
      const bool ok = a_fix[i] >= 0 && k0 + kk < kend;
      cp4(&as[kk][mm], ok ? A.p + a_fix[i] + col_off(A, k0 + kk) : A.p, ok);
    }
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int l = threadIdx.x + i * THREADS;
      const int kk = b_nfast ? l / TN : l % TK, nn = b_nfast ? l % TN : l / TK;
      const bool ok = b_fix[i] >= 0 && k0 + kk < kend;
      cp4(&bs[kk][nn], ok ? B.p + (size_t)(k0 + kk) * B.rs + b_fix[i] : B.p, ok);
    }
  }
};

__device__ void epilogue(const Prod& p, int m, int n, float acc, float& gsq) {
  const size_t o = (size_t)m * p.ldo + n;
  switch (p.ep) {
    case EP_RELU_BIAS: p.out[o] = fmaxf(acc + p.v1[m], 0.f); break;
    case EP_XP: p.out[o] = (acc + p.v1[m]) + p.v2[m]; break;
    case EP_GRAD: p.out[o] = acc; gsq = fmaf(acc, acc, gsq); break;
    case EP_GRAD_NOISE: {
      const float g2 = acc * p.v1[o];
      p.out[o] = acc;
      p.out2[o] = g2;
      gsq = fmaf(acc, acc, gsq);
      gsq = fmaf(g2, g2, gsq);
    } break;
    default: p.out[o] = *at(p.mask, m, n) > 0.f ? acc : 0.f; break;
  }
}

// The work items of the phase's np products (sh.prod, set by thread 0):
// choose each product's k-split so that all items fit one round of the
// grid (split only if allow_split), then run this block's items. An item
// with S == 1 applies the epilogue; otherwise it stores its partial sums.
__device__ __noinline__ float run_products(int np, bool allow_split) {
  float gsq = 0.f;   // squares of the gradient entries this thread writes
  if (threadIdx.x == 0) {
    int ks = 1 << 30;   // k-tiles an item; S = 1 everywhere unless split
    if (allow_split) {
      int kmax = 1;
      for (int i = 0; i < np; ++i) kmax = max(kmax, (sh.prod[i].Kd + TK - 1) / TK);
      for (ks = 1; ks < kmax; ++ks) {
        int items = 0;
        for (int i = 0; i < np; ++i) {
          const Prod& p = sh.prod[i];
          const int tiles = ((p.M + TM - 1) / TM) * ((p.N + TN - 1) / TN);
          items += tiles * (((p.Kd + TK - 1) / TK + ks - 1) / ks);
        }
        if (items <= (int)gridDim.x) break;
      }
    }
    size_t off = 0;
    for (int i = 0; i < np; ++i) {
      Prod& p = sh.prod[i];
      const int kt = (p.Kd + TK - 1) / TK, kse = min(ks, kt);
      p.S = (kt + kse - 1) / kse;
      p.tiles_n = (p.N + TN - 1) / TN;
      p.items = ((p.M + TM - 1) / TM) * p.tiles_n * p.S;
      if (p.S > 1) {
        p.part = p.part + off;   // part holds the phase's partial region
        off += (size_t)p.S * p.M * p.N;
      }
    }
  }
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int total = 0;
  for (int i = 0; i < np; ++i) total += sh.prod[i].items;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int pi = 0, r = item;
    while (r >= sh.prod[pi].items) r -= sh.prod[pi++].items;
    const Prod& p = sh.prod[pi];
    const int tile = r / p.S, sl = r % p.S;
    const int m0 = (tile / p.tiles_n) * TM, n0 = (tile % p.tiles_n) * TN;
    const int kt = (p.Kd + TK - 1) / TK, per = (kt + p.S - 1) / p.S;
    const int kb = sl * per * TK, ke = min(p.Kd, (sl + 1) * per * TK);
    float acc[4][4] = {};
    int buf = 0;
    const Loader ld(p, m0, n0);
    ld.issue(kb, ke, sh.u.t.a[0], sh.u.t.b[0]);
    cp_commit();
    for (int k0 = kb; k0 < ke; k0 += TK) {
      if (k0 + TK < ke) {
        ld.issue(k0 + TK, ke, sh.u.t.a[buf ^ 1], sh.u.t.b[buf ^ 1]);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&sh.u.t.a[buf][kk][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&sh.u.t.b[buf][kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
        }
      }
      __syncthreads();
      buf ^= 1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n >= p.N) continue;
        if (p.S == 1) epilogue(p, m, n, acc[i][j], gsq);
        else p.part[((size_t)sl * p.M + m) * p.N + n] = acc[i][j];
      }
    }
  }
  return gsq;
}

// After a barrier: sum each split product's partials in k-slice order and
// apply its epilogue; then the row sums, one warp a row, the first row on
// global warp warp_base.
__device__ __noinline__ float reduce_products(int np, int nrs, int warp_base) {
  float gsq = 0.f;   // squares of the gradient entries this thread writes
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int gthreads = gridDim.x * THREADS;
  for (int i = 0; i < np; ++i) {
    const Prod& p = sh.prod[i];
    if (p.S == 1) continue;
    const size_t mn = (size_t)p.M * p.N;
    for (size_t o = gtid; o < mn; o += gthreads) {
      float acc = 0.f;
      for (int s = 0; s < p.S; ++s) acc += p.part[s * mn + o];
      epilogue(p, (int)(o / p.N), (int)(o % p.N), acc, gsq);
    }
  }
  const int lane = threadIdx.x & 31;
  const int gwarp = gtid >> 5, gwarps = gthreads >> 5;
  int row0 = warp_base % gwarps;   // the warp that takes the first row
  for (int i = 0; i < nrs; ++i) {
    const RowSum& q = sh.rsum[i];
    for (int r = (gwarp + gwarps - row0) % gwarps; r < q.rows; r += gwarps) {
      float acc = 0.f;
      for (int c = lane; c < q.cols; c += 32) acc += *at(q.X, r, c);
      acc = warp_sum(acc);
      if (lane == 0) {
        q.out[r] = acc;
        gsq = fmaf(acc, acc, gsq);
        if (q.kind == RS_BIAS2) {
          q.out2[r] = acc;
          gsq = fmaf(acc, acc, gsq);
        } else if (q.kind == RS_NOISE) {
          const float g2 = acc * q.noise[r];
          q.out2[r] = g2;
          gsq = fmaf(g2, g2, gsq);
        }
      }
    }
    row0 = (row0 + q.rows) % gwarps;
  }
  return gsq;
}

// Set product slot i (thread 0 only; the caller syncs before use).
__device__ void set_prod(Prod& p, Mat A, Mat B, int M, int N, int Kd, int ep,
                         float* out, int ldo, float* part,
                         const float* v1 = nullptr, const float* v2 = nullptr,
                         float* out2 = nullptr, Mat mask = Mat{}) {
  p.A = A; p.B = B; p.mask = mask;
  p.M = M; p.N = N; p.Kd = Kd; p.ep = ep; p.ldo = ldo;
  p.out = out; p.out2 = out2; p.v1 = v1; p.v2 = v2; p.part = part;
}

// Stage the four gate columns of W_hh (of the weights at P) for this
// block's unit: wcol[i] = (W[i, j], W[i, H + j], W[i, 2H + j], W[i, 3H + j]).
__device__ void stage_wcol(const float* P, const POff& po, int H) {
  const int j = blockIdx.x, G4 = 4 * H;
  if (j >= H) return;
  for (int i = threadIdx.x; i < H; i += THREADS) {
    const float* w = P + po.whh + (size_t)i * G4 + j;
    sh.wcol[i] = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
  }
}

// One forward LSTM step of unit j = blockIdx.x (< H) over ncol columns
// (a multiple of 4): gates(:, n) = xp(:, t, n) + W_hh^T h_t(:, n), the
// cell, h_{t+1}(j, n). xpj: xp row j at step t (gate a at xpj[a * ldx +
// n]); c is read at cin and written at cout (the same for the target
// pass); act, if given, gets the four gate activations (gate a at act[a *
// lda + n]). A thread takes 4 columns (float4 loads of h) and a KG-th of
// the inner sum over H; the groups are added in group order.
__device__ void lstm_step(int H, int ncol, const float* hin, const float* xpj,
                          size_t ldx, const float* cin, float* cout,
                          float* hout, float* act, size_t lda) {
  const int j = blockIdx.x, n4 = ncol / 4;
  const int KG = max(1, THREADS / n4), ipg = (H + KG - 1) / KG;
  auto cell = [&](int n, float4 acc) {
    const float g0 = xpj[n] + acc.x, g1 = xpj[ldx + n] + acc.y;
    const float g2 = xpj[2 * ldx + n] + acc.z, g3 = xpj[3 * ldx + n] + acc.w;
    const float gi = sigmoid(g0), gf = sigmoid(g1);
    const float gg = tanhf(g2), go = sigmoid(g3);
    const float cn = gf * cin[n] + gi * gg;
    cout[n] = cn;
    hout[(size_t)j * ncol + n] = go * tanhf(cn);
    if (act != nullptr) {
      act[n] = gi;
      act[lda + n] = gf;
      act[2 * lda + n] = gg;
      act[3 * lda + n] = go;
    }
  };
  for (int item = threadIdx.x; item < n4 * KG; item += THREADS) {
    const int c4 = item % n4, kg = item / n4;
    float4 acc[4];   // acc[q]: the four gates of column 4 c4 + q
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int i1 = min(H, (kg + 1) * ipg);
#pragma unroll 4
    for (int i = kg * ipg; i < i1; ++i) {
      const float4 h = __ldcg(reinterpret_cast<const float4*>(hin + (size_t)i * ncol) + c4);
      const float4 w = sh.wcol[i];
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q].x = fmaf(w.x, hv[q], acc[q].x);
        acc[q].y = fmaf(w.y, hv[q], acc[q].y);
        acc[q].z = fmaf(w.z, hv[q], acc[q].z);
        acc[q].w = fmaf(w.w, hv[q], acc[q].w);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (KG == 1) cell(4 * c4 + q, acc[q]);
      else sh.u.step[4 * item + q] = acc[q];
    }
  }
  if (KG > 1) {
    __syncthreads();
    for (int n = threadIdx.x; n < ncol; n += THREADS) {
      float4 acc = sh.u.step[n];   // group 0: item n / 4, column n % 4
      for (int kg = 1; kg < KG; ++kg) {
        const float4 p = sh.u.step[4 * kg * n4 + n];
        acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
      }
      cell(n, acc);
    }
  }
}

// One BPTT step t of unit j = blockIdx.x (< H). dL/dh_t(j, b) is, at
// t = T - 1, the effective shared-head row j . dL/ds_pre(:, b) (a KG-th of
// the inner sum a thread, the groups added in order); else the sum over
// units u, in unit order, of the partials unit u wrote at step t + 1.
// Then the elementwise backward of the cell writes dg_t rows (gate, j) and
// carries dc(j, b), and the block writes its partial of dL/dh_{t-1}: for
// every unit i, sum over gates a of W_hh[i, aH + j] dg_t(aH + j, b).
__device__ void bptt_step(const Dims& d, const Scratch& S, float* W, int t) {
  const int j = blockIdx.x, H = d.H, bs = d.bs, B2 = 2 * bs;
  const int N = d.T * B2, NB = d.T * bs;
  const bool first = t == d.T - 1;
  const float* act = W + S.act;
  const float* cs = W + S.cs;
  float* dg = W + S.dg;
  float* dc = W + S.dc;
  const size_t hhb = (size_t)H * H * bs;
  const float* pin = W + S.bpart + (size_t)((t + 1) & 1) * hhb;
  float* pout = W + S.bpart + (size_t)(t & 1) * hhb;
  // the elementwise backward of unit j at column b from dL/dh_t(j, b)
  auto cell_back = [&](int b, float dh) {
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
  // 4 columns a thread (float4 loads), a KG-th of the inner sum
  const int b4 = bs / 4, KG = max(1, THREADS / b4);
  const int inner = first ? d.HH : H, rpg = (inner + KG - 1) / KG;
  for (int item = threadIdx.x; item < b4 * KG; item += THREADS) {
    const int c4 = item % b4, kg = item / b4;
    const int r1 = min(inner, (kg + 1) * rpg);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first) {
      const float4* dsp = reinterpret_cast<const float4*>(W + S.dspre) + c4;
      for (int r = kg * rpg; r < r1; ++r) {
        const float4 g = dsp[(size_t)r * b4];
        const float w = sh.swrow[r];
        a.x = fmaf(w, g.x, a.x); a.y = fmaf(w, g.y, a.y);
        a.z = fmaf(w, g.z, a.z); a.w = fmaf(w, g.w, a.w);
      }
    } else {
      const float4* pu = reinterpret_cast<const float4*>(pin + (size_t)j * bs) + c4;
#pragma unroll 8
      for (int u = kg * rpg; u < r1; ++u) {
        const float4 g = __ldcg(pu + (size_t)u * H * b4);
        a.x += g.x; a.y += g.y; a.z += g.z; a.w += g.w;
      }
    }
    if (KG == 1) {   // the whole inner sum: apply the cell here
      cell_back(4 * c4, a.x);
      cell_back(4 * c4 + 1, a.y);
      cell_back(4 * c4 + 2, a.z);
      cell_back(4 * c4 + 3, a.w);
    } else {
      sh.part4[item] = a;
    }
  }
  if (KG > 1) {
    __syncthreads();
    for (int b = threadIdx.x; b < bs; b += THREADS) {
      float dh = 0.f;
      for (int kg = 0; kg < KG; ++kg) {
        const float4 p = sh.part4[kg * b4 + b / 4];
        dh += (b & 3) == 0 ? p.x : (b & 3) == 1 ? p.y : (b & 3) == 2 ? p.z : p.w;
      }
      cell_back(b, dh);
    }
  }
  if (t == 0) return;
  __syncthreads();   // this block's dg_t rows, read back (L1) below
  const float* g0 = dg + (size_t)j * NB + (size_t)t * bs;
  for (int o = threadIdx.x; o < H * bs; o += THREADS) {
    const int i = o / bs, b = o % bs;
    const float4 w = sh.wcol[i];
    float p = w.x * g0[b];
    p = fmaf(w.y, g0[(size_t)H * NB + b], p);
    p = fmaf(w.z, g0[(size_t)2 * H * NB + b], p);
    p = fmaf(w.w, g0[(size_t)3 * H * NB + b], p);
    pout[((size_t)j * H + i) * bs + b] = p;
  }
}

// The shared head, Q, the Double-DQN TD error and the masked Huber loss of
// update k, one block a sample b: thread t computes unit t % 128 of the
// head for column half t / 128 (obs, next); the V and A sums are added
// warp by warp in order. mk: this update's meta rows (act, rew, done,
// valid). Writes s_pre and s (obs half), hub, dv, da, dL/ds_pre and the
// denominator.
__device__ void q_phase(const Dims& d, const Hyper& hp, const Scratch& S,
                        float* W, const float* __restrict__ mk, int k) {
  const NOff& NO = sh.NO;
  const int H = d.H, HH = d.HH, bs = d.bs, B2 = 2 * bs;
  const int lane = threadIdx.x & 31;
  const float* eff = W + S.eff;
  const float* hT = W + S.hs + (size_t)d.T * H * B2;
  const float* qt = W + S.qt;
  float *spre = W + S.spre, *s = W + S.s, *hub = W + S.hub;
  float *dv = W + S.dv, *da = W + S.da;
  for (int b = blockIdx.x; b < bs; b += gridDim.x) {
    const int half = threadIdx.x >> 7, jj = threadIdx.x & 127;
    float c4[4] = {0.f, 0.f, 0.f, 0.f}, sp = 0.f;
    if (jj < HH) {
      const int col = half * bs + b;
      float a = 0.f;
      for (int i = 0; i < H; ++i)
        a = fmaf(eff[NO.sw + (size_t)i * HH + jj], hT[(size_t)i * B2 + col], a);
      sp = a + eff[NO.sb + jj];
      const float sv = fmaxf(sp, 0.f);
      if (half == 0) {
        spre[(size_t)jj * B2 + b] = sp;
        s[(size_t)jj * B2 + b] = sv;
      }
      c4[0] = eff[NO.vw + jj] * sv;
      for (int x3 = 0; x3 < 3; ++x3) c4[1 + x3] = eff[NO.aw + 3 * jj + x3] * sv;
    }
    const int warp = threadIdx.x >> 5;
    for (int q = 0; q < 4; ++q) {
      const float w = warp_sum(c4[q]);
      if (lane == 0) sh.red[warp * 4 + q] = w;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float q[2][3];
      for (int h = 0; h < 2; ++h) {
        float r4[4];
        for (int q4 = 0; q4 < 4; ++q4) {
          float t4 = 0.f;
          for (int w = 4 * h; w < 4 * h + 4; ++w) t4 += sh.red[w * 4 + q4];
          r4[q4] = t4;
        }
        const float v = r4[0] + eff[NO.vb];
        const float a0 = r4[1] + eff[NO.ab], a1 = r4[2] + eff[NO.ab + 1];
        const float a2 = r4[3] + eff[NO.ab + 2];
        const float mean = (a0 + a1 + a2) / 3.0f;
        q[h][0] = (v + a0) - mean;
        q[h][1] = (v + a1) - mean;
        q[h][2] = (v + a2) - mean;
      }
      float wsum = 0.f;
      for (int bb = 0; bb < bs; ++bb) wsum += mk[3 * bs + bb];
      const float denom = fmaxf(wsum, 1.0f);
      const int na0 = q[1][1] > q[1][0] ? 1 : 0;
      const int na = q[1][2] > fmaxf(q[1][0], q[1][1]) ? 2 : na0;
      const float nq = qt[((size_t)k * 3 + na) * bs + b];
      const int a = (int)mk[b];
      const float y = mk[bs + b] + hp.gamma * nq * (1.0f - mk[2 * bs + b]);
      const float td = q[0][a] - y;
      const float at_ = fabsf(td);
      const float hb = at_ <= 1.0f ? 0.5f * td * td : at_ - 0.5f;
      const float wm = mk[3 * bs + b];
      hub[b] = wm * hb;
      const float dq = wm * fminf(fmaxf(td, -1.0f), 1.0f) / denom;
      dv[b] = dq;
      for (int x3 = 0; x3 < 3; ++x3) da[x3 * bs + b] = (x3 == a ? dq : 0.f) - dq / 3.0f;
      if (b == 0) W[S.q] = denom;
      sh.red[32] = dq;
      for (int x3 = 0; x3 < 3; ++x3) sh.red[33 + x3] = da[x3 * bs + b];
    }
    __syncthreads();
    if (half == 0 && jj < HH) {   // dL/ds_pre (jj, b) through the ReLU
      const float ds = eff[NO.vw + jj] * sh.red[32] +
                       (eff[NO.aw + 3 * jj] * sh.red[33] + eff[NO.aw + 3 * jj + 1] * sh.red[34] +
                        eff[NO.aw + 3 * jj + 2] * sh.red[35]);
      W[S.dspre + (size_t)jj * bs + b] = sp > 0.f ? ds : 0.f;
    }
    __syncthreads();
  }
}

// Target Q (mu weights) of nc sequences of T steps into qt rows
// [(kq * 3 + a) * bs + b]: column col is entry (col / bs + k_base, col %
// bs). X(i, t * nc + col) is input i of step t.
__device__ void target_q(const Dims& d, const float* __restrict__ Pt,
                         float* W, const Scratch& S, int nc, int k_base,
                         Mat X, cg::grid_group& grid) {
  const POff& P = sh.P;
  const int H = d.H, G4 = 4 * H, NT = d.T * nc, HH = d.HH;
  float* tf1 = W + S.tf1;
  float* tf2 = W + S.tf2;
  float* txp = W + S.txp;
  float* tc = W + S.tc;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int gthreads = gridDim.x * THREADS;
  if (threadIdx.x == 0)
    set_prod(sh.prod[0], mat(Pt + P.w1, 1, d.F1), X, d.F1, NT, 7,
             EP_RELU_BIAS, tf1, NT, nullptr, Pt + P.b1);
  for (int i = gtid; i < H * nc; i += gthreads) {
    W[S.th + i] = 0.f;
    tc[i] = 0.f;
  }
  stage_wcol(Pt, P, H);
  run_products(1, false);
  grid.sync();  // phase: target features
  if (threadIdx.x == 0)
    set_prod(sh.prod[0], mat(Pt + P.w2, 1, d.F), mat(tf1, NT, 1), d.F, NT,
             d.F1, EP_RELU_BIAS, tf2, NT, nullptr, Pt + P.b2);
  run_products(1, false);
  grid.sync();  // phase: target features
  if (threadIdx.x == 0)
    set_prod(sh.prod[0], mat(Pt + P.wih, 1, G4), mat(tf2, NT, 1), G4, NT,
             d.F, EP_XP, txp, NT, nullptr, Pt + P.bih, Pt + P.bhh);
  run_products(1, false);
  grid.sync();  // phase: target features
  for (int t = 0; t < d.T; ++t) {
    if (blockIdx.x < H) {
      const int j = blockIdx.x;
      lstm_step(H, nc, W + S.th + (size_t)(t % 2) * H * nc,
                txp + (size_t)j * NT + (size_t)t * nc, (size_t)H * NT,
                tc + (size_t)j * nc, tc + (size_t)j * nc,
                W + S.th + (size_t)((t + 1) % 2) * H * nc, nullptr, 0);
    }
    grid.sync();  // phase: target recurrent steps
  }
  const float* hT = W + S.th + (size_t)(d.T % 2) * H * nc;
  float* ts = W + S.ts;
  if (threadIdx.x == 0)
    set_prod(sh.prod[0], mat(Pt + P.ws, 1, HH), mat(hT, nc, 1), HH, nc, H,
             EP_RELU_BIAS, ts, nc, nullptr, Pt + P.bs);
  run_products(1, false);
  grid.sync();  // phase: target heads
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
  grid.sync();  // phase: target heads
}

__global__ void __launch_bounds__(THREADS, 1)
drqn_update_kernel(Dims d, Hyper hp, const float* __restrict__ xt,
                   const float* __restrict__ nextt,
                   const float* __restrict__ meta,
                   const float* __restrict__ noise, float* params,
                   float* target, float* m_, float* v_,
                   float* __restrict__ losses, float* W) {
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) {
    sh.P = POff(d);
    sh.NO = NOff(d);
    sh.S = Scratch(d, gridDim.x);
  }
  __syncthreads();
  const POff& P = sh.P;
  const NOff& NO = sh.NO;
  const Scratch& S = sh.S;
  const int H = d.H, G4 = 4 * H, HH = d.HH, bs = d.bs, B2 = 2 * bs, T = d.T;
  const int N = T * B2, NB = T * bs, KB = d.K * bs;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int gthreads = gridDim.x * THREADS;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x;   // the hidden unit this block owns, if j < H
  float *f1 = W + S.f1, *f2 = W + S.f2, *xp = W + S.xp, *act = W + S.act;
  float *hs = W + S.hs, *cs = W + S.cs, *s = W + S.s, *eff = W + S.eff;
  float *dv = W + S.dv, *da = W + S.da, *hub = W + S.hub;
  float *dspre = W + S.dspre, *dg = W + S.dg, *dz2 = W + S.dz2;
  float *dz1 = W + S.dz1, *grad = W + S.grad, *part = W + S.part;
  const float* hT = hs + (size_t)T * H * B2;

  for (int k = 0; k < d.K; ++k) {
    const float* x = xt + (size_t)k * 7 * N;
    const float* nz = noise + (size_t)k * NO.n;
    float gsq = 0.f;   // this thread's share of the squared gradient norm
    // ---- target Q(s'): the wide pass at k = 0, or this update's entry
    if (hp.tau > 0.f || (hp.ts0 % hp.interval) + k >= hp.interval) {
      target_q(d, target, W, S, bs, k, gmat(x + bs, N, bs, B2), grid);
    } else if (k == 0) {
      target_q(d, target, W, S, KB, 0, gmat(nextt, KB, KB, 7 * KB), grid);
    }

    // ---- online forward over obs || next, activations stored ----------
    if (threadIdx.x == 0)
      set_prod(sh.prod[0], mat(params + P.w1, 1, d.F1), mat(x, N, 1), d.F1,
               N, 7, EP_RELU_BIAS, f1, N, nullptr, params + P.b1);
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
    stage_wcol(params, P, H);
    if (j < H) {   // this unit's effective shared-head row
      for (int c = threadIdx.x; c < HH; c += THREADS) {
        const size_t o = (size_t)j * HH + c;
        sh.swrow[c] = params[P.ws + o] + params[P.wss + o] * nz[NO.sw + o];
      }
    }
    run_products(1, false);
    grid.sync();  // phase: forward product f1
    if (threadIdx.x == 0)
      set_prod(sh.prod[0], mat(params + P.w2, 1, d.F), mat(f1, N, 1), d.F, N,
               d.F1, EP_RELU_BIAS, f2, N, nullptr, params + P.b2);
    run_products(1, false);
    grid.sync();  // phase: forward product f2
    if (threadIdx.x == 0)
      set_prod(sh.prod[0], mat(params + P.wih, 1, G4), mat(f2, N, 1), G4, N,
               d.F, EP_XP, xp, N, nullptr, params + P.bih, params + P.bhh);
    run_products(1, false);
    grid.sync();  // phase: forward product xp
    for (int t = 0; t < T; ++t) {
      if (j < H) {
        const size_t hb = (size_t)H * B2;
        lstm_step(H, B2, hs + t * hb, xp + (size_t)j * N + (size_t)t * B2,
                  (size_t)H * N, cs + t * hb + (size_t)j * B2,
                  cs + (t + 1) * hb + (size_t)j * B2, hs + (t + 1) * hb,
                  act + (size_t)j * N + (size_t)t * B2, (size_t)H * N);
      }
      grid.sync();  // phase: recurrent steps
    }
    // ---- shared head, Q, Double-DQN TD, masked Huber: one block a sample
    q_phase(d, hp, S, W, meta + (size_t)k * 4 * bs, k);
    grid.sync();  // phase: Q and TD

    // ---- BPTT, one step a barrier: block j owns unit j ---------------------
    for (int t = T - 1; t >= 0; --t) {
      const bool first = t == T - 1;   // dL/dh_T from the shared head
      if (j < H) bptt_step(d, S, W, t);
      if (first) {
        // head gradients, beside the first BPTT step
        if (gtid == 0) {
          float hsum = 0.f;
          for (int b = 0; b < bs; ++b) hsum += hub[b];
          losses[k] = hsum / W[S.q];
        }
        for (int o = gtid; o < 4 * HH + 4; o += gthreads) {
          if (o < HH) {                                  // V head weight
            float g = 0.f;
            for (int b = 0; b < bs; ++b) g = fmaf(dv[b], s[(size_t)o * B2 + b], g);
            const float g2 = g * nz[NO.vw + o];
            grad[P.wv + o] = g;
            grad[P.wvs + o] = g2;
            gsq = fmaf(g, g, fmaf(g2, g2, gsq));
          } else if (o < 4 * HH) {                       // A head weight (j, a)
            const int jj = (o - HH) / 3, a = (o - HH) % 3;
            float g = 0.f;
            for (int b = 0; b < bs; ++b) g = fmaf(da[a * bs + b], s[(size_t)jj * B2 + b], g);
            const float g2 = g * nz[NO.aw + o - HH];
            grad[P.wa + o - HH] = g;
            grad[P.was + o - HH] = g2;
            gsq = fmaf(g, g, fmaf(g2, g2, gsq));
          } else if (o == 4 * HH) {                      // V bias
            float g = 0.f;
            for (int b = 0; b < bs; ++b) g += dv[b];
            const float g2 = g * nz[NO.vb];
            grad[P.bv] = g;
            grad[P.bvs] = g2;
            gsq = fmaf(g, g, fmaf(g2, g2, gsq));
          } else {                                       // A bias
            const int a = o - 4 * HH - 1;
            float g = 0.f;
            for (int b = 0; b < bs; ++b) g += da[a * bs + b];
            const float g2 = g * nz[NO.ab + a];
            grad[P.ba + a] = g;
            grad[P.bas + a] = g2;
            gsq = fmaf(g, g, fmaf(g2, g2, gsq));
          }
        }
      }
      grid.sync();  // phase: BPTT steps
    }

    // ---- backward: LSTM weights, input projection, features -------------
    const Mat dgT = mat(dg, 1, NB);   // (T*bs, 4H): dg transposed
    if (threadIdx.x == 0) {
      set_prod(sh.prod[0], gmat(hs, B2, bs, H * B2), dgT, H, G4, NB, EP_GRAD,
               grad + P.whh, G4, part);
      set_prod(sh.prod[1], gmat(f2, N, bs, B2), dgT, d.F, G4, NB, EP_GRAD,
               grad + P.wih, G4, part);
      set_prod(sh.prod[2], mat(params + P.wih, G4, 1), mat(dg, NB, 1), d.F, NB,
               G4, EP_MASK, dz2, NB, part, nullptr, nullptr, nullptr,
               gmat(f2, N, bs, B2));
      set_prod(sh.prod[3], mat(hT, B2, 1), mat(dspre, 1, bs), H, HH, bs,
               EP_GRAD_NOISE, grad + P.ws, HH, part, nz + NO.sw, nullptr,
               grad + P.wss);
      sh.rsum[0] = RowSum{mat(dg, NB, 1), G4, NB, RS_BIAS2, grad + P.bih,
                          grad + P.bhh, nullptr};
      sh.rsum[1] = RowSum{mat(dspre, bs, 1), HH, bs, RS_NOISE, grad + P.bs,
                          grad + P.bss, nz + NO.sb};
    }
    gsq += run_products(4, true);
    grid.sync();  // phase: weight gradients W1
    gsq += reduce_products(4, 2, 0);
    grid.sync();  // phase: weight gradients R1
    if (threadIdx.x == 0) {
      set_prod(sh.prod[0], gmat(f1, N, bs, B2), mat(dz2, 1, NB), d.F1, d.F,
               NB, EP_GRAD, grad + P.w2, d.F, part);
      set_prod(sh.prod[1], mat(params + P.w2, d.F, 1), mat(dz2, NB, 1), d.F1,
               NB, d.F, EP_MASK, dz1, NB, part, nullptr, nullptr, nullptr,
               gmat(f1, N, bs, B2));
      sh.rsum[0] = RowSum{mat(dz2, NB, 1), d.F, NB, RS_PLAIN, grad + P.b2,
                          nullptr, nullptr};
    }
    gsq += run_products(2, true);
    grid.sync();  // phase: weight gradients W2
    gsq += reduce_products(2, 1, 0);
    grid.sync();  // phase: weight gradients R2
    // dW1 = x^T dz1 over the obs columns, one warp an entry (lanes stride
    // the columns, a fixed-order warp sum); b1 = the row sums of dz1 on
    // the next warps; then the norm
    if (threadIdx.x == 0)
      sh.rsum[0] = RowSum{mat(dz1, NB, 1), d.F1, NB, RS_PLAIN, grad + P.b1,
                          nullptr, nullptr};
    for (int e = gtid >> 5; e < 7 * d.F1; e += gthreads >> 5) {
      const int i = e / d.F1, jj = e % d.F1;
      float a = 0.f;
      for (int n = lane; n < NB; n += 32)
        a = fmaf(x[(size_t)i * N + (n / bs) * B2 + n % bs], dz1[(size_t)jj * NB + n], a);
      a = warp_sum(a);
      if (lane == 0) {
        grad[P.w1 + e] = a;
        gsq = fmaf(a, a, gsq);
      }
    }
    __syncthreads();
    gsq += reduce_products(0, 1, 7 * d.F1);
    {  // clip_by_global_norm: per-block partials, summed in block order
      const float tot = block_sum(gsq, sh.red);
      if (threadIdx.x == 0) W[S.norm + blockIdx.x] = tot;
    }
    grid.sync();  // phase: weight gradients W3

    // ---- Adam on the flat vector, target sync ----------------------------
    float gnorm2 = 0.f;
    for (int b = 0; b < (int)gridDim.x; ++b) gnorm2 += W[S.norm + b];
    const float scale = hp.clip / fmaxf(sqrtf(gnorm2), hp.clip);
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
    grid.sync();  // phase: Adam
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
// done, valid; noise (K, NN); params/target/m/v (P,); losses (K,). Every
// width <= 128, bs a multiple of 4, and at least H blocks (one per hidden
// unit). Returns the
// cudaError_t (cudaErrorCooperativeLaunchTooLarge and the like when the
// cooperative launch is refused).
int drqn_update_launch(int F1, int F, int H, int HH, int K, int bs, int T,
                       const Hyper* hp, const float* xt, const float* nextt,
                       const float* meta, const float* noise, float* params,
                       float* target, float* m, float* v, float* losses,
                       float* scratch, cudaStream_t stream) {
  Dims d{F1, F, H, HH, K, bs, T};
  Hyper h = *hp;
  const int grid = grid_blocks();
  if (grid == 0) return (int)cudaErrorLaunchOutOfResources;
  if (H > MAX_H || HH > MAX_H || H > grid || bs % 4 != 0)
    return (int)cudaErrorInvalidValue;
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
