// Fused DQN update block: K sequential PER + Double-DQN updates in one
// launch.
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
// place; newp, idx and losses are outputs; grad is scratch.
//
// What bounds it on an H100: the serial chain, not bytes or FLOPs. The
// block moves about 8 MB and computes about 0.5 GFLOP (tens of microseconds
// of the card's peak), but update k+1 samples from the priorities update k
// wrote and steps from the parameters it wrote, so the K updates are a
// dependency chain. The design runs the whole block as ONE thread block of
// 1024 threads that loops over k, with every activation, the parameters
// and the chunk-level CDF in shared memory (about 210 KB); only the
// sampled rows, the p_alpha rows and the moments touch global memory.
// Per update: a block-wide scan of the chunk sums (exact, in double, then
// rounded to f32; no tensor cores, no TF32: the sampled index is a compare
// against these sums), one
// thread per sample for the search, the gather and the per-sample head
// math, block-wide loops for the 64-wide layers and the gradient sums, one
// thread per parameter for Adam. The TPU kernel refreshes every chunk sum
// with a full plane reduce per update; here only the <= bs chunks the
// write-back touched are re-summed from their 128 slots (the same values
// up to summation order).

#include <cuda_runtime.h>
#include <stdint.h>

// Hyper-parameters; each is rounded to float32 once on the host
// (ops/dqn_update.py::Hyper builds the same struct).
struct Hyper {
  float lr, gamma, tau, alpha, per_eps, beta_start, beta_slope;
  float b1, b2, one_m_b1, one_m_b2, eps, log_b1, log_b2, inv_bs, two_bs;
  int interval, heads_only;
};

namespace {

constexpr int THREADS = 1024;
constexpr int D = 7;       // obs dim
constexpr int H = 64;      // hidden
constexpr int LD = H + 1;  // padded row stride of the activation buffers
constexpr int CH = 128;    // slots per chunk
constexpr int R = 16;      // fields per slot in a chunk block

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
constexpr int NN = 4 * H + 4;         // 260

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    red[32] = t;
  }
  __syncthreads();
  return red[32];
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
    for (int w = 1; w < THREADS / 32; ++w) t = fmaxf(t, red[w]);
    red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// inclusive prefix sums of cs[0:nc] into cdf[0:nc], block-wide: each
// thread scans a contiguous run, then the run totals are scanned. The sums
// are carried in double and rounded to float32 once. A double holds the
// prefix of 8192 float32 chunk sums exactly unless their magnitudes span
// more than ~2^16, so the CDF does not depend on the summation order and
// the plain version (ops/dqn_update.py) reproduces it bit for bit.
__device__ void block_cdf(const float* cs, int nc, float* cdf, double* red) {
  const int per = (nc + THREADS - 1) / THREADS;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, nc);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) run += (double)cs[i];
  // exclusive scan of the thread totals: warp shuffles, then warp totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double inc = run;
  for (int o = 1; o < 32; o <<= 1) {
    double n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) {
      double t = red[w];
      red[w] = acc;
      acc += t;
    }
  }
  __syncthreads();
  double ex = __shfl_up_sync(0xffffffffu, inc, 1);
  double acc = red[warp] + (lane == 0 ? 0.0 : ex);
  for (int i = lo; i < hi; ++i) {
    acc += (double)cs[i];
    cdf[i] = (float)acc;
  }
  __syncthreads();
}

// out[s, j] = relu(b[j] + sum_i in[s, i] * W[i, j]) for s < bs, j < 64
__device__ void dense_relu(const float* in, int ld_in, int n_in,
                           const float* W, const float* b, float* out,
                           int bs) {
  for (int o = threadIdx.x; o < bs * H; o += THREADS) {
    const int s = o / H, j = o % H;
    float acc = 0.f;
    for (int i = 0; i < n_in; ++i) acc = fmaf(in[s * ld_in + i], W[i * H + j], acc);
    out[s * LD + j] = fmaxf(acc + b[j], 0.f);
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

__global__ void __launch_bounds__(THREADS)
dqn_update_kernel(int ts0, int count0, int frame0, int size, int K, int bs,
                  int nc, Hyper hp, const float* __restrict__ u01,
                  const float* __restrict__ noise, float* p_alpha,
                  float* chunk_sums, float* params, float* target, float* m,
                  float* v, const float* __restrict__ data,
                  float* __restrict__ newp_out, int* __restrict__ idx_out,
                  float* __restrict__ losses, float* grad) {
  extern __shared__ double smem_d[];
  double* sRedD = smem_d;               // 64 double reduction slots
  float* smem = (float*)(smem_d + 64);
  float* bufA = smem;                   // (bs, LD) activations; the CDF
  float* bufB = bufA + bs * LD;         // (bs, LD)
  float* sP = bufB + bs * LD;           // online params (NP)
  float* sT = sP + NP;                  // target params (NP)
  float* sX = sT + NP;                  // (bs, 8) obs
  float* sXn = sX + bs * 8;             // (bs, 8) next obs
  float* sNoise = sXn + bs * 8;         // (NN)
  float* sWv = sNoise + NN;             // effective noisy heads
  float* sWa = sWv + H;                 // (64, 3)
  float* sBh = sWa + 3 * H;             // bv, ba0..2
  float* sRew = sBh + 4;                // per-sample scalars ...
  float* sDone = sRew + bs;
  float* sW = sDone + bs;               // IS weights
  float* sTd = sW + bs;
  float* sDV = sTd + bs;                // dL/dV
  float* sDA = sDV + bs;                // (bs, 3) dL/dA
  float* sQt = sDA + 3 * bs;            // (bs, 3) target Q of next
  float* sRed = sQt + 3 * bs;           // 64 reduction slots
  int* sAct = (int*)(sRed + 64);
  int* sNa = sAct + bs;
  int* sChunk = sNa + bs;
  int* sIdx = sChunk + bs;

  const int tid = threadIdx.x;
  for (int i = tid; i < NP; i += THREADS) {
    sP[i] = params[i];
    sT[i] = target[i];
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    // ---- inverse-CDF PER sample ----------------------------------------
    float* cdf = bufA;
    block_cdf(chunk_sums, nc, cdf, sRedD);
    const float total = cdf[nc - 1];
    const int frame_i = frame0 + k + 1;
    const float beta = fminf(1.0f, hp.beta_start + (float)frame_i * hp.beta_slope);
    float w_raw = 0.f;
    if (tid < bs) {
      const float uu = u01[k * bs + tid] * total;
      int lo = 0, hi = nc;  // first index with cdf >= uu == #(cdf < uu)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cdf[mid] < uu) lo = mid + 1; else hi = mid;
      }
      int c = min(lo, nc - 1);
      c = min(c, size / CH - 1);
      const float resid = uu - (c > 0 ? cdf[c - 1] : 0.f);
      const float* row = p_alpha + (size_t)c * CH;
      double run = 0.0;  // exact: 128 float32 terms
      int off = 0;
      for (int l = 0; l < CH; ++l) {
        run += (double)row[l];
        off += (float)run < resid ? 1 : 0;
      }
      off = min(off, CH - 1);
      const float pa_val = row[off];
      const float probs = pa_val / fmaxf(total, 1e-30f);
      w_raw = expf(-beta * logf((float)size * fmaxf(probs, 1e-30f)));
      sChunk[tid] = c;
      sIdx[tid] = c * CH + off;
      const float* blk = data + (size_t)c * R * CH + off;
      for (int r = 0; r < D; ++r) {
        sX[tid * 8 + r] = blk[r * CH];
        sXn[tid * 8 + r] = blk[(D + r) * CH];
      }
      sRew[tid] = blk[2 * D * CH];
      const float ad = blk[(2 * D + 1) * CH];
      const float done = ad > 3.5f ? 1.f : 0.f;
      sDone[tid] = done;
      sAct[tid] = (int)(ad - 4.0f * done);
    }
    const float w_max = block_max(tid < bs ? w_raw : 0.f, sRed);
    if (tid < bs) sW[tid] = w_raw / fmaxf(w_max, 1e-30f);

    // this update's noisy heads
    for (int i = tid; i < NN; i += THREADS) sNoise[i] = noise[k * NN + i];
    __syncthreads();
    for (int i = tid; i < H; i += THREADS)
      sWv[i] = sP[P_WV + i] + sP[P_WVS + i] * sNoise[N_EV + i];
    for (int i = tid; i < 3 * H; i += THREADS)
      sWa[i] = sP[P_WA + i] + sP[P_WAS + i] * sNoise[N_EA + i];
    if (tid == 0) sBh[0] = sP[P_BV] + sP[P_BVS] * sNoise[N_EVB];
    if (tid < 3) sBh[1 + tid] = sP[P_BA + tid] + sP[P_BAS + tid] * sNoise[N_EAB + tid];
    __syncthreads();

    // ---- target forward (mu only) on next ------------------------------
    dense_relu(sXn, 8, D, sT + P_W1, sT + P_B1, bufA, bs);
    dense_relu(bufA, LD, H, sT + P_W2, sT + P_B2, bufB, bs);
    if (tid < bs) q_values(bufB + tid * LD, sT + P_WV, sT[P_BV], sT + P_WA,
                           sT + P_BA, sQt + 3 * tid);
    __syncthreads();
    // ---- online forward on next: the Double-DQN argmax -----------------
    dense_relu(sXn, 8, D, sP + P_W1, sP + P_B1, bufA, bs);
    dense_relu(bufA, LD, H, sP + P_W2, sP + P_B2, bufB, bs);
    if (tid < bs) {
      float q[3];
      q_values(bufB + tid * LD, sWv, sBh[0], sWa, sBh + 1, q);
      const int na0 = q[1] > q[0] ? 1 : 0;
      sNa[tid] = q[2] > fmaxf(q[0], q[1]) ? 2 : na0;
    }
    __syncthreads();
    // ---- online forward on obs: f1 in bufA, f2 in bufB kept ------------
    dense_relu(sX, 8, D, sP + P_W1, sP + P_B1, bufA, bs);
    dense_relu(bufA, LD, H, sP + P_W2, sP + P_B2, bufB, bs);
    float lterm = 0.f;
    if (tid < bs) {
      float q[3];
      q_values(bufB + tid * LD, sWv, sBh[0], sWa, sBh + 1, q);
      const int a = sAct[tid];
      const float nq = sQt[3 * tid + sNa[tid]];
      const float y = sRew[tid] + hp.gamma * nq * (1.0f - sDone[tid]);
      const float td = q[a] - y;
      sTd[tid] = td;
      const float w = sW[tid];
      lterm = w * td * td;
      const float dq = hp.two_bs * w * td;
      sDV[tid] = dq;
      for (int j = 0; j < 3; ++j)
        sDA[3 * tid + j] = (j == a ? dq : 0.f) - dq / 3.0f;
    }
    const float loss = block_sum(lterm, sRed) * hp.inv_bs;
    if (tid == 0) losses[k] = loss;

    // ---- backward: head gradients (f2 = bufB) --------------------------
    for (int o = tid; o < 4 * H + 4; o += THREADS) {
      float g = 0.f;
      if (o < H) {                                   // dWv[h]
        for (int s = 0; s < bs; ++s) g = fmaf(sDV[s], bufB[s * LD + o], g);
        grad[P_WV + o] = g;
        grad[P_WVS + o] = g * sNoise[N_EV + o];
      } else if (o < 4 * H) {                        // dWa[h, a]
        const int h = (o - H) / 3, a = (o - H) % 3;
        for (int s = 0; s < bs; ++s) g = fmaf(sDA[3 * s + a], bufB[s * LD + h], g);
        grad[P_WA + o - H] = g;
        grad[P_WAS + o - H] = g * sNoise[N_EA + o - H];
      } else if (o == 4 * H) {                       // dbv
        for (int s = 0; s < bs; ++s) g += sDV[s];
        grad[P_BV] = g;
        grad[P_BVS] = g * sNoise[N_EVB];
      } else {                                       // dba[a]
        const int a = o - 4 * H - 1;
        for (int s = 0; s < bs; ++s) g += sDA[3 * s + a];
        grad[P_BA + a] = g;
        grad[P_BAS + a] = g * sNoise[N_EAB + a];
      }
    }
    __syncthreads();
    if (!hp.heads_only) {
      // dz2 = (wv dV + wa dA) * (f2 > 0), in place over f2
      for (int o = tid; o < bs * H; o += THREADS) {
        const int s = o / H, h = o % H;
        float df = sWv[h] * sDV[s];
        df += sWa[h * 3 + 0] * sDA[3 * s + 0] + sWa[h * 3 + 1] * sDA[3 * s + 1] +
              sWa[h * 3 + 2] * sDA[3 * s + 2];
        bufB[s * LD + h] = bufB[s * LD + h] > 0.f ? df : 0.f;
      }
      __syncthreads();
      // dW2 = f1^T dz2, db2 = sum dz2
      for (int o = tid; o < H * H + H; o += THREADS) {
        float g = 0.f;
        if (o < H * H) {
          const int i = o / H, j = o % H;
          for (int s = 0; s < bs; ++s) g = fmaf(bufA[s * LD + i], bufB[s * LD + j], g);
          grad[P_W2 + o] = g;
        } else {
          for (int s = 0; s < bs; ++s) g += bufB[s * LD + o - H * H];
          grad[P_B2 + o - H * H] = g;
        }
      }
      __syncthreads();
      // dz1 = (dz2 W2^T) * (f1 > 0), in place over f1
      for (int o = tid; o < bs * H; o += THREADS) {
        const int s = o / H, i = o % H;
        float df = 0.f;
        for (int j = 0; j < H; ++j) {  // rotated start: no bank conflicts
          const int jj = (j + i) & (H - 1);
          df = fmaf(bufB[s * LD + jj], sP[P_W2 + i * H + jj], df);
        }
        bufA[s * LD + i] = bufA[s * LD + i] > 0.f ? df : 0.f;
      }
      __syncthreads();
      // dW1 = x^T dz1, db1 = sum dz1
      for (int o = tid; o < D * H + H; o += THREADS) {
        float g = 0.f;
        if (o < D * H) {
          const int i = o / H, j = o % H;
          for (int s = 0; s < bs; ++s) g = fmaf(sX[s * 8 + i], bufA[s * LD + j], g);
          grad[P_W1 + o] = g;
        } else {
          for (int s = 0; s < bs; ++s) g += bufA[s * LD + o - D * H];
          grad[P_B1 + o - D * H] = g;
        }
      }
      __syncthreads();
    }

    // ---- Adam (flat, elementwise) + target sync -------------------------
    const float step = (float)(count0 + k + 1);
    const float bc1 = 1.0f - expf(step * hp.log_b1);
    const float bc2 = 1.0f - expf(step * hp.log_b2);
    const bool sync = ((ts0 + k + 1) % hp.interval) == 0;
    for (int i = tid; i < NP; i += THREADS) {
      float p = sP[i];
      if (!(hp.heads_only && i < FEAT_END)) {
        const float g = grad[i];
        const float mj = m[i] * hp.b1 + g * hp.one_m_b1;
        const float vj = v[i] * hp.b2 + g * g * hp.one_m_b2;
        m[i] = mj;
        v[i] = vj;
        p = p - hp.lr * ((mj / bc1) / (sqrtf(vj / bc2) + hp.eps));
        sP[i] = p;
      }
      if (hp.tau > 0.f) sT[i] = sT[i] + hp.tau * (p - sT[i]);
      else if (sync) sT[i] = p;
    }

    // ---- priorities: outputs, then the write-back in sample order -------
    if (tid < bs) {
      const float np_ = fabsf(sTd[tid]) + hp.per_eps;
      newp_out[k * bs + tid] = np_;
      idx_out[k * bs + tid] = sIdx[tid];
      sTd[tid] = expf(hp.alpha * logf(np_));   // p_alpha of the new priority
    }
    __syncthreads();
    if (tid == 0) {
      for (int s = 0; s < bs; ++s) p_alpha[sIdx[s]] = sTd[s];
    }
    __syncthreads();
    if (tid < bs) {  // exact refresh of the touched chunk sums
      const int c = sChunk[tid];
      const float* row = p_alpha + (size_t)c * CH;
      double acc = 0.0;  // exact, as in the CDF
      for (int l = 0; l < CH; ++l) acc += (double)row[l];
      chunk_sums[c] = (float)acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < NP; i += THREADS) {
    params[i] = sP[i];
    target[i] = sT[i];
  }
}

size_t smem_bytes(int bs) {
  return sizeof(double) * 64 + sizeof(float) * (2 * (size_t)bs * LD + 2 * NP + 16 * (size_t)bs +
                          NN + 4 * H + 4 + 11 * (size_t)bs + 64) +
         sizeof(int) * 4 * (size_t)bs;
}

}  // namespace

extern "C" {

// Run K fused updates on `stream`. Shapes (checked by the Python wrapper):
// u01 (K, bs), noise (K, 260), p_alpha (nc*128), chunk_sums (nc),
// params/target/m/v/grad (5192), data (nc, 16, 128), newp/idx (K, bs),
// losses (K). bs <= 256, bs * 65 >= nc. Returns the cudaError_t.
int dqn_update_launch(int ts0, int count0, int frame0, int size, int K,
                      int bs, int nc, const Hyper* hp, const float* u01,
                      const float* noise, float* p_alpha, float* chunk_sums,
                      float* params, float* target, float* m, float* v,
                      const float* data, float* newp, int* idx,
                      float* losses, float* grad, cudaStream_t stream) {
  const size_t smem = smem_bytes(bs);
  cudaError_t err = cudaFuncSetAttribute(
      dqn_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dqn_update_kernel<<<1, THREADS, smem, stream>>>(
      ts0, count0, frame0, size, K, bs, nc, *hp, u01, noise, p_alpha,
      chunk_sums, params, target, m, v, data, newp, idx, losses, grad);
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
