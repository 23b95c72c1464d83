// Kernel 6: the categorical (C51) projection of Rainbow's target and the
// cross-entropy against the online logits, with the gradient with respect
// to those logits in closed form. One warp a row of the batch; the atoms
// (at most 64) are spread two a lane.
//
// Per row b, with atoms i, j = 0..A-1 on the support z_j = v_min + j dz:
//   pos_j  = (clamp(G_b + disc_b z_j, v_min, v_max) - v_min) / dz
//   m_i    = sum_j p_j max(0, 1 - |pos_j - i|)   (the mass of atom j split
//            between floor(pos_j) and ceil(pos_j), whole on i = pos_j)
//   lse    = log sum_i exp(x_i)
//   loss_b = -sum_i m_i (x_i - lse)
//   dx_i   = (w_b / bs) (exp(x_i - lse) - m_i)
// x the online logits of the row's action, p the target distribution at
// the bootstrap action, G the n-step return, disc gamma^n (0 at an episode
// end), w the importance weight. The products and sums of the shift are
// rounded one at a time (no contraction), as the plain version computes
// them in ops/c51_loss.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_ATOMS = 64;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
c51_loss_kernel(int bs, int A, float v_min, float v_max, float dz,
                float inv_bs, const float* __restrict__ logits,
                const float* __restrict__ p_target,
                const float* __restrict__ ret,
                const float* __restrict__ disc,
                const float* __restrict__ weight,
                float* __restrict__ loss, float* __restrict__ dlogits) {
  __shared__ float s_pos[WARPS][MAX_ATOMS];
  __shared__ float s_p[WARPS][MAX_ATOMS];
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + wi;
  if (row >= bs) return;   // whole warps leave together
  const float g = ret[row], d = disc[row];
  const float* x_row = logits + (size_t)row * A;
  for (int j = lane; j < A; j += 32) {
    const float z = __fadd_rn(__fmul_rn((float)j, dz), v_min);
    const float tz = fminf(fmaxf(__fadd_rn(__fmul_rn(d, z), g), v_min),
                           v_max);
    s_pos[wi][j] = __fdiv_rn(__fsub_rn(tz, v_min), dz);
    s_p[wi][j] = p_target[(size_t)row * A + j];
  }
  __syncwarp();
  float m[2], x[2];
  bool valid[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = lane + 32 * k;
    valid[k] = i < A;
    float acc = 0.f;
    if (valid[k]) {
      const float fi = (float)i;
      for (int j = 0; j < A; ++j) {
        const float t = __fsub_rn(1.f, fabsf(__fsub_rn(s_pos[wi][j], fi)));
        acc = __fadd_rn(acc, __fmul_rn(s_p[wi][j], fmaxf(t, 0.f)));
      }
    }
    m[k] = acc;
    x[k] = valid[k] ? x_row[i] : -INFINITY;
  }
  const float mx = warp_max(fmaxf(x[0], x[1]));
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (valid[k]) se += expf(x[k] - mx);
  const float lse = mx + logf(warp_sum(se));
  const float scale = __fmul_rn(weight[row], inv_bs);
  float l = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!valid[k]) continue;
    const float lp = x[k] - lse;
    l -= m[k] * lp;
    dlogits[(size_t)row * A + lane + 32 * k] =
        __fmul_rn(scale, __fsub_rn(expf(lp), m[k]));
  }
  l = warp_sum(l);
  if (lane == 0) loss[row] = l;
}

}  // namespace

extern "C" {

// One launch over the batch on `stream`. Shapes (checked by the Python
// wrapper): logits, p_target, dlogits (bs, A); ret, disc, weight, loss
// (bs). A <= 64. Returns the cudaError_t of the launch.
int c51_loss_launch(int bs, int A, float v_min, float v_max, float dz,
                    float inv_bs, const float* logits, const float* p_target,
                    const float* ret, const float* disc, const float* weight,
                    float* loss, float* dlogits, cudaStream_t stream) {
  if (bs <= 0 || A < 2 || A > MAX_ATOMS) return (int)cudaErrorInvalidValue;
  const int blocks = (bs + WARPS - 1) / WARPS;
  c51_loss_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      bs, A, v_min, v_max, dz, inv_bs, logits, p_target, ret, disc, weight,
      loss, dlogits);
  return (int)cudaGetLastError();
}

const char* pp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
