// GloVe / RelMF sample phase for the packed pipeline, on Hopper (sm_90a).
//
// Replaces cymf_tpu/ops/glove_epoch.py::glove_sample_phase
// (_glove_sample_kernel): per sample b, from the decorated packed central
// row Du[b] (payload lanes [0, cb), lanes [cb, cb+s) = mask * onehot(slot))
// and the decorated logical context row Dx[b] (payload lanes [0, Kp), lane
// Kp = -log(count) or -theta, lane Kp+1 = the weight f):
//   zc   = the central row's Kp-wide slot, moved to lanes [0, Kp)
//   zx   = Dx on lanes [0, Kp)
//   diff = zc . zx + Dx[Kp],  m = sum of Du's lanes >= cb (the live mask)
//   qv   = Dx[Kp+1] * diff * m,  loss += 0.5 qv diff
//   SW   = qv zx placed in the slot's lanes, lanes >= cb copied from Du
//   Q    = qv zc on lanes < Kp, m on lane Kp
// and the step's loss sum, reduced in a fixed order (deterministic).  A
// dead row (all count lanes zero: padding, masked samples) has m = 0, so
// its SW is Du's zero count lanes and its Q is zero.
//
// Bound on the H100: memory.  At the main-path shape (B = 131,072 rows of
// 128 f32) a step reads 2 x 64 MiB and writes 2 x 64 MiB with ~10 flops per
// element, far below the card's ~20 flop/byte balance point.
//
// Design: as bpr_sample.cu.  One warp per sample row, each of the 32 lanes
// holding 4 of the 128 columns, loaded and stored as one float4.  The slot
// extraction and placement, which the TPU kernel does with lane rotations
// (pltpu.roll), index a per-warp shared-memory copy of the row directly;
// the row sums are warp shuffles.  Each block writes one loss partial, and
// a second one-block kernel (reduce.cuh) sums the partials in a fixed
// order.

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

using cymf::sum_partials_kernel;
using cymf::SUM_THREADS;
using cymf::warp_sum;

constexpr int LANES = 128;
constexpr int WARPS = 8;
constexpr int SAMPLES_PER_WARP = 8;
constexpr int SAMPLES_PER_BLOCK = WARPS * SAMPLES_PER_WARP;

__global__ void __launch_bounds__(WARPS * 32)
glove_sample_kernel(const float* __restrict__ du, const float* __restrict__ dx,
                    float* __restrict__ sw, float* __restrict__ q,
                    float* __restrict__ partials, int B, int Kp, int s,
                    int cb) {
  __shared__ float row[WARPS][LANES];   // the warp's decorated central row
  __shared__ float vals[WARPS][LANES];  // qv * zx
  __shared__ float warp_loss[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = lane * 4;
  float* r = row[warp];
  float* v = vals[warp];
  float loss_acc = 0.f;
  const int first = blockIdx.x * SAMPLES_PER_BLOCK + warp * SAMPLES_PER_WARP;

  for (int n = 0; n < SAMPLES_PER_WARP; ++n) {
    const int b = first + n;
    if (b >= B) break;  // uniform across the warp
    const size_t off = static_cast<size_t>(b) * LANES + c0;
    const float4 u4 = *reinterpret_cast<const float4*>(du + off);
    const float4 x4 = *reinterpret_cast<const float4*>(dx + off);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    *reinterpret_cast<float4*>(r + c0) = u4;
    __syncwarp();

    float zc[4], zx[4];
    float dot = 0.f, neglog = 0.f, f = 0.f, m = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = c0 + k;
      float z = 0.f;
      if (l < Kp) {  // zc[l] = sum_c Du[cb + c] * Du[l + c Kp]
        z = r[cb] * r[l];
        for (int c = 1; c < s; ++c) z += r[cb + c] * r[l + c * Kp];
      }
      zc[k] = z;
      zx[k] = l < Kp ? x[k] : 0.f;
      dot += z * zx[k];
      if (l == Kp) neglog = x[k];
      if (l == Kp + 1) f = x[k];
      if (l >= cb) m += u[k];  // the decoration lanes sum to the mask
    }
    dot = warp_sum(dot);
    neglog = warp_sum(neglog);  // one lane holds it: the sum is exact
    f = warp_sum(f);
    m = warp_sum(m);
    const float diff = dot + neglog;
    const float qv = f * diff * m;
    loss_acc += 0.5f * qv * diff;

#pragma unroll
    for (int k = 0; k < 4; ++k) v[c0 + k] = qv * zx[k];
    __syncwarp();

    float o[4], qo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = c0 + k;
      float acc = l >= cb ? u[k] : 0.f;
      // slot c's lanes receive vals rotated right by c Kp (lane-wise as
      // the TPU kernel's roll, wrapping at 128)
      for (int c = 0; c < s; ++c)
        acc += r[cb + c] * v[(l - c * Kp) & (LANES - 1)];
      o[k] = acc;
      qo[k] = qv * zc[k] + (l == Kp ? m : 0.f);
    }
    *reinterpret_cast<float4*>(sw + off) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(q + off) =
        make_float4(qo[0], qo[1], qo[2], qo[3]);
    __syncwarp();  // row/vals are rewritten by the next sample
  }
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += warp_loss[w];
    partials[blockIdx.x] = t;
  }
}

}  // namespace

// Number of loss partials (one per block) the caller allocates for B rows.
extern "C" int cymf_glove_sample_blocks(int B) {
  return (B + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK;
}

extern "C" int cymf_glove_sample_phase(const float* du, const float* dx,
                                       float* sw, float* q, float* partials,
                                       float* loss, int B, int Kp, int s,
                                       int cb, cudaStream_t stream) {
  const int blocks = cymf_glove_sample_blocks(B);
  if (blocks > 0)
    glove_sample_kernel<<<blocks, WARPS * 32, 0, stream>>>(
        du, dx, sw, q, partials, B, Kp, s, cb);
  sum_partials_kernel<<<1, SUM_THREADS, 0, stream>>>(partials, blocks, loss);
  return static_cast<int>(cudaGetLastError());
}
