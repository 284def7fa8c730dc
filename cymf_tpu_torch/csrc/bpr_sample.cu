// Fused BPR sample phase for the packed v4 pipeline, on Hopper (sm_90a).
//
// Replaces cymf_tpu/ops/fused_sample.py::bpr_sample_phase
// (_bpr_sample_kernel): per sample b, from the decorated packed W row Du[b]
// (payload lanes [0, cb), lanes [cb, cb+s) = mask * onehot(slot)) and the
// logical item rows Di[b], Dj[b] (payload lanes [0, K)):
//   wu   = the user's K-wide slot, moved to lanes [0, K)
//   x    = wu . (hi - hj),  sig = sigmoid(-x)
//   loss = (-log sigmoid(x) + wd (|wu|^2 + |hi|^2 + |hj|^2)) * mask
//   SW   = sig (hi - hj) placed in the slot's lanes, lanes >= cb copied
//   Q    = sig wu on lanes < K, mask on lane K
// and the step's loss sum, reduced in a fixed order (deterministic).
//
// Bound on the H100: memory.  At the main-path shape (B = 131,072 rows of
// 128 f32) a step reads 3 x 64 MiB and writes 2 x 64 MiB with ~10 flops per
// element, far below the card's ~20 flop/byte balance point.
//
// Design: one warp per sample row, each of the 32 lanes holding 4 of the
// 128 columns, loaded and stored as one float4 (512 coalesced bytes per row
// per tensor).  The slot extraction and placement, which the TPU kernel does
// with lane rotations, read the row from a per-warp shared-memory copy; the
// three row sums are warp shuffles.  Each block writes one loss partial, and
// a second one-block kernel sums the partials in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int WARPS = 8;
constexpr int SAMPLES_PER_WARP = 8;
constexpr int SAMPLES_PER_BLOCK = WARPS * SAMPLES_PER_WARP;
constexpr int SUM_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
bpr_sample_kernel(const float* __restrict__ du, const float* __restrict__ di,
                  const float* __restrict__ dj, float* __restrict__ sw,
                  float* __restrict__ q, float* __restrict__ partials, int B,
                  int K, int s, int cb, float wd) {
  __shared__ float row[WARPS][LANES];   // the warp's decorated W row
  __shared__ float vals[WARPS][LANES];  // sig * (hi - hj)
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
    const float4 i4 = *reinterpret_cast<const float4*>(di + off);
    const float4 j4 = *reinterpret_cast<const float4*>(dj + off);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    const float hi[4] = {i4.x, i4.y, i4.z, i4.w};
    const float hj[4] = {j4.x, j4.y, j4.z, j4.w};
    *reinterpret_cast<float4*>(r + c0) = u4;
    __syncwarp();

    float wu[4], diff[4];
    float x = 0.f, l2 = 0.f, m = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = c0 + k;
      float w = 0.f;
      if (l < K) {  // wu[l] = sum_c Du[cb + c] * Du[l + c K]
        w = r[cb] * r[l];
        for (int c = 1; c < s; ++c) w += r[cb + c] * r[l + c * K];
      }
      wu[k] = w;
      diff[k] = hi[k] - hj[k];
      x += w * diff[k];
      l2 += w * w + hi[k] * hi[k] + hj[k] * hj[k];
      if (l >= cb) m += u[k];  // the decoration lanes sum to the mask
    }
    x = warp_sum(x);
    l2 = warp_sum(l2);
    m = warp_sum(m);
    const float sig = 1.f / (1.f + expf(x));
    // -log sigmoid(x) = softplus(-x), in its overflow-free form
    const float nls = fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x)));
    loss_acc += (nls + wd * l2) * m;

#pragma unroll
    for (int k = 0; k < 4; ++k) v[c0 + k] = sig * diff[k];
    __syncwarp();

    float o[4], qo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = c0 + k;
      float acc = l >= cb ? u[k] : 0.f;
      // slot c's lanes receive vals rotated right by c K (lane-wise as the
      // TPU kernel's roll, wrapping at 128)
      for (int c = 0; c < s; ++c)
        acc += r[cb + c] * v[(l - c * K) & (LANES - 1)];
      o[k] = acc;
      qo[k] = sig * wu[k] + (l == K ? m : 0.f);
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

__global__ void __launch_bounds__(SUM_THREADS)
sum_partials_kernel(const float* __restrict__ partials, int n,
                    float* __restrict__ out) {
  __shared__ float sm[SUM_THREADS];
  float t = 0.f;
  for (int i = threadIdx.x; i < n; i += SUM_THREADS) t += partials[i];
  sm[threadIdx.x] = t;
  __syncthreads();
  for (int w = SUM_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sm[threadIdx.x] += sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = sm[0];
}

}  // namespace

// Number of loss partials (one per block) the caller allocates for B rows.
extern "C" int cymf_bpr_sample_blocks(int B) {
  return (B + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK;
}

extern "C" int cymf_bpr_sample_phase(const float* du, const float* di,
                                     const float* dj, float* sw, float* q,
                                     float* partials, float* loss, int B,
                                     int K, int s, int cb, float wd,
                                     cudaStream_t stream) {
  const int blocks = cymf_bpr_sample_blocks(B);
  if (blocks > 0)
    bpr_sample_kernel<<<blocks, WARPS * 32, 0, stream>>>(
        du, di, dj, sw, q, partials, B, K, s, cb, wd);
  sum_partials_kernel<<<1, SUM_THREADS, 0, stream>>>(partials, blocks, loss);
  return static_cast<int>(cudaGetLastError());
}
