// Reductions shared by the sample kernels: a warp sum and the one-block
// kernel that sums per-block loss partials in a fixed order, so a step's
// loss is the same from run to run.  Internal linkage: each kernel source
// that includes this gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace cymf {
namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SUM_THREADS = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
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
}  // namespace cymf
