// Pieces shared by the windowed accumulations (sorted_accum.cu and the
// fused BPR steps of bpr_fused.cu): a warp's register run-sum of one output
// row flushed into the CTA's shared-memory accumulator, and the binary
// search for a row in an ascending row stream.  Internal linkage, like
// reduce.cuh.
#pragma once

#include <cuda_runtime.h>

namespace cymf {
namespace {

constexpr int ACC_LANES = 128;

// Adds this lane's four columns [c0, c0 + 4) of `run` into row `rel` of the
// (rows, stride) float32 accumulator `acc` in shared memory (128 lanes a
// row unless said).  Warps whose parts of a stream meet inside one row's
// run add to the same address, hence the atomics.
__device__ __forceinline__ void flush_run(float* acc, int rel, int c0,
                                          const float4& run,
                                          int stride = ACC_LANES) {
  float* dst = acc + rel * stride + c0;
  atomicAdd(dst + 0, run.x);
  atomicAdd(dst + 1, run.y);
  atomicAdd(dst + 2, run.z);
  atomicAdd(dst + 3, run.w);
}

// The first index in [lo, hi) whose row is >= key (hi if none), over
// ascending rows.
__device__ __forceinline__ int lower_bound(const int* __restrict__ rows,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

}  // namespace
}  // namespace cymf
