// Batched Cholesky factor and its inverse, on Hopper (sm_90a).
//
// Replaces cymf_tpu/ops/chol_kernel.py::chol_inv_batched (_chol_inv_kernel):
// for each of C symmetric positive definite B x B float32 matrices A
// (B <= 128),
//   L    = the lower Cholesky factor, A = L L^T, exact zeros above the
//          diagonal;
//   Linv = L^{-1}, lower triangular, by forward substitution.
// These are the diagonal blocks of the blocked ALS solve
// (cymf_tpu_torch/ops/als.py::_solve_spd_blocked).  Only A's lower triangle
// is read.  A matrix with a pivot that is not > 0 (not SPD, or NaN) gets NaN
// in every entry of both outputs, as XLA's Cholesky gives.
//
// Bound on the H100: neither bytes nor flops.  At the main-path shape
// (C = 2048, B = 64) it reads 32 MiB and writes 64 MiB, about 29 us at
// 3.35 TB/s, and does ~2 B^3 / 3 flops a matrix.  Its pace is set by the
// B-long chain of dependent column steps, each ending in a barrier.
//
// Design: one CTA of 256 threads per matrix.  A is read in place, with the
// caller's batch and row strides (a diagonal block of a larger matrix is a
// strided view), into shared memory with a padded row stride B + 1, so that
// reading a column is free of bank conflicts.  A second B x (B + 1) buffer
// starts as the identity and becomes Linv.  Column step j, right-looking:
//   (a) every thread reads the pivot d = A[j][j] and s = rsqrt(d); column j
//       below the diagonal is scaled by s (it is now L[:, j]) and row j of
//       Linv by s (L[j][j] = d s);
//   (b) each row i > j takes a rank-1 update over its columns c <= i:
//       c <= j:  Linv[i][c] -= L[i][j] Linv[j][c]  (forward substitution of
//                L Z = I, one row of Z final per step),
//       c >  j:  A[i][c]    -= L[i][j] L[c][j]     (the trailing update).
//       The diagonal L[j][j] is written here, where no thread reads it.
// Warp w owns the rows i = w mod 8 and its lanes walk a row's columns, so
// both factors come out of one loop with two barriers a column.  Both
// outputs are written coalesced, row by row.  At B = 128 the two buffers
// take 129 KiB of dynamic shared memory.
//
// A later PR could drop the barriers: a warp per matrix (or a few matrices
// per CTA), with the columns in registers and the pivot column passed by
// shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
chol_inv_kernel(const float* __restrict__ a, long long a_batch,
                long long a_ld, float* __restrict__ l,
                float* __restrict__ linv, int B) {
  extern __shared__ float smem[];
  const int S = B + 1;
  float* m = smem;          // A, becoming L in its lower triangle
  float* z = smem + B * S;  // the identity, becoming L^{-1}
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* src = a + blockIdx.x * a_batch;
  for (int e = tid; e < B * B; e += THREADS) {
    const int r = e / B, c = e - r * B;
    m[r * S + c] = src[r * a_ld + c];
    z[r * S + c] = r == c ? 1.f : 0.f;
  }
  __syncthreads();

  bool bad = false;  // the same in every thread: all read the same pivots
  for (int j = 0; j < B; ++j) {
    const float d = m[j * S + j];
    const float s = rsqrtf(d);
    bad |= !(d > 0.f);
    if (tid < B) {
      if (tid > j) m[tid * S + j] *= s;
      if (tid <= j) z[j * S + tid] *= s;
    }
    __syncthreads();
    for (int i = warp; i < B; i += WARPS) {
      if (i <= j) continue;
      const float lij = m[i * S + j];
      for (int c = lane; c <= i; c += 32) {
        const bool left = c <= j;
        const float v = left ? z[j * S + c] : m[c * S + j];
        float* dst = (left ? z : m) + i * S + c;
        *dst -= lij * v;
      }
    }
    if (tid == 0) m[j * S + j] = d * s;
    __syncthreads();
  }

  const float nan = __int_as_float(0x7fffffff);
  const size_t off = static_cast<size_t>(blockIdx.x) * B * B;
  for (int e = tid; e < B * B; e += THREADS) {
    const int r = e / B, c = e - r * B;
    const bool lower = c <= r;
    l[off + e] = bad ? nan : (lower ? m[r * S + c] : 0.f);
    linv[off + e] = bad ? nan : (lower ? z[r * S + c] : 0.f);
  }
}

}  // namespace

// a: C matrices of B x B floats, matrix c at a + c * a_batch, row r at
// + r * a_ld, unit column stride.  l, linv: contiguous (C, B, B) outputs.
extern "C" int cymf_chol_inv_batched(const float* a, long long a_batch,
                                     long long a_ld, float* l, float* linv,
                                     int C, int B, cudaStream_t stream) {
  const int smem = 2 * B * (B + 1) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 0)
    chol_inv_kernel<<<C, THREADS, smem, stream>>>(a, a_batch, a_ld, l, linv,
                                                  B);
  return static_cast<int>(cudaGetLastError());
}
