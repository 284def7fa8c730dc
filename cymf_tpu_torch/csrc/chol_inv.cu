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
// is used (a float4 load that straddles the diagonal reads up to three
// entries above it).  A matrix with a pivot that is not > 0 (not SPD, or
// NaN) gets NaN in every entry of both outputs, as XLA's Cholesky gives.
//
// Bound on the H100: neither bytes nor flops.  At the main-path shape
// (C = 2048, B = 64) it reads 32 MiB and writes 64 MiB, about 29 us at
// 3.35 TB/s, and does ~2 B^3 / 3 flops a matrix.  Its pace is set by the
// B-long chain of dependent column steps, each ending in a barrier.
//
// The first form of this kernel gave a 256-thread CTA each matrix, both
// triangles in shared memory: every update a shared read-modify-write and
// two CTA-wide barriers a column step.  At B = 64 that took 0.41 ms on the
// H100, at B = 128 (132 KiB of shared memory, one CTA an SM) 4.6 ms, slower
// than cholesky_ex + solve_triangular's 2.6.
//
// Design: one array of registers a thread.  A matrix of an instantiated
// size N (64 or 128) gets N H threads (H = 1 at N = 64, H = 2 at N = 128),
// in H parts of whole warps; thread (h, i) holds R = N / H entries of one
// array w as fully unrolled registers: row i of A until step i (its entries
// past column i are never read), then column i of Linv (whose entries above
// row i are zero until then, so they need no register before).  A smaller
// matrix is padded with the identity, diag(A, I), which factors to
// diag(L, I); the steps j >= B touch only the identity block, so the loop
// stops at B.  So two instantiations take every B <= 128.
//
// Column step j, right-looking, with one barrier:
//   publish  row i >= j writes A[i][j] into a shared column vector at i - j
//            (the pivot row also 1/sqrt of it), row i < j its unscaled
//            Linv[j][i], part h its first register for part h - 1;
//   barrier  a named barrier (bar.sync) over the matrix's warps;
//   update   every thread reads the pivot d and s = 1/sqrt(d); L[i][j] =
//            A[i][j] s (i > j; d s on the diagonal) goes to a shared
//            staging tile; Linv[j][i] = Z[j][i] s (forward substitution of
//            L Z = I by columns; s at i = j, zero above) is final and goes
//            straight to device memory, row j written by the whole matrix,
//            coalesced; then the thread's array takes the column vector:
//            the trailing update A[i][c] -= L[i][j] L[c][j] while i > j,
//            the substitution Z[c][i] -= L[c][j] Linv[j][i] from i = j on.
// The array is held shifted: register k holds index j + k, so the pivot is
// always register 0 and the update moves register k + 1 into k (no
// register is indexed at run time).  Groups of four registers past B are
// skipped, which halves a step's work on average.  What a step publishes is
// ping-ponged between two buffers, so a thread that runs ahead to step
// j + 1 cannot overwrite what a slower one still reads at j: one barrier a
// step suffices.  Shared memory carries one vector a step instead of every
// update.
// What sets the pace (measured on the H100): latency, so registers: two
// arrays a thread (a row of A and a column of Linv, ~155 registers, 6
// matrices an SM) took 0.12 ms at (2048, 64, 64), one array (96 registers,
// 10 matrices an SM) 0.085.  Two matrices share a CTA at N = 64 (each on
// its own named barrier); one measured slower, four the same.  A is staged
// through the tile, read in place with the caller's batch and row strides
// (a diagonal block of a larger matrix is a strided view), float4 rows
// when they are aligned; L leaves through it, row by row, coalesced.  A
// failed matrix's Linv, already written, is overwritten with NaN by the
// threads that wrote it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Floats of shared memory a matrix of size N split H ways takes: what a
// step publishes (two buffers: the column, Linv's row, and each part's
// first register) and the (N, N + 1) staging tile.
__host__ __device__ constexpr int mat_floats(int N, int H) {
  return 2 * (2 + H) * N + N * (N + 1);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int N, int H, int MATS>
__global__ void __launch_bounds__(MATS * N * H)
chol_regs_kernel(const float* __restrict__ a, long long a_batch,
                 long long a_ld, float* __restrict__ l,
                 float* __restrict__ linv, int C, int B, bool vec4) {
  constexpr int T = N * H;  // threads a matrix
  constexpr int R = N / H;  // registers a thread holds
  constexpr int S = N + 1;  // odd: a column's entries in distinct banks
  constexpr int V = (2 + H) * N;  // floats a step publishes
  extern __shared__ float4 smem4[];
  const int m = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const int h = t / N;  // the part: whole warps
  const int i = t % N;  // the row of A, then the column of Linv
  const int c = blockIdx.x * MATS + m;
  if (c >= C) return;  // the matrix's threads together: its barrier idles
  float* base = reinterpret_cast<float*>(smem4) + m * mat_floats(N, H);
  float* pub = base;         // [2][V]: what step j publishes
  float* st = base + 2 * V;  // [N][S]: A in, L out
  const int bar = m + 1;     // 0 is __syncthreads'
  const size_t off = static_cast<size_t>(c) * B * B;

  // diag(A, I): A's lower triangle, zeros above it, the identity past B
  const float* src = a + c * a_batch;
  if (vec4) {  // rows of whole, aligned float4s: all loads in flight at once
#pragma unroll
    for (int e = t; e < N * N / 4; e += T) {
      const int r = e / (N / 4), q = 4 * (e % (N / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < B && q <= r)
        x = __ldg(reinterpret_cast<const float4*>(src + r * a_ld + q));
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        st[r * S + q + k] = r < B && q + k <= r ? v[k]
                                                : (r == q + k ? 1.f : 0.f);
    }
  } else {
#pragma unroll 8
    for (int e = t; e < N * N; e += T) {
      const int r = e / N, q = e % N;
      st[r * S + q] = r < B && q <= r ? __ldg(src + r * a_ld + q)
                                      : (r == q ? 1.f : 0.f);
    }
  }
  named_barrier(bar, T);
  // w[k]: index j + h R + k of row i of A while j <= i (entries past
  // column i are never read), of column i of Linv once j > i (entries
  // above row i are zero and need no register before then)
  float w[R];
#pragma unroll
  for (int k = 0; k < R; ++k) w[k] = st[i * S + h * R + k];
  named_barrier(bar, T);  // the tile is free for L

  bool bad = false;  // the same in every thread: all read the same pivots
  for (int j = 0; j < B; ++j) {
    float* cv = pub + (j & 1) * V;  // A[j + k][j] at k
    float* zr = cv + N;             // Linv[j][i] (unscaled) at i < j
    float* fw = zr + N;             // [H][N]: part h's first register
                                    // (part 0's slot: 1/sqrt of the pivot)
    if (h == 0) {
      if (i >= j) cv[i - j] = w[0];
      else zr[i] = w[0];
      if (i == j) fw[0] = rsqrtf(w[0]);  // the pivot's scale
    } else {
      fw[h * N + i] = w[0];
    }
    named_barrier(bar, T);
    const float* cvh = cv + h * R;
    const float4 x0 = *reinterpret_cast<const float4*>(cvh);
    const float d = cv[0];
    const float s = fw[0];
    bad |= !(d > 0.f);
    // row i of L at column j, and row j of Linv at column i, both final
    const float wi = h == 0 ? w[0] : (i >= j ? cv[i - j] : zr[i]);
    const float lij = i > j ? wi * s : 0.f;
    const float zj = i < j ? wi * s : (i == j ? s : 0.f);
    if (h == 0 && i >= j) st[i * S + j] = i == j ? d * s : lij;
    if (h == 0 && i < B) linv[off + static_cast<size_t>(j) * B + i] = zj;
    // the update, register k now index j + 1 + h R + k:
    //   i > j:  A[i][c] -= L[i][j] L[c][j] = (L[i][j] s) A[c][j]
    //   i <= j: Linv[c][i] -= L[c][j] Linv[j][i] = (Linv[j][i] s) A[c][j],
    //           from zero at i = j (the column starts there)
    const float mult = i > j ? lij * s : zj * s;
    const float keep = i == j ? 0.f : 1.f;
    // those past B are never read again: a group of four past them is
    // skipped
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      if (k + h * R >= B - j) break;
      const float4 x = k == 0 ? x0 : *reinterpret_cast<const float4*>(cvh + k);
      if (k > 0) w[k - 1] = w[k] * keep - mult * x.x;
      w[k] = w[k + 1] * keep - mult * x.y;
      w[k + 1] = w[k + 2] * keep - mult * x.z;
      w[k + 2] = w[k + 3] * keep - mult * x.w;
    }
    // the last register: the next part's first, none past N
    w[R - 1] = h + 1 < H ? fw[(h + 1) * N + i] * keep - mult * cvh[R] : 0.f;
  }

  const float nan = __int_as_float(0x7fffffff);
  if (bad && h == 0 && i < B)  // the Linv entries this thread wrote
    for (int j = 0; j < B; ++j)
      linv[off + static_cast<size_t>(j) * B + i] = nan;
  named_barrier(bar, T);
  for (int r = 0; r < B; ++r)  // row by row, coalesced
    for (int q = t; q < B; q += T)
      l[off + static_cast<size_t>(r) * B + q] =
          bad ? nan : (q <= r ? st[r * S + q] : 0.f);
}

template <int N, int H, int MATS>
int launch_regs(const float* a, long long a_batch, long long a_ld, float* l,
                float* linv, int C, int B, cudaStream_t stream) {
  const int smem = MATS * mat_floats(N, H) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chol_regs_kernel<N, H, MATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float4 rows: B a multiple of 4 (no load past a row), every row aligned
  const bool vec4 = B % 4 == 0 && a_batch % 4 == 0 && a_ld % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (C > 0)
    chol_regs_kernel<N, H, MATS><<<(C + MATS - 1) / MATS, MATS * N * H, smem,
                                   stream>>>(a, a_batch, a_ld, l, linv, C, B,
                                             vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: C matrices of B x B floats, matrix c at a + c * a_batch, row r at
// + r * a_ld, unit column stride.  l, linv: contiguous (C, B, B) outputs.
extern "C" int cymf_chol_inv_batched(const float* a, long long a_batch,
                                     long long a_ld, float* l, float* linv,
                                     int C, int B, cudaStream_t stream) {
  if (B < 1 || B > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 64)
    return launch_regs<64, 1, 2>(a, a_batch, a_ld, l, linv, C, B, stream);
  return launch_regs<128, 2, 1>(a, a_batch, a_ld, l, linv, C, B, stream);
}
