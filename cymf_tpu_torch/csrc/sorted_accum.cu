// Windowed sorted accumulation (scatter-add over row-sorted streams) on
// Hopper (sm_90a).
//
// Replaces cymf_tpu/ops/sorted_accum.py::sorted_accum (_accum_kernel) and
// ::sorted_accum_dual (_accum_kernel_dual): out[rows[b]] += g[b] for an
// ascending row stream, where the host supplies, per window of `wrows`
// output rows, the sample range [start, start + count) that can hit it.
// Rows outside the window (the range's aligned-down head, padding
// sentinels >= r_pad) are skipped.  The dual form walks two streams into
// one window and negates the first stream's lanes < neg_lanes, which gives
// the packed BPR step's H-side operand  scatter(j, gj) - scatter(i, gi)
// with the count lane adding.
//
// Bound on the H100: memory.  Each sample row (128 f32, 512 bytes) is read
// once and added into shared memory; each output row is written once.  At
// the main-path shape one W-side call reads 64 MiB plus 0.5 MiB of row ids
// and writes 11 MiB; the H-side call reads twice that and writes 13 MiB.
//
// Design: the TPU kernel turns the scatter into one-hot MXU matmuls per
// window.  Here a window's rows are split into slices of at most MAX_SLICE
// = 256 rows (one slice for wrows <= 256, two at the JAX default wrows =
// 512), one CTA a slice, which keeps its rows x 128 f32 accumulator in
// dynamic shared memory (128 KiB at 256 rows).  Every CTA of a window walks
// the window's whole range and keeps only the rows of its own slice, so no
// output row is written twice.  Each warp walks a contiguous part of the
// range: lanes hold 4 columns each
// (one float4 per sample row, coalesced), a register run-sum grows while
// the row id stays the same, and a row change flushes it into shared memory
// with atomicAdd.  Sorted rows make runs long, so few atomics are issued,
// and only warps whose slices meet at a run boundary ever touch the same
// address.  The CTA then writes its whole window, zeros included, so the
// output needs no memset.  Sums come in another order than a sequential
// scatter: equal to float32 round-off.

#include <cuda_runtime.h>

#include "accum.cuh"

namespace {

using cymf::flush_run;

constexpr int LANES = 128;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLICE = 256;  // rows a CTA accumulates: 128 KiB of f32
constexpr unsigned FULL = 0xffffffffu;

struct Stream {
  const int* rows;
  const float* g;
  const int* starts;
  const int* counts;
  int n;          // samples in the stream
  int neg_lanes;  // lanes [0, neg_lanes) are negated
};

// Adds the rows of window w's range that lie in [r0, r0 + nrows) into acc.
__device__ void walk(const Stream& st, float* acc, int w, int r0,
                     int nrows) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = lane * 4;
  const int start = st.starts[w];
  const int lo = max(start, 0);
  const int hi = min(start + st.counts[w], st.n);
  if (hi <= lo) return;
  const int per = (hi - lo + WARPS - 1) / WARPS;
  const int a = lo + warp * per;
  const int e = min(a + per, hi);
  float4 sign;
  sign.x = c0 + 0 < st.neg_lanes ? -1.f : 1.f;
  sign.y = c0 + 1 < st.neg_lanes ? -1.f : 1.f;
  sign.z = c0 + 2 < st.neg_lanes ? -1.f : 1.f;
  sign.w = c0 + 3 < st.neg_lanes ? -1.f : 1.f;

  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  int cur = -1;
  for (int b0 = a; b0 < e; b0 += 32) {
    const int cnt = min(32, e - b0);
    const int mine = lane < cnt ? st.rows[b0 + lane] : -1;
    for (int t = 0; t < cnt; ++t) {
      const int rel = __shfl_sync(FULL, mine, t) - r0;
      if (static_cast<unsigned>(rel) >= static_cast<unsigned>(nrows))
        continue;  // another slice's row or a padding sentinel
      if (rel != cur) {
        if (cur >= 0) flush_run(acc, cur, c0, run);
        run = make_float4(0.f, 0.f, 0.f, 0.f);
        cur = rel;
      }
      const float4 v = *reinterpret_cast<const float4*>(
          st.g + static_cast<size_t>(b0 + t) * LANES + c0);
      run.x += sign.x * v.x;
      run.y += sign.y * v.y;
      run.z += sign.z * v.z;
      run.w += sign.w * v.w;
    }
  }
  if (cur >= 0) flush_run(acc, cur, c0, run);
}

__global__ void __launch_bounds__(THREADS)
accum_kernel(Stream s1, Stream s2, int two, float* __restrict__ out,
             int wrows, int nslices, int slice) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int w = blockIdx.x / nslices;
  const int k = blockIdx.x % nslices;
  const int r0 = w * wrows + k * slice;
  const int nrows = min(slice, wrows - k * slice);
  const int n4 = nrows * LANES / 4;
  for (int t = threadIdx.x; t < n4; t += THREADS)
    acc4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  walk(s1, acc, w, r0, nrows);
  if (two) walk(s2, acc, w, r0, nrows);
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(r0) * LANES);
  for (int t = threadIdx.x; t < n4; t += THREADS) o[t] = acc4[t];
}

int launch(const Stream& s1, const Stream& s2, int two, float* out,
           int r_pad, int wrows, cudaStream_t stream) {
  // the window's rows in nslices near-equal slices of at most MAX_SLICE
  const int nslices = (wrows + MAX_SLICE - 1) / MAX_SLICE;
  const int slice = (wrows + nslices - 1) / nslices;
  const int smem = slice * LANES * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = r_pad / wrows;
  if (windows > 0)
    accum_kernel<<<windows * nslices, THREADS, smem, stream>>>(
        s1, s2, two, out, wrows, nslices, slice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cymf_sorted_accum(const int* rows, const float* g,
                                 const int* starts, const int* counts,
                                 float* out, int n, int r_pad, int wrows,
                                 cudaStream_t stream) {
  const Stream s1{rows, g, starts, counts, n, 0};
  return launch(s1, s1, 0, out, r_pad, wrows, stream);
}

extern "C" int cymf_sorted_accum_dual(
    const int* rows_i, const float* g_i, const int* starts_i,
    const int* counts_i, const int* rows_j, const float* g_j,
    const int* starts_j, const int* counts_j, float* out, int n_i, int n_j,
    int r_pad, int wrows, int neg_lanes, cudaStream_t stream) {
  const Stream si{rows_i, g_i, starts_i, counts_i, n_i, neg_lanes};
  const Stream sj{rows_j, g_j, starts_j, counts_j, n_j, 0};
  return launch(si, sj, 1, out, r_pad, wrows, stream);
}

extern "C" const char* cymf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
