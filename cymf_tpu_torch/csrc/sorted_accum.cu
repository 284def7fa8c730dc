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
// Two forms.  The packed pipelines' form takes 128-lane rows (accum_kernel).
// The wide form (accum_wide_kernel, the wide BPR engine for K >= 128) takes
// rows of any multiple of 128 lanes and, with count_lanes, appends a
// 128-lane granule whose lane 0 holds each output row's count of samples
// (the caller routes dead samples to a sentinel row >= r_pad, so a match is
// a live sample) and whose other lanes are zero: a (r_pad, width + 128)
// output.  The dual form's counts add both streams.
//
// Bound on the H100: memory.  Each sample row (width f32) is read once and
// added into shared memory; each output row is written once.  At the
// packed main-path shape one W-side call reads 64 MiB plus 0.5 MiB of row
// ids and writes 11 MiB; the H-side call reads twice that and writes 13
// MiB.  At the wide engine's ML-20M d=256 step the W side reads 128 MiB and
// writes 203 MiB, the H side reads 256 MiB and writes 40 MiB.
//
// Design: the TPU kernel turns the scatter into one-hot MXU matmuls per
// window.  Here a window's rows are split into near-equal slices, one CTA
// a slice, which keeps its rows x width f32 accumulator (and, with counts,
// one float count a row) in dynamic shared memory.  A slice holds at most
// MAX_SLICE = 256 rows and at most what fits the 227 KiB a CTA may opt in
// to: one slice for wrows <= 256 at width 128, two at the JAX default
// wrows = 512; at width 256 with counts 226 rows, so 3 slices of 171 rows.
// Every CTA of a window walks the window's whole range and keeps only the
// rows of its own slice, so no output row is written twice.  Each warp
// walks a contiguous part of the range: lane t holds columns [4t, 4t + 4)
// of each 128-lane granule (one float4 per granule per sample row,
// coalesced), register run-sums grow while the row id stays the same, and
// a row change flushes them into shared memory with atomicAdd, the run's
// length into the row's count.  Sorted rows make runs long, so few
// atomics are issued, and only warps whose parts meet at a run boundary
// ever touch the same address.  A walk keeps at most MAX_GRANULES granules
// in registers; wider rows walk the range once per group of granules (the
// counts on the first).  The CTA then writes its whole slice, zeros and
// the count granule included, so the output needs no memset.  Sums come
// in another order than a sequential scatter: equal to float32 round-off;
// counts are exact below 2^24.

#include <cuda_runtime.h>

#include "accum.cuh"

namespace {

using cymf::flush_run;

constexpr int LANES = 128;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLICE = 256;     // rows a CTA accumulates at most
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a CTA may take
constexpr int MAX_GRANULES = 4;    // 128-lane granules one walk holds
constexpr unsigned FULL = 0xffffffffu;

struct Stream {
  const int* rows;
  const float* g;
  const int* starts;
  const int* counts;
  int n;          // samples in the stream
  int neg_lanes;  // lanes [0, neg_lanes) are negated
};

// Adds granules [g0, g0 + NG) of the rows of window w's range that lie in
// [r0, r0 + nrows) into acc (rows of `width` floats, as the gradients),
// and, if cnt is not null, each flushed run's length into cnt[row].
template <int NG>
__device__ void walk(const Stream& st, float* acc, float* cnt, int width,
                     int g0, int w, int r0, int nrows) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = st.starts[w];
  const int lo = max(start, 0);
  const int hi = min(start + st.counts[w], st.n);
  if (hi <= lo) return;
  const int per = (hi - lo + WARPS - 1) / WARPS;
  const int a = lo + warp * per;
  const int e = min(a + per, hi);
  int col[NG];
  float4 sign[NG], run[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    col[k] = (g0 + k) * LANES + lane * 4;
    sign[k].x = col[k] + 0 < st.neg_lanes ? -1.f : 1.f;
    sign[k].y = col[k] + 1 < st.neg_lanes ? -1.f : 1.f;
    sign[k].z = col[k] + 2 < st.neg_lanes ? -1.f : 1.f;
    sign[k].w = col[k] + 3 < st.neg_lanes ? -1.f : 1.f;
    run[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int cur = -1, len = 0;
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < NG; ++k) flush_run(acc, cur, col[k], run[k], width);
    if (cnt != nullptr && lane == 0)
      atomicAdd(cnt + cur, static_cast<float>(len));
  };
  for (int b0 = a; b0 < e; b0 += 32) {
    const int n = min(32, e - b0);
    const int mine = lane < n ? st.rows[b0 + lane] : -1;
    for (int t = 0; t < n; ++t) {
      const int rel = __shfl_sync(FULL, mine, t) - r0;
      if (static_cast<unsigned>(rel) >= static_cast<unsigned>(nrows))
        continue;  // another slice's row or a sentinel
      if (rel != cur) {
        if (cur >= 0) flush();
#pragma unroll
        for (int k = 0; k < NG; ++k) run[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        cur = rel;
        len = 0;
      }
      const float* src = st.g + static_cast<size_t>(b0 + t) * width;
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(src + col[k]);
        run[k].x += sign[k].x * v.x;
        run[k].y += sign[k].y * v.y;
        run[k].z += sign[k].z * v.z;
        run[k].w += sign[k].w * v.w;
      }
      ++len;
    }
  }
  if (cur >= 0) flush();
}

// The packed pipelines' form: 128-lane rows, no counts.
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
  walk<1>(s1, acc, nullptr, LANES, 0, w, r0, nrows);
  if (two) walk<1>(s2, acc, nullptr, LANES, 0, w, r0, nrows);
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(r0) * LANES);
  for (int t = threadIdx.x; t < n4; t += THREADS) o[t] = acc4[t];
}

__device__ void walk_group(const Stream& st, float* acc, float* cnt,
                           int width, int g0, int ng, int w, int r0,
                           int nrows) {
  switch (ng) {
    case 1: walk<1>(st, acc, cnt, width, g0, w, r0, nrows); break;
    case 2: walk<2>(st, acc, cnt, width, g0, w, r0, nrows); break;
    case 3: walk<3>(st, acc, cnt, width, g0, w, r0, nrows); break;
    default: walk<4>(st, acc, cnt, width, g0, w, r0, nrows); break;
  }
}

// The wide form: rows of `width` (a multiple of 128) floats, and with
// count_lanes the count granule after them.
__global__ void __launch_bounds__(THREADS)
accum_wide_kernel(Stream s1, Stream s2, int two, float* __restrict__ out,
                  int wrows, int nslices, int slice, int width,
                  int count_lanes) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int w = blockIdx.x / nslices;
  const int k = blockIdx.x % nslices;
  const int r0 = w * wrows + k * slice;
  const int nrows = min(slice, wrows - k * slice);
  float* cnt = count_lanes ? acc + slice * width : nullptr;
  const int n4 = nrows * width / 4;
  for (int t = threadIdx.x; t < n4; t += THREADS)
    acc4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cnt != nullptr)
    for (int t = threadIdx.x; t < nrows; t += THREADS) cnt[t] = 0.f;
  __syncthreads();
  const int granules = width / LANES;
  for (int g0 = 0; g0 < granules; g0 += MAX_GRANULES) {
    const int ng = min(MAX_GRANULES, granules - g0);
    float* c = g0 == 0 ? cnt : nullptr;
    walk_group(s1, acc, c, width, g0, ng, w, r0, nrows);
    if (two) walk_group(s2, acc, c, width, g0, ng, w, r0, nrows);
  }
  __syncthreads();
  const int row4 = width / 4;                        // float4s of payload
  const int out4 = row4 + (count_lanes ? LANES / 4 : 0);
  float4* o = reinterpret_cast<float4*>(out) + static_cast<size_t>(r0) * out4;
  for (int t = threadIdx.x; t < nrows * out4; t += THREADS) {
    const int r = t / out4, q = t - r * out4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < row4)
      v = acc4[r * row4 + q];
    else if (q == row4)
      v.x = cnt[r];
    o[t] = v;
  }
}

// Rows a slice may hold at `width` floats (and a count) a row: 0 if not one.
int max_slice(int width, int count_lanes) {
  const int per_row = 4 * width + (count_lanes ? 4 : 0);
  return min(MAX_SLICE, SMEM_LIMIT / per_row);
}

int launch(const Stream& s1, const Stream& s2, int two, float* out,
           int r_pad, int wrows, int width, int count_lanes,
           cudaStream_t stream) {
  const int most = max_slice(width, count_lanes);
  if (most < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the window's rows in nslices near-equal slices of at most `most`
  const int nslices = (wrows + most - 1) / most;
  const int slice = (wrows + nslices - 1) / nslices;
  const bool packed = width == LANES && !count_lanes;
  const int smem = slice * width * static_cast<int>(sizeof(float)) +
                   (count_lanes ? slice * static_cast<int>(sizeof(float)) : 0);
  cudaError_t err = packed
      ? cudaFuncSetAttribute(accum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
      : cudaFuncSetAttribute(accum_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = r_pad / wrows;
  if (windows > 0) {
    if (packed)
      accum_kernel<<<windows * nslices, THREADS, smem, stream>>>(
          s1, s2, two, out, wrows, nslices, slice);
    else
      accum_wide_kernel<<<windows * nslices, THREADS, smem, stream>>>(
          s1, s2, two, out, wrows, nslices, slice, width, count_lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows a CTA's slice holds at this width (0: the width does not fit).
extern "C" int cymf_sorted_accum_max_slice(int width, int count_lanes) {
  return max_slice(width, count_lanes);
}

extern "C" int cymf_sorted_accum(const int* rows, const float* g,
                                 const int* starts, const int* counts,
                                 float* out, int n, int r_pad, int wrows,
                                 cudaStream_t stream) {
  const Stream s1{rows, g, starts, counts, n, 0};
  return launch(s1, s1, 0, out, r_pad, wrows, LANES, 0, stream);
}

extern "C" int cymf_sorted_accum_dual(
    const int* rows_i, const float* g_i, const int* starts_i,
    const int* counts_i, const int* rows_j, const float* g_j,
    const int* starts_j, const int* counts_j, float* out, int n_i, int n_j,
    int r_pad, int wrows, int neg_lanes, cudaStream_t stream) {
  const Stream si{rows_i, g_i, starts_i, counts_i, n_i, neg_lanes};
  const Stream sj{rows_j, g_j, starts_j, counts_j, n_j, 0};
  return launch(si, sj, 1, out, r_pad, wrows, LANES, 0, stream);
}

extern "C" int cymf_sorted_accum_wide(const int* rows, const float* g,
                                      const int* starts, const int* counts,
                                      float* out, int n, int r_pad,
                                      int wrows, int width, int count_lanes,
                                      cudaStream_t stream) {
  const Stream s1{rows, g, starts, counts, n, 0};
  return launch(s1, s1, 0, out, r_pad, wrows, width, count_lanes, stream);
}

extern "C" int cymf_sorted_accum_dual_wide(
    const int* rows_i, const float* g_i, const int* starts_i,
    const int* counts_i, const int* rows_j, const float* g_j,
    const int* starts_j, const int* counts_j, float* out, int n_i, int n_j,
    int r_pad, int wrows, int neg_lanes, int width, int count_lanes,
    cudaStream_t stream) {
  const Stream si{rows_i, g_i, starts_i, counts_i, n_i, neg_lanes};
  const Stream sj{rows_j, g_j, starts_j, counts_j, n_j, 0};
  return launch(si, sj, 1, out, r_pad, wrows, width, count_lanes, stream);
}

extern "C" const char* cymf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
