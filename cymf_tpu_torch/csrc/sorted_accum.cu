// Sorted accumulation (scatter-add over row-sorted streams) on Hopper
// (sm_90a).
//
// Replaces cymf_tpu/ops/sorted_accum.py::sorted_accum (_accum_kernel) and
// ::sorted_accum_dual (_accum_kernel_dual): out[rows[b]] += g[b] for rows in
// [0, r_pad); rows outside it (padding sentinels, the wide engine's dead
// samples routed to r_pad) drop.  The dual form walks two streams into one
// output and negates the first stream's lanes < neg_lanes, which gives the
// packed BPR step's H-side operand  scatter(j, gj) - scatter(i, gi)  with
// the count lane adding.  With count_lanes the output has a 128-lane
// granule after the `width` payload lanes whose lane 0 holds each row's
// count of live samples and whose other lanes are zero.
//
// Bound on the H100: memory.  The rows and g are read once and the output
// written once; nothing is computed but one add an element.  At the packed
// main-path shape (ML-20M d=20, W side) one call reads 64 MiB of g and
// 0.5 MiB of row ids and writes 11 MiB; at the wide engine's ML-20M d=256
// step the W side reads 128 MiB and writes 203 MiB.
//
// The single-stream form: a sample-balanced segmented reduction.
//
// Why not one CTA per output window, as the TPU kernel's grid (and this
// file's first form, which the dual form still uses) has it: the W side's
// user ids follow a power law, heaviest first.  At ML-20M d=20, 256-row
// windows, the first of 91 windows held ~33,900 of 131,072 samples (26%;
// the mean is ~1,440), so its CTA's 16 warps each walked ~2,100 samples one
// after another, ~0.5 us a sample with each load behind the previous
// sample's branch and flush, while 41 of 132 SMs had no CTA at all: 1.03-
// 1.06 ms against a 0.024 ms byte bound and `index_add_`'s 0.17 ms.  At
// d=256 the first of 271 windows held ~20,800 samples (43x the mean) and
// each of its three slice-CTAs walked all of them.  A 128-227 KiB shared
// accumulator let one CTA fit an SM, so no other warps hid the latency.
//
// What this form does instead:
// 1. The grid is cut by samples.  Warp p takes the PART = 64 samples
//    [p PART, (p + 1) PART), a CTA eight parts: every warp does the same
//    work whatever the skew, and the grid holds several CTAs an SM (no
//    shared memory).  plan_segmented sizes the grid and the scratch, and
//    cymf_sorted_accum_plan hands that plan to the wrapper.
// 2. Loads are pipelined: lane t holds columns [4t, 4t + 4) of each
//    128-lane granule, and a warp issues the float4 loads of U samples at
//    once (U x granules 8-12; 16 measured slower at width 128),
//    predicated on the sample being live, before it adds any of them, so
//    U samples' DRAM latency is paid once; the next 32 row ids load under
//    the current 32 samples.
// 3. A run is a row's consecutive live samples (live rows are
//    non-decreasing along the stream, which the callers guarantee and both
//    kernels assert; sentinel rows may sit anywhere).  A part's runs are summed in registers; a run
//    that begins and ends inside the part is stored at once with plain
//    float4 stores.  The part's first and last pieces may belong to runs
//    that other parts share: they go to a scratch slot each (boundary
//    partials), with the part's first and last live row.  A second short
//    kernel has the part that holds a run's first live sample add the head
//    pieces of the following parts until the run ends (skipping parts with
//    no live sample), and store the row once.  No atomics: every sum is
//    taken in stream order, the same from run to run.  The longest run at
//    ML-20M step 0 is ~400 samples (six users a packed d=20 row), a join
//    over 7 parts.
// 4. Every row with no live sample is written with zeros exactly once.
//    Rows strictly between two runs of one part are such rows; the part
//    zeroes them itself, as it reads, if they are at most ZERO_GAP.  The
//    first kernel marks every row it or the joins write (a byte a row,
//    cleared before it), and the second kernel's other CTAs zero the
//    unmarked rest, count granule included, a warp to 32 rows at a time
//    over the whole grid, so a long gap (a padding tail, a sparse stream,
//    a stream with no live sample) is spread over every SM.  The output
//    needs no memset.
// Widths: any multiple of 128; a walk holds at most MAX_GRANULES granules
// in registers, wider rows walk a part once per group (counts, marks and
// the part's rows on the first).  Sums come in another order than a
// sequential scatter: equal to float32 round-off; counts are exact below
// 2^24.  The plan, the scratch, a part's run bookkeeping (PartRuns) and
// the second pass live in segment.cuh, which the v8 pool step (#7,
// bpr_fused.cu) shares: there the per-sample source is the fused BPR
// sample math instead of a stream row.
//
// The dual form keeps the window grid: one CTA per slice of `wrows`
// output rows (at most MAX_SLICE rows, and what fits the 227 KiB a CTA may
// opt in to), its rows x width f32 accumulator (and a float count a row)
// in dynamic shared memory.  Every CTA of a window walks the window's whole
// sample range (starts/counts from the host) for both streams and keeps
// only the rows of its own slice; each warp walks a contiguous part of the
// range with register run-sums flushed into shared memory by atomicAdd at
// a row change (accum.cuh).  The CTA then writes its whole slice, zeros and
// the count granule included.  The H side's windows are balanced, so the
// window grid serves it.

#include <cuda_runtime.h>

#include "accum.cuh"
#include "segment.cuh"

namespace {

using cymf::bind_segmented;
using cymf::clear_marks;
using cymf::flush_run;
using cymf::launch_combine;
using cymf::MAX_GRANULES;
using cymf::PART;
using cymf::PartRuns;
using cymf::Plan;
using cymf::plan_segmented;
using cymf::SEG_THREADS;
using cymf::SEG_WARPS;
using cymf::Segmented;
using cymf::zero4;
using cymf::ZERO_GAP;

constexpr int LANES = 128;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLICE = 256;     // rows a CTA accumulates at most
constexpr int SMEM_LIMIT = 232448; // dynamic shared memory a CTA may take
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// The single-stream form: a sample-balanced segmented reduction (the plan,
// the run bookkeeping and the second pass are segment.cuh's).
// ---------------------------------------------------------------------------

// Part p's walk over granules [g0, g0 + NG), U samples' loads at a time.
template <int NG, int U>
__device__ void segment_part(const Segmented& s, int p, int g0) {
  const int lane = threadIdx.x & 31;
  const int a = p * PART;
  const int e = min(a + PART, s.n);
  PartRuns<NG> runs(s, p, g0);
  int next = a + lane < e ? s.rows[a + lane] : -1;
  for (int b0 = a; b0 < e; b0 += 32) {
    const int nb = min(32, e - b0);
    const int mine = next;  // the next 32 row ids load under this batch
    next = b0 + 32 + lane < e ? s.rows[b0 + 32 + lane] : -1;
    const unsigned live = __ballot_sync(
        FULL, lane < nb && static_cast<unsigned>(mine) <
                               static_cast<unsigned>(s.r_pad));
    for (int t0 = 0; t0 < nb; t0 += U) {
      float4 v[U][NG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u;
        const bool on = t < nb && ((live >> (t & 31)) & 1u);
        const float4* src = reinterpret_cast<const float4*>(
            s.g + static_cast<size_t>(b0 + (on ? t : 0)) * s.width);
#pragma unroll
        for (int k = 0; k < NG; ++k)
          v[u][k] = on ? __ldg(src + runs.col[k] / 4) : zero4();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u;
        const int r = __shfl_sync(FULL, mine, t & 31);
        if (t >= nb || !((live >> (t & 31)) & 1u)) continue;
        runs.add(r, v[u]);
      }
    }
  }
  runs.finish();
}

template <int NG, int U>
__global__ void __launch_bounds__(SEG_THREADS)
segment_kernel(Segmented s, int g0) {
  const int p = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  if (p < s.parts) segment_part<NG, U>(s, p, g0);
}

template <int NG, int U>
cudaError_t launch_parts(const Segmented& s, int blocks, int g0,
                         cudaStream_t stream) {
  segment_kernel<NG, U><<<blocks, SEG_THREADS, 0, stream>>>(s, g0);
  return cudaGetLastError();
}

int launch_segmented(const int* rows, const float* g, float* out,
                     void* scratch, long long scratch_bytes, int n,
                     int r_pad, int width, int count_lanes,
                     cudaStream_t stream) {
  Segmented s;
  if (!bind_segmented(s, scratch, scratch_bytes, n, r_pad, width,
                      count_lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  s.rows = rows;
  s.g = g;
  s.out = out;
  if (r_pad == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = clear_marks(s, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(plan_segmented(n, r_pad, width).blocks);
  const int granules = width / LANES;
  for (int g0 = 0; blocks > 0 && g0 < granules; g0 += MAX_GRANULES) {
    switch (min(MAX_GRANULES, granules - g0)) {
      case 1: err = launch_parts<1, 8>(s, blocks, g0, stream); break;
      case 2: err = launch_parts<2, 4>(s, blocks, g0, stream); break;
      case 3: err = launch_parts<3, 4>(s, blocks, g0, stream); break;
      default: err = launch_parts<4, 2>(s, blocks, g0, stream); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_combine(s, blocks, stream));
}

// ---------------------------------------------------------------------------
// The dual form: one CTA per slice of a window of output rows.
// ---------------------------------------------------------------------------

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
accum_kernel(Stream s1, Stream s2, float* __restrict__ out, int wrows,
             int nslices, int slice) {
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
  walk<1>(s2, acc, nullptr, LANES, 0, w, r0, nrows);
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
accum_wide_kernel(Stream s1, Stream s2, float* __restrict__ out, int wrows,
                  int nslices, int slice, int width, int count_lanes) {
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
    walk_group(s2, acc, c, width, g0, ng, w, r0, nrows);
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

int launch_dual(const Stream& s1, const Stream& s2, float* out, int r_pad,
                int wrows, int width, int count_lanes, cudaStream_t stream) {
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
          s1, s2, out, wrows, nslices, slice);
    else
      accum_wide_kernel<<<windows * nslices, THREADS, smem, stream>>>(
          s1, s2, out, wrows, nslices, slice, width, count_lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The single-stream launch for n samples of `width` lanes into r_pad rows,
// into plan[0..6): samples a part, parts, CTAs of the first kernel, samples
// a CTA, rows a part zeroes between two of its runs, scratch bytes.
extern "C" int cymf_sorted_accum_plan(int n, int r_pad, int width,
                                      long long* plan) {
  if (width <= 0 || width % LANES || n < 0 || r_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan q = plan_segmented(n, r_pad, width);
  const long long got[6] = {PART, q.parts, q.blocks, PART * SEG_WARPS,
                            ZERO_GAP, q.scratch_bytes};
  for (int i = 0; i < 6; ++i) plan[i] = got[i];
  return static_cast<int>(cudaSuccess);
}

// The single-stream form, any width that is a multiple of 128, with or
// without the count granule; `scratch` holds the plan's scratch bytes.
extern "C" int cymf_sorted_accum(const int* rows, const float* g,
                                 float* out, void* scratch,
                                 long long scratch_bytes, int n, int r_pad,
                                 int width, int count_lanes,
                                 cudaStream_t stream) {
  return launch_segmented(rows, g, out, scratch, scratch_bytes, n, r_pad,
                          width, count_lanes, stream);
}

// Rows a dual-form CTA's slice holds at this width (0: it does not fit).
extern "C" int cymf_sorted_accum_max_slice(int width, int count_lanes) {
  return max_slice(width, count_lanes);
}

extern "C" int cymf_sorted_accum_dual(
    const int* rows_i, const float* g_i, const int* starts_i,
    const int* counts_i, const int* rows_j, const float* g_j,
    const int* starts_j, const int* counts_j, float* out, int n_i, int n_j,
    int r_pad, int wrows, int neg_lanes, cudaStream_t stream) {
  const Stream si{rows_i, g_i, starts_i, counts_i, n_i, neg_lanes};
  const Stream sj{rows_j, g_j, starts_j, counts_j, n_j, 0};
  return launch_dual(si, sj, out, r_pad, wrows, LANES, 0, stream);
}

extern "C" int cymf_sorted_accum_dual_wide(
    const int* rows_i, const float* g_i, const int* starts_i,
    const int* counts_i, const int* rows_j, const float* g_j,
    const int* starts_j, const int* counts_j, float* out, int n_i, int n_j,
    int r_pad, int wrows, int neg_lanes, int width, int count_lanes,
    cudaStream_t stream) {
  const Stream si{rows_i, g_i, starts_i, counts_i, n_i, neg_lanes};
  const Stream sj{rows_j, g_j, starts_j, counts_j, n_j, 0};
  return launch_dual(si, sj, out, r_pad, wrows, width, count_lanes, stream);
}

extern "C" const char* cymf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
