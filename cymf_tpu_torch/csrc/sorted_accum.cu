// Sorted accumulation (scatter-add over row-sorted streams) on Hopper
// (sm_90a).
//
// Replaces cymf_tpu/ops/sorted_accum.py::sorted_accum (_accum_kernel) and
// ::sorted_accum_dual (_accum_kernel_dual): out[rows[b]] += g[b] for rows in
// [0, r_pad); rows outside it (padding sentinels, the wide engine's dead
// samples routed to r_pad) drop.  The dual form adds two streams into one
// output and negates the first stream's lanes < neg_lanes, which gives the
// packed BPR step's H-side operand  scatter(j, gj) - scatter(i, gi)  with
// the count lane adding.  With count_lanes the output has a 128-lane
// granule after the `width` payload lanes whose lane 0 holds each row's
// count of live samples and whose other lanes are zero.
//
// Bound on the H100: memory.  The rows and g are read once and the output
// written once; nothing is computed but one add an element.  At the packed
// main-path shape (ML-20M d=20) the W side reads 64 MiB of g and 0.5 MiB
// of row ids and writes 11 MiB, the H side (dual) twice the reads and 13
// MiB of output; at the wide engine's ML-20M d=256 step the W side reads
// 128 MiB and writes 203 MiB, the H side reads 256 MiB and writes 40 MiB.
//
// Both forms are a sample-balanced segmented reduction.
//
// Why not one CTA per output window, as the TPU kernel's grid (and this
// file's first form) has it: the W side's user ids follow a power law,
// heaviest first.  At ML-20M d=20, 256-row windows, the first of 91
// windows held ~33,900 of 131,072 samples (26%; the mean is ~1,440), so its
// CTA's 16 warps each walked ~2,100 samples one after another, ~0.5 us a
// sample with each load behind the previous sample's branch and flush,
// while 41 of 132 SMs had no CTA at all: 1.03-1.06 ms against a 0.024 ms
// byte bound and `index_add_`'s 0.17 ms.  A 128-227 KiB shared accumulator
// let one CTA fit an SM, so no other warps hid the latency.  The H side's
// windows are balanced, and the window grid still lost there: 105 CTAs
// for 132 SMs at d=20, each warp's ~156 samples loaded one at a time with
// four shared-memory atomics a lane at each run's end (0.137 ms in a loop,
// 3.1x its bound); at d=256 a window of 512 rows did not fit one CTA, so
// each of its three slice-CTAs read the whole window's rows of both
// streams (0.57 ms, 6.2x its bound).
//
// What both forms do instead:
// 1. The grid is cut by samples.  Warp p takes the PART = 64 samples
//    [p PART, (p + 1) PART), a CTA eight parts: every warp does the same
//    work whatever the skew, and the grid holds several CTAs an SM (no
//    shared memory).  plan_segmented sizes the grid and the scratch, and
//    cymf_sorted_accum_plan / cymf_sorted_accum_dual_plan hand that plan
//    to the wrapper.
// 2. Loads are pipelined: lane t holds columns [4t, 4t + 4) of each
//    128-lane granule, and a warp issues the float4 loads of U samples at
//    once (U x granules 8-12; 16 measured slower at width 128),
//    predicated on the sample being live, before it adds any of them, so
//    U samples' DRAM latency is paid once; the next 32 row ids load under
//    the current 32 samples.
// 3. A run is a row's consecutive live samples (live rows are
//    non-decreasing along a stream, which the callers guarantee and the
//    kernels assert, once a stream; sentinel rows may sit anywhere).  A
//    part's runs are summed in registers; a run that begins and ends
//    inside the part is stored at once.  The part's first and last pieces
//    may belong to runs that other parts share: they go to a scratch slot
//    each (boundary partials), with the part's first and last live row.
//    A second short kernel has the part that holds a run's first live
//    sample add the head pieces of the following parts until the run ends
//    (skipping parts with no live sample), and store the row once.  Every
//    sum is taken in stream order, the same from run to run.  The longest
//    run at ML-20M step 0 is ~400 samples (six users a packed d=20 row), a
//    join over 7 parts.
// 4. The single stream stores with plain float4 stores, and every row
//    with no live sample is written with zeros exactly once.  Rows
//    strictly between two runs of one part are such rows; the part zeroes
//    them itself, as it reads, if they are at most ZERO_GAP.  The first
//    kernel marks every row it or the joins write (a byte a row, cleared
//    before it), and the second kernel's other CTAs zero the unmarked
//    rest, count granule included, a warp to 32 rows at a time over the
//    whole grid, so a long gap (a padding tail, a sparse stream, a stream
//    with no live sample) is spread over every SM.  The output needs no
//    memset.
// 5. The dual form runs the j stream as the single stream (stores, zero
//    fill: every row written once), then the i stream's parts under
//    segment.cuh's add policy: each stream gives a row at most one run
//    sum (3), and the i stream's is added with 128-bit global atomics
//    (the count granule's lane 0 adds the run's count), no marks, no zero
//    fill.  A row gets at most one add, onto a value already stored, so
//    the result is the same from run to run.  The i stream's lanes <
//    neg_lanes are negated as its run sums are added: negation commutes
//    with rounding, so that is the sum of the negated samples, bit for
//    bit.  Measured against one grid over both streams' parts whose run
//    sums are all added by atomics onto an output zeroed by a memset
//    (H100, ML-20M step 0, device ms): 0.0784 against 0.0770 at width 128,
//    0.143 against 0.150 at width 256 + counts, 0.203 against 0.217 at
//    384: the memset of the whole output costs more than the j pass's
//    stores and zero fill save.
// Widths: any multiple of 128; a walk holds at most MAX_GRANULES granules
// in registers, wider rows walk a part once per group (counts, marks and
// the part's rows on the first).  Sums come in another order than a
// sequential scatter: equal to float32 round-off; counts are exact below
// 2^24.  The plan, the scratch, a part's run bookkeeping (PartRuns), the
// store policies and the second pass live in segment.cuh, which the v8
// pool step (#7, bpr_fused.cu) shares: there the per-sample source is the
// fused BPR sample math instead of a stream row.

#include <cuda_runtime.h>

#include "segment.cuh"

namespace {

using cymf::bind_segmented;
using cymf::clear_marks;
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
constexpr unsigned FULL = 0xffffffffu;

// Part p's walk over granules [g0, g0 + NG), U samples' loads at a time,
// its runs stored or (ADD) added.
template <int NG, int U, bool ADD>
__device__ void segment_part(const Segmented& s, int p, int g0) {
  const int lane = threadIdx.x & 31;
  const int a = p * PART;
  const int e = min(a + PART, s.n);
  PartRuns<NG, ADD> runs(s, p, g0);
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

template <int NG, int U, bool ADD>
__global__ void __launch_bounds__(SEG_THREADS)
segment_kernel(Segmented s, int g0) {
  const int p = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  if (p < s.parts) segment_part<NG, U, ADD>(s, p, g0);
}

template <int NG, int U, bool ADD>
cudaError_t launch_parts(const Segmented& s, int blocks, int g0,
                         cudaStream_t stream) {
  segment_kernel<NG, U, ADD><<<blocks, SEG_THREADS, 0, stream>>>(s, g0);
  return cudaGetLastError();
}

// Both passes of s's segmented reduction in `blocks` CTAs under the store
// policy (after clearing its marks) or the add policy: the first a launch
// per group of at most MAX_GRANULES granules.
template <bool ADD>
cudaError_t run_segmented(const Segmented& s, int blocks,
                          cudaStream_t stream) {
  if (s.r_pad == 0) return cudaSuccess;
  cudaError_t err = ADD ? cudaSuccess : clear_marks(s, stream);
  const int granules = s.width / LANES;
  for (int g0 = 0; err == cudaSuccess && blocks > 0 && g0 < granules;
       g0 += MAX_GRANULES) {
    switch (min(MAX_GRANULES, granules - g0)) {
      case 1: err = launch_parts<1, 8, ADD>(s, blocks, g0, stream); break;
      case 2: err = launch_parts<2, 4, ADD>(s, blocks, g0, stream); break;
      case 3: err = launch_parts<3, 4, ADD>(s, blocks, g0, stream); break;
      default: err = launch_parts<4, 2, ADD>(s, blocks, g0, stream); break;
    }
  }
  return err == cudaSuccess ? launch_combine<ADD>(s, blocks, stream) : err;
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
  const int blocks = static_cast<int>(plan_segmented(n, r_pad, width).blocks);
  return static_cast<int>(run_segmented<false>(s, blocks, stream));
}

// ---------------------------------------------------------------------------
// The dual form: the j stream stored, then the i stream's run sums added.
// ---------------------------------------------------------------------------

// The launch for n_i and n_j samples: the i stream's plan under the add
// policy (no marks; its scratch first, a multiple of 16 bytes), the j
// stream's under the store policy.
struct DualPlan {
  Plan i, j;
  long long scratch_bytes;
};

DualPlan plan_dual(int n_i, int n_j, int r_pad, int width) {
  DualPlan q;
  q.i = plan_segmented(n_i, r_pad, width, true);
  q.j = plan_segmented(n_j, r_pad, width, false);
  q.scratch_bytes = q.i.scratch_bytes + q.j.scratch_bytes;
  return q;
}

int launch_dual(const int* rows_i, const float* g_i, const int* rows_j,
                const float* g_j, float* out, void* scratch,
                long long scratch_bytes, int n_i, int n_j, int r_pad,
                int width, int neg_lanes, int count_lanes,
                cudaStream_t stream) {
  if (width <= 0 || width % LANES || n_i < 0 || n_j < 0 || r_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DualPlan q = plan_dual(n_i, n_j, r_pad, width);
  Segmented si, sj;
  char* base = static_cast<char*>(scratch);
  if (scratch_bytes < q.scratch_bytes ||
      !bind_segmented(si, base, q.i.scratch_bytes, n_i, r_pad, width,
                      count_lanes, true) ||
      !bind_segmented(sj, base + q.i.scratch_bytes, q.j.scratch_bytes, n_j,
                      r_pad, width, count_lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  si.rows = rows_i;
  si.g = g_i;
  si.out = out;
  si.neg_lanes = neg_lanes;
  sj.rows = rows_j;
  sj.g = g_j;
  sj.out = out;
  // every row written by the j pass (a run sum or zeros) before any add
  cudaError_t err =
      run_segmented<false>(sj, static_cast<int>(q.j.blocks), stream);
  if (err == cudaSuccess)
    err = run_segmented<true>(si, static_cast<int>(q.i.blocks), stream);
  return static_cast<int>(err);
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

// The dual launch for n_i and n_j samples of `width` lanes into r_pad
// rows, into plan[0..7): samples a part, the i stream's parts and the j
// stream's, the CTAs of the i and the j stream's first pass, samples a
// CTA, scratch bytes.
extern "C" int cymf_sorted_accum_dual_plan(int n_i, int n_j, int r_pad,
                                           int width, long long* plan) {
  if (width <= 0 || width % LANES || n_i < 0 || n_j < 0 || r_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DualPlan q = plan_dual(n_i, n_j, r_pad, width);
  const long long got[7] = {PART,       q.i.parts,        q.j.parts,
                            q.i.blocks, q.j.blocks,       PART * SEG_WARPS,
                            q.scratch_bytes};
  for (int i = 0; i < 7; ++i) plan[i] = got[i];
  return static_cast<int>(cudaSuccess);
}

// The dual form, any width that is a multiple of 128, with or without the
// count granule; `scratch` holds the dual plan's scratch bytes.
extern "C" int cymf_sorted_accum_dual(
    const int* rows_i, const float* g_i, const int* rows_j, const float* g_j,
    float* out, void* scratch, long long scratch_bytes, int n_i, int n_j,
    int r_pad, int width, int neg_lanes, int count_lanes,
    cudaStream_t stream) {
  return launch_dual(rows_i, g_i, rows_j, g_j, out, scratch, scratch_bytes,
                     n_i, n_j, r_pad, width, neg_lanes, count_lanes, stream);
}

extern "C" const char* cymf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
