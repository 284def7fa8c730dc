// The packed BPR pipelines v5-v8 on Hopper (sm_90a): the sample phase with
// the W rows read in the kernel (v5), and the sample phase fused with the
// W-side accumulation (v6, v7, v8).
//
// Replaces, in cymf_tpu/ops/:
//   fused_sample.py::bpr_sample_phase_v5 (_bpr_sample_kernel_v5) by
//     bpr_v5_kernel;
//   fused_step.py::bpr_block_step_v6 (_kernel) and ::bpr_range_step_v7
//     (_kernel_v7) by fused_kernel<6> and <7>;
//   fused_step.py::bpr_pool_step_v8 (_kernel_v8) by pool_step_kernel.
// The per-sample math is bpr_math.cuh's, shared with the v4 sample kernel.
//
// What the TPU kernels compute, and what of it is kept:
// - v5: per 512-sample tile t, the W rows of the samples come from a window
//   [wstart[t], wstart[t] + min(264, rw)) of the packed table; a row outside
//   it expands to zeros.  The mask and slot columns come from lanes
//   [cb, cb + s) of the decorated j rows, hj from their lanes < K.  Outputs
//   SW, Q and the loss, as the v4 sample phase.
// - v6: per W block of `wrows` rows, its home chunks (1024 samples each,
//   [cs[b], cs[b] + cn[b])) with the v5 expansion over a 264-row window per
//   chunk; SW, with the loss on lane 127, is summed into the block's rows
//   and the 264 rows after it (the spill the next block folds in); rows past
//   that, and the last block's spill, are dropped.  Q for every sample.
// - v7: per window of `wrows` rows, the samples of [starts[w], starts[w] +
//   ceil(counts[w] / 1024) * 1024) whose row lies in the window, sample math
//   on a gathered decorated Du stream, SW (loss on lane 127) summed into the
//   window.  Q for every sample.
// - v8: v7 with hj = Hpool[rj[b]] (zeros for a slot outside the pool) and
//   the pool gradient Apool[rj[b]] += Q[b] of the samples a window
//   accumulates (each once).
// The window DMA, the one-hot MXU expansion and accumulation with their bf16
// hi+lo split, the double-buffered slabs, the revisited loss block and the
// spill buffer are the TPU's way to gather and scatter: here rows are read
// directly and summed in float32.
//
// Bound on the H100: memory.  A step reads three (B, 128) float32 streams
// (64 MiB each at the main-path B = 131,072), writes Q and, for v5, SW; the
// W side of v6-v8 never makes a (B, 128) round trip.
//
// v5 is the v4 sample kernel with its W row loaded from the table: a warp a
// sample, a float4 a lane, loss partials summed in a fixed order.
//
// v6, v7: each CTA owns a slice of SLICE output rows, accumulated in shared
// memory and written once, so no output row is written twice and no atomics
// reach device memory for Aw.  The rows of a step are ascending, so a
// slice's samples are one contiguous run: the CTA finds it by binary search
// in its block's home chunks (v6; also in the previous block's chunks for
// the spill) or in its window's range (v7), splits it over its warps, and
// each warp sums runs of equal rows in registers and flushes a run into
// shared memory with atomicAdd (accum.cuh).  Q
// is written once per sample, by the CTA whose slice holds the sample's row.
// v6 rows in no slice (past the spill, padding sentinels >= rw) are written
// by the last slice of their home block.  The v7 padding tail (the samples
// of the last window's range with rows >= rw, ~54k in ML-20M's last step)
// is split in equal shares over every CTA of the grid.  The power-law users
// make the slices unequal: at ML-20M step 0 the heaviest 8-row slice holds
// thousands of samples, walked by one CTA in dependent chains, which sets
// the kernel's time (v7 4-6x its byte bound on the H100).
//
// v8: a sample-balanced fused reduction, the single-stream accumulation's
// design (sorted_accum.cu) with the fused sample math as its per-sample
// source.
// The slice grid it had before took 0.68 ms at ML-20M step 0 against a
// 0.064 ms byte bound, for the reason above.  Now:
// 1. Warp p takes the PART = 64 samples [p PART, (p + 1) PART), eight parts
//    a CTA (256 CTAs at B = 131,072), whatever the users' skew.  The
//    padding tail is parts like any other.
// 2. Per sample: the float4 loads of Du, Hi and Hpool[rj] (zeros for a
//    slot outside the pool), bpr_math.cuh's math (the lane rotations
//    through a per-warp shared row), Q stored for every sample; for a kept
//    sample (the plain version's _window_keep: row in [0, rw) and the
//    sample inside its window's tile-extended range, O(1) a sample) Q
//    added into Apool[rj] if the slot is in the pool, with a 128-bit
//    atomicAdd (sm_90: one vector reduction; P <= 2048 rows stay in L2),
//    and SW added into the part's current run in registers.  The next 32
//    row ids and slots load under the current 32 samples.
// 3. The runs (segment.cuh's PartRuns): a run that begins and ends inside
//    the part is stored once with float4 stores; the part's first and last
//    pieces go to scratch, and segment.cuh's second pass joins them in
//    stream order and zeroes every row no kept sample landed on, so Aw
//    needs no memset and each of its rows is written exactly once.  Kept
//    rows must be non-decreasing (the rows are ascending), and the kernel
//    asserts it.
// What sets the pace (measured on the H100): the per-sample math, a chain
// of shared reads, shuffles and FMAs, not the bytes or the atomics (taking
// the atomics out left the time as it was; taking the math out saved 40%).
// So the kernel keeps 32 warps an SM (V8_MIN_BLOCKS) and one sample's
// loads at a time: keeping two or four samples' loads in flight, or a
// padded shared row free of bank conflicts, measured slower.
// Aw's sums come in stream order, the same from run to run; only Apool's
// order changes (float atomics).  The wrapper allocates the scratch of
// segment.cuh's plan at width 128, as cymf_sorted_accum_plan reports it.

#include <cuda_runtime.h>

#include "accum.cuh"
#include "bpr_math.cuh"
#include "reduce.cuh"
#include "segment.cuh"

namespace {

using cymf::atomic_add4;
using cymf::bind_segmented;
using cymf::bpr_sample_math;
using cymf::clear_marks;
using cymf::flush_run;
using cymf::FULL_MASK;
using cymf::launch_combine;
using cymf::lower_bound;
using cymf::PART;
using cymf::PartRuns;
using cymf::plan_segmented;
using cymf::SEG_THREADS;
using cymf::SEG_WARPS;
using cymf::Segmented;
using cymf::sum_partials_kernel;
using cymf::SUM_THREADS;

constexpr int LANES = 128;
constexpr int LOSS_LANE = 127;
constexpr int CROWS = 264;  // v6's expansion window per 1024-sample chunk

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The v5/v6 expansion of one sample: Du's payload lanes [0, cb) from W row
// `row` if it lies in [ws, ws + win), else zeros; its count channel [cb,
// cb + s) from the decorated j row; hj from the j row's lanes < K.
__device__ __forceinline__ void expand(const float* __restrict__ wp, int row,
                                       int ws, int win, const float j[4],
                                       int c0, int K, int s, int cb,
                                       float u[4], float hj[4]) {
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  if (static_cast<unsigned>(row - ws) < static_cast<unsigned>(win))
    load4(wp + static_cast<size_t>(row) * LANES + c0, w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = c0 + k;
    u[k] = l < cb ? w[k] : (l < cb + s ? j[k] : 0.f);
    hj[k] = l < K ? j[k] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// v5
// ---------------------------------------------------------------------------

constexpr int V5_WARPS = 8;
constexpr int V5_SAMPLES_PER_WARP = 8;
constexpr int V5_SAMPLES_PER_BLOCK = V5_WARPS * V5_SAMPLES_PER_WARP;

__global__ void __launch_bounds__(V5_WARPS * 32)
bpr_v5_kernel(const float* __restrict__ wp, const int* __restrict__ wstart,
              const int* __restrict__ rows, const float* __restrict__ di,
              const float* __restrict__ dj, float* __restrict__ sw,
              float* __restrict__ q, float* __restrict__ partials, int B,
              int win, int tile, int K, int s, int cb, float wd) {
  __shared__ float row_s[V5_WARPS][LANES];
  __shared__ float vals_s[V5_WARPS][LANES];
  __shared__ float warp_loss[V5_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = lane * 4;
  float* r = row_s[warp];
  float* v = vals_s[warp];
  float loss_acc = 0.f;
  const int first =
      blockIdx.x * V5_SAMPLES_PER_BLOCK + warp * V5_SAMPLES_PER_WARP;

  for (int n = 0; n < V5_SAMPLES_PER_WARP; ++n) {
    const int b = first + n;
    if (b >= B) break;  // uniform across the warp
    const size_t off = static_cast<size_t>(b) * LANES + c0;
    float hi[4], j[4], u[4], hj[4], o[4], qo[4];
    load4(di + off, hi);
    load4(dj + off, j);
    expand(wp, rows[b], wstart[b / tile], win, j, c0, K, s, cb, u, hj);
    store4(r + c0, u);
    __syncwarp();
    loss_acc += bpr_sample_math(r, v, u, hi, hj, c0, K, s, cb, cb + s, wd,
                                -1, o, qo);
    store4(sw + off, o);
    store4(q + off, qo);
  }
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < V5_WARPS; ++w) t += warp_loss[w];
    partials[blockIdx.x] = t;
  }
}

// ---------------------------------------------------------------------------
// v6, v7, v8: sample phase + W accumulation
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 512;
constexpr int F_WARPS = F_THREADS / 32;
// output rows one CTA accumulates.  Small, because a slice's samples are
// walked by its CTA alone: at ML-20M step 0 the heaviest 32-row slice of
// the power-law users holds 11,508 of 131,072 samples, ~720 a warp in a
// dependent chain; an 8-row slice holds about a quarter of that.
constexpr int SLICE = 8;

struct Fused {
  const int* rows;   // B ascending packed W rows (padding sentinels >= rw)
  const float* hi;   // (B, 128) item rows
  const float* dj;   // v6: decorated j rows; v7: raw j rows
  const float* wp;   // v6: the packed W table
  const int* wstart; // v6: per-chunk expansion window starts
  const int* cs;     // v6: per-block first home chunk
  const int* cn;     // v6: per-block home chunk count
  const float* du;   // v7, v8: decorated gathered W rows
  const int* starts; // v7, v8: per-window sample ranges
  const int* counts;
  float* aw;         // (rw, 128)
  float* q;          // (B, 128)
  int B, rw, wrows, tile, K, s, cb;
  float wd;
};

// One sample's Du, hi and hj (this lane's four columns).
template <int V>
__device__ __forceinline__ void load_sample(const Fused& f, int b, int row,
                                            int c0, float u[4], float hi[4],
                                            float hj[4]) {
  const size_t off = static_cast<size_t>(b) * LANES + c0;
  load4(f.hi + off, hi);
  if (V == 6) {
    float j[4];
    load4(f.dj + off, j);
    expand(f.wp, row, f.wstart[b / f.tile], CROWS, j, c0, f.K, f.s, f.cb, u,
           hj);
    return;
  }
  load4(f.du + off, u);
  load4(f.dj + off, hj);
}

// Samples [lo, hi), split over the CTA's warps.  A sample whose row lies in
// [r0, r0 + nrows) is summed into the slice; its Q is written if its row
// lies in the slice, or below it and q_below, or above it and q_above.
template <int V>
__device__ void walk(const Fused& f, float* acc, float* r, float* v, int lo,
                     int hi, int r0, int nrows, bool q_below, bool q_above) {
  const int warp = threadIdx.x >> 5;
  const int c0 = (threadIdx.x & 31) * 4;
  if (hi <= lo) return;
  const int per = (hi - lo + F_WARPS - 1) / F_WARPS;
  const int a = lo + warp * per;
  const int e = min(a + per, hi);
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  int cur = -1;
  for (int b = a; b < e; ++b) {
    const int row = f.rows[b];
    const int rel = row - r0;
    const bool in = static_cast<unsigned>(rel) < static_cast<unsigned>(nrows);
    const bool wq = in || (rel < 0 ? q_below : q_above);
    if (!wq) continue;  // uniform across the warp
    float u[4], h[4], hj[4], o[4], qo[4];
    load_sample<V>(f, b, row, c0, u, h, hj);
    store4(r + c0, u);
    __syncwarp();
    bpr_sample_math(r, v, u, h, hj, c0, f.K, f.s, f.cb, f.cb + f.s, f.wd,
                    LOSS_LANE, o, qo);
    store4(f.q + static_cast<size_t>(b) * LANES + c0, qo);
    if (!in) continue;
    if (rel != cur) {
      if (cur >= 0) flush_run(acc, cur, c0, run);
      run = make_float4(0.f, 0.f, 0.f, 0.f);
      cur = rel;
    }
    run.x += o[0];
    run.y += o[1];
    run.z += o[2];
    run.w += o[3];
  }
  if (cur >= 0) flush_run(acc, cur, c0, run);
}

// v7, v8: window w's sample range [st, en) over B samples, extended to
// whole chunks of `tile` samples as the TPU kernel walks it.
__device__ __forceinline__ void window_range(const int* starts,
                                             const int* counts, int w,
                                             int tile, int B, int& st,
                                             int& en) {
  st = max(starts[w], 0);
  const int cnt = counts[w];
  en = cnt > 0 ? min(st + (cnt + tile - 1) / tile * tile, B) : st;
}

template <int V>
__global__ void __launch_bounds__(F_THREADS)
fused_kernel(Fused f, int nslices) {
  __shared__ float4 acc4[SLICE * LANES / 4];
  __shared__ float row_s[F_WARPS][LANES];
  __shared__ float vals_s[F_WARPS][LANES];
  float* acc = reinterpret_cast<float*>(acc4);
  float* r = row_s[threadIdx.x >> 5];
  float* v = vals_s[threadIdx.x >> 5];
  const int w = blockIdx.x / nslices;  // W block (v6) or window (v7)
  const int k = blockIdx.x % nslices;
  const int base = w * f.wrows;
  const int r0 = base + k * SLICE;
  const int nrows = min(SLICE, f.wrows - k * SLICE);
  const bool last_slice = k == nslices - 1;
  const int n4 = nrows * LANES / 4;
  for (int t = threadIdx.x; t < n4; t += F_THREADS)
    acc4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (V == 6) {
    // this block's home chunks: the slice's rows; below the block (slice 0)
    // and past it (the last slice) for Q only
    const int hs = min(f.cs[w] * f.tile, f.B);
    const int he = min((f.cs[w] + f.cn[w]) * f.tile, f.B);
    const int lo = k == 0 ? hs : lower_bound(f.rows, hs, he, r0);
    const int hi = last_slice ? he : lower_bound(f.rows, hs, he, r0 + nrows);
    walk<6>(f, acc, r, v, lo, hi, r0, nrows, k == 0, last_slice);
    // the previous block's spill: its chunks' rows in [base, base + CROWS)
    const int cap = min(r0 + nrows, base + CROWS);
    if (w > 0 && cap > r0) {
      const int ps = min(f.cs[w - 1] * f.tile, f.B);
      const int pe = min((f.cs[w - 1] + f.cn[w - 1]) * f.tile, f.B);
      walk<6>(f, acc, r, v, lower_bound(f.rows, ps, pe, r0),
              lower_bound(f.rows, ps, pe, cap), r0, nrows, false, false);
    }
  } else {
    int st, en;
    window_range(f.starts, f.counts, w, f.tile, f.B, st, en);
    walk<V>(f, acc, r, v, lower_bound(f.rows, st, en, r0),
            lower_bound(f.rows, st, en, r0 + nrows), r0, nrows, false,
            false);
    // this CTA's share of the padding tail: the Q rows of the last
    // window's samples with rows >= rw (every CTA finds the same tail)
    window_range(f.starts, f.counts, gridDim.x / nslices - 1, f.tile, f.B,
                 st, en);
    const int t0 = lower_bound(f.rows, st, en, f.rw);
    const int share = (en - t0 + gridDim.x - 1) / gridDim.x;
    const int a = min(t0 + static_cast<int>(blockIdx.x) * share, en);
    walk<V>(f, acc, r, v, a, min(a + share, en), r0, nrows, false, true);
  }

  __syncthreads();
  float4* o = reinterpret_cast<float4*>(f.aw + static_cast<size_t>(r0) * LANES);
  for (int t = threadIdx.x; t < n4; t += F_THREADS) o[t] = acc4[t];
}

template <int V>
int launch_fused(const Fused& f, cudaStream_t stream) {
  const int nslices = (f.wrows + SLICE - 1) / SLICE;
  const int grid = f.rw / f.wrows * nslices;
  if (grid > 0)
    fused_kernel<V><<<grid, F_THREADS, 0, stream>>>(f, nslices);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// v8: the sample-balanced fused step
// ---------------------------------------------------------------------------

// CTAs an SM at least: a cap of 64 registers, so that 32 warps share an SM
// (the per-sample math is latency-bound; 2 or 3 CTAs an SM measured slower)
constexpr int V8_MIN_BLOCKS = 4;

struct Pool {
  const int* rows;    // B ascending packed W rows (padding sentinels >= rw)
  const int* rj;      // per-sample pool slots
  const float* du;    // (B, 128) decorated gathered W rows
  const float* hi;    // (B, 128) item rows
  const float* hpool; // (P, 128) pool rows
  const int* starts;  // per-window sample ranges
  const int* counts;
  float* apool;       // (P, 128), zeroed by the caller
  float* q;           // (B, 128)
  int B, rw, wrows, tile, P, K, s, cb;
  float wd;
};

// The plain version's _window_keep: the row lies in the table and the
// sample in its window's tile-extended range.
__device__ __forceinline__ bool keep_sample(const Pool& f, int b, int row) {
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(f.rw)) return false;
  int st, en;
  window_range(f.starts, f.counts, row / f.wrows, f.tile, f.B, st, en);
  return b >= st && b < en;
}

// Apool[p] += qo: one 128-bit vector reduction (segment.cuh).
__device__ __forceinline__ void pool_add(float* dst, const float qo[4]) {
  atomic_add4(dst, make_float4(qo[0], qo[1], qo[2], qo[3]));
}

// Warp p takes the PART samples [p PART, (p + 1) PART): Q for each, the
// pool gradient of each kept sample whose slot is in the pool, and the
// kept samples' SW into Aw through segment.cuh's runs.
__global__ void __launch_bounds__(SEG_THREADS, V8_MIN_BLOCKS)
pool_step_kernel(Pool f, Segmented sg) {
  __shared__ float row_s[SEG_WARPS][LANES];
  __shared__ float vals_s[SEG_WARPS][LANES];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = lane * 4;
  const int p = blockIdx.x * SEG_WARPS + warp;
  if (p >= sg.parts) return;  // the whole warp; no CTA barrier follows
  float* r = row_s[warp];
  float* v = vals_s[warp];
  const int a = p * PART;
  const int e = min(a + PART, f.B);
  PartRuns<1> runs(sg, p, 0);
  int next_row = a + lane < e ? f.rows[a + lane] : -1;
  int next_rj = a + lane < e ? f.rj[a + lane] : -1;
  for (int b0 = a; b0 < e; b0 += 32) {
    const int nb = min(32, e - b0);
    // the next 32 row ids and slots load under this batch
    const int mrow = next_row, mrj = next_rj;
    next_row = b0 + 32 + lane < e ? f.rows[b0 + 32 + lane] : -1;
    next_rj = b0 + 32 + lane < e ? f.rj[b0 + 32 + lane] : -1;
    const unsigned kept =
        __ballot_sync(FULL_MASK, lane < nb && keep_sample(f, b0 + lane, mrow));
    for (int t = 0; t < nb; ++t) {
      const int row = __shfl_sync(FULL_MASK, mrow, t);
      const int pj = __shfl_sync(FULL_MASK, mrj, t);
      const bool in_pool =
          static_cast<unsigned>(pj) < static_cast<unsigned>(f.P);
      const size_t off = static_cast<size_t>(b0 + t) * LANES + c0;
      float u[4], h[4], hj[4] = {0.f, 0.f, 0.f, 0.f};
      load4(f.du + off, u);
      load4(f.hi + off, h);
      // a slot outside the pool matches no one-hot row on the TPU
      if (in_pool) load4(f.hpool + static_cast<size_t>(pj) * LANES + c0, hj);
      float o[4], qo[4];
      store4(r + c0, u);
      __syncwarp();
      bpr_sample_math(r, v, u, h, hj, c0, f.K, f.s, f.cb, f.cb + f.s, f.wd,
                      LOSS_LANE, o, qo);
      store4(f.q + off, qo);
      if (!((kept >> t) & 1u)) continue;
      if (in_pool) pool_add(f.apool + static_cast<size_t>(pj) * LANES + c0, qo);
      const float4 o4 = make_float4(o[0], o[1], o[2], o[3]);
      runs.add(row, &o4);
    }
  }
  runs.finish();
}

int launch_pool(const Pool& f, float* aw, void* scratch,
                long long scratch_bytes, cudaStream_t stream) {
  Segmented sg;
  if (!bind_segmented(sg, scratch, scratch_bytes, f.B, f.rw, LANES, 0) ||
      f.wrows <= 0 || f.rw % f.wrows || f.tile <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  sg.rows = f.rows;
  sg.g = nullptr;
  sg.out = aw;
  cudaError_t err = clear_marks(sg, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(plan_segmented(f.B, f.rw, LANES).blocks);
  if (blocks > 0) {
    pool_step_kernel<<<blocks, SEG_THREADS, 0, stream>>>(f, sg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_combine(sg, blocks, stream));
}

}  // namespace

// Number of loss partials (one per block) the caller allocates for B rows.
extern "C" int cymf_bpr_v5_blocks(int B) {
  return (B + V5_SAMPLES_PER_BLOCK - 1) / V5_SAMPLES_PER_BLOCK;
}

extern "C" int cymf_bpr_sample_phase_v5(
    const float* wp, const int* wstart, const int* rows, const float* di,
    const float* dj, float* sw, float* q, float* partials, float* loss, int B,
    int win, int tile, int K, int s, int cb, float wd, cudaStream_t stream) {
  const int blocks = cymf_bpr_v5_blocks(B);
  if (blocks > 0)
    bpr_v5_kernel<<<blocks, V5_WARPS * 32, 0, stream>>>(
        wp, wstart, rows, di, dj, sw, q, partials, B, win, tile, K, s, cb,
        wd);
  sum_partials_kernel<<<1, SUM_THREADS, 0, stream>>>(partials, blocks, loss);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cymf_bpr_block_step_v6(
    const float* wp, const int* rows, const float* hi, const float* dj,
    const int* wstart, const int* cs, const int* cn, float* aw, float* q,
    int B, int rw, int wrows, int tile, int K, int s, int cb, float wd,
    cudaStream_t stream) {
  Fused f{};
  f.rows = rows;
  f.hi = hi;
  f.dj = dj;
  f.wp = wp;
  f.wstart = wstart;
  f.cs = cs;
  f.cn = cn;
  f.aw = aw;
  f.q = q;
  f.B = B;
  f.rw = rw;
  f.wrows = wrows;
  f.tile = tile;
  f.K = K;
  f.s = s;
  f.cb = cb;
  f.wd = wd;
  return launch_fused<6>(f, stream);
}

extern "C" int cymf_bpr_range_step_v7(
    const int* rows, const float* du, const float* hi, const float* dj,
    const int* starts, const int* counts, float* aw, float* q, int B, int rw,
    int wrows, int tile, int K, int s, int cb, float wd,
    cudaStream_t stream) {
  Fused f{};
  f.rows = rows;
  f.du = du;
  f.hi = hi;
  f.dj = dj;
  f.starts = starts;
  f.counts = counts;
  f.aw = aw;
  f.q = q;
  f.B = B;
  f.rw = rw;
  f.wrows = wrows;
  f.tile = tile;
  f.K = K;
  f.s = s;
  f.cb = cb;
  f.wd = wd;
  return launch_fused<7>(f, stream);
}

// `scratch` holds the scratch bytes of segment.cuh's plan for B samples
// into rw rows at width 128 (cymf_sorted_accum_plan); Apool is zeroed
// by the caller, Aw and Q need no initialisation.
extern "C" int cymf_bpr_pool_step_v8(
    const int* rows, const int* rj, const float* du, const float* hi,
    const float* hpool, const int* starts, const int* counts, float* aw,
    float* apool, float* q, void* scratch, long long scratch_bytes, int B,
    int rw, int wrows, int tile, int P, int K, int s, int cb, float wd,
    cudaStream_t stream) {
  return launch_pool(Pool{rows, rj, du, hi, hpool, starts, counts, apool, q,
                          B, rw, wrows, tile, P, K, s, cb, wd},
                     aw, scratch, scratch_bytes, stream);
}
