// The packed BPR pipelines v5-v8 on Hopper (sm_90a): the sample phase with
// the W rows read in the kernel (v5), and the sample phase fused with the
// W-side accumulation (v6, v7, v8).
//
// Replaces, in cymf_tpu/ops/:
//   fused_sample.py::bpr_sample_phase_v5 (_bpr_sample_kernel_v5) by
//     bpr_v5_kernel;
//   fused_step.py::bpr_block_step_v6 (_kernel), ::bpr_range_step_v7
//     (_kernel_v7) and ::bpr_pool_step_v8 (_kernel_v8) by step_kernel<6>,
//     <7> and <8>.
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
// v6, v7, v8: one sample-balanced fused reduction, the single-stream
// accumulation's design (sorted_accum.cu) with the fused sample math as its
// per-sample source.  Each had a grid of one CTA per 8-row output slice
// before; under the power-law users the heaviest slice held thousands of
// samples, walked by one CTA in dependent chains, which set the kernel's
// time on the H100 (at ML-20M step 0, v8 0.68 ms against a 0.064 ms byte
// bound, v7 0.38 against 0.084).  Now:
// 1. Warp p takes the PART = 64 samples [p PART, (p + 1) PART), eight parts
//    a CTA (256 CTAs at B = 131,072), whatever the users' skew.  The
//    padding tail is parts like any other.
// 2. Per sample: the float4 loads of its rows (the pipeline's only
//    difference: v7 reads Du and the raw j row; v8 Du and Hpool[rj], zeros
//    for a slot outside the pool; v6 the decorated j row and the W row
//    from its chunk's 264-row window, expanded as v5 does), bpr_math.cuh's
//    math (the lane rotations through a per-warp shared row), Q stored for
//    every sample; for a kept sample SW added into the part's current run
//    in registers and, for v8, Q added into Apool[rj] if the slot is in
//    the pool, with a 128-bit atomicAdd (sm_90: one vector reduction; P <=
//    2048 rows stay in L2).  Kept is the plain version's rule, O(1) a
//    sample: the row lies in [0, rw) and, for v7 and v8 (_window_keep), the
//    sample inside its row's window's tile-extended range; for v6 the row
//    in its chunk's home block or the CROWS rows after it (a spill row is
//    just a row of the next block; rows past that are dropped, and the
//    last block's spill lies past the table).  A v6 part lies in one
//    1024-sample chunk and finds its home block once, by binary search over
//    cs; a chunk that no block's range holds writes zeros to its Q rows
//    (prep_blocks homes every chunk, so only hand-made ranges get there).
//    The next 32 row ids (and v8's slots) load under the current 32
//    samples.
// 3. The runs (segment.cuh's PartRuns): a run that begins and ends inside
//    the part is stored once with float4 stores; the part's first and last
//    pieces go to scratch, and segment.cuh's second pass joins them in
//    stream order and zeroes every row no kept sample landed on, so Aw
//    needs no memset and each of its rows is written exactly once.  Kept
//    rows must be non-decreasing (the rows are ascending), and the kernel
//    asserts it.
// What sets the pace (measured on v8 on the H100): the per-sample math, a
// chain of shared reads, shuffles and FMAs, not the bytes or the atomics
// (taking the atomics out left the time as it was; taking the math out
// saved 40%).  So the kernel keeps 32 warps an SM (STEP_MIN_BLOCKS) and one
// sample's loads at a time: keeping two or four samples' loads in flight,
// or a padded shared row free of bank conflicts, measured slower.
// Aw's sums come in stream order, the same from run to run; only Apool's
// order changes (float atomics).  The wrapper allocates the scratch of
// segment.cuh's plan at width 128, as cymf_sorted_accum_plan reports it.

#include <cuda_runtime.h>

#include "bpr_math.cuh"
#include "reduce.cuh"
#include "segment.cuh"

namespace {

using cymf::atomic_add4;
using cymf::bind_segmented;
using cymf::bpr_sample_math;
using cymf::clear_marks;
using cymf::FULL_MASK;
using cymf::launch_combine;
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
// v6, v7, v8: the sample-balanced fused step
// ---------------------------------------------------------------------------

// CTAs an SM at least: a cap of 64 registers, so that 32 warps share an SM
// (the per-sample math is latency-bound; 2 or 3 CTAs an SM measured slower
// for v8)
constexpr int STEP_MIN_BLOCKS = 4;

struct Step {
  const int* rows;    // B ascending packed W rows (padding sentinels >= rw)
  const float* hi;    // (B, 128) item rows
  const float* du;    // v7, v8: (B, 128) decorated gathered W rows
  const float* dj;    // v6: decorated j rows; v7: raw j rows
  const float* wp;    // v6: (rw, 128) the packed W table
  const int* wstart;  // v6: per-chunk expansion window starts
  const int* cs;      // v6: per-block first home chunk, ascending
  const int* cn;      // v6: per-block home chunk count
  const int* starts;  // v7, v8: per-window sample ranges
  const int* counts;
  const int* rj;      // v8: per-sample pool slots
  const float* hpool; // v8: (P, 128) pool rows
  float* apool;       // v8: (P, 128), zeroed by the caller
  float* q;           // (B, 128)
  int B, rw, wrows, tile, P, K, s, cb;
  float wd;
};

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

// v6: the home block of chunk c, -1 for none: the last block whose range
// starts at or before c (cs is ascending), if that range holds c.
__device__ __forceinline__ int home_block(const Step& f, int c) {
  int lo = 0, hi = f.rw / f.wrows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (f.cs[mid] <= c)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int h = lo - 1;
  return h >= 0 && c < f.cs[h] + f.cn[h] ? h : -1;
}

// Whether sample b of W row `row` adds into Aw, the plain version's rule:
// the row lies in the table and, for v6, in [lo, lo + wrows + CROWS) (its
// chunk's home block from lo and the spill after it; the last block's
// spill lies past the table), for v7 and v8 the sample in its row's
// window's tile-extended range (_window_keep).
template <int V>
__device__ __forceinline__ bool keep_sample(const Step& f, int b, int row,
                                            int lo) {
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(f.rw)) return false;
  if (V == 6) return row >= lo && row - lo < f.wrows + CROWS;
  int st, en;
  window_range(f.starts, f.counts, row / f.wrows, f.tile, f.B, st, en);
  return b >= st && b < en;
}

// Warp p takes the PART samples [p PART, (p + 1) PART): Q for each, the
// kept samples' SW into Aw through segment.cuh's runs and, for v8, the
// pool gradient of each kept sample whose slot is in the pool.  A v6 part
// lies in one chunk (tile is a multiple of PART); a chunk with no home
// block writes zeros to its Q rows and keeps nothing.
template <int V>
__global__ void __launch_bounds__(SEG_THREADS, STEP_MIN_BLOCKS)
step_kernel(Step f, Segmented sg) {
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
  int ws = 0, lo = 0;  // v6: the chunk's expansion window, its home block
  if (V == 6) {
    const int c = a / f.tile;
    const int h = home_block(f, c);
    if (h < 0) {
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
      for (int b = a; b < e; ++b)
        store4(f.q + static_cast<size_t>(b) * LANES + c0, zero);
      runs.finish();
      return;
    }
    ws = f.wstart[c];
    lo = h * f.wrows;
  }
  int next_row = a + lane < e ? f.rows[a + lane] : -1;
  int next_rj = V == 8 && a + lane < e ? f.rj[a + lane] : -1;
  for (int b0 = a; b0 < e; b0 += 32) {
    const int nb = min(32, e - b0);
    // the next 32 row ids (and v8's slots) load under this batch
    const int mrow = next_row, mrj = next_rj;
    next_row = b0 + 32 + lane < e ? f.rows[b0 + 32 + lane] : -1;
    if (V == 8) next_rj = b0 + 32 + lane < e ? f.rj[b0 + 32 + lane] : -1;
    const unsigned kept = __ballot_sync(
        FULL_MASK, lane < nb && keep_sample<V>(f, b0 + lane, mrow, lo));
    for (int t = 0; t < nb; ++t) {
      const int row = __shfl_sync(FULL_MASK, mrow, t);
      const int pj = V == 8 ? __shfl_sync(FULL_MASK, mrj, t) : -1;
      const bool in_pool =
          V == 8 && static_cast<unsigned>(pj) < static_cast<unsigned>(f.P);
      const size_t off = static_cast<size_t>(b0 + t) * LANES + c0;
      float u[4], h[4], hj[4] = {0.f, 0.f, 0.f, 0.f};
      load4(f.hi + off, h);
      if (V == 6) {
        float j[4];
        load4(f.dj + off, j);
        expand(f.wp, row, ws, CROWS, j, c0, f.K, f.s, f.cb, u, hj);
      } else {
        load4(f.du + off, u);
        if (V == 7) load4(f.dj + off, hj);
        // a slot outside the pool matches no one-hot row on the TPU
        if (in_pool) load4(f.hpool + static_cast<size_t>(pj) * LANES + c0, hj);
      }
      float o[4], qo[4];
      store4(r + c0, u);
      __syncwarp();
      bpr_sample_math(r, v, u, h, hj, c0, f.K, f.s, f.cb, f.cb + f.s, f.wd,
                      LOSS_LANE, o, qo);
      store4(f.q + off, qo);
      if (!((kept >> t) & 1u)) continue;
      // Apool[pj] += qo: one 128-bit vector reduction
      if (in_pool)
        atomic_add4(f.apool + static_cast<size_t>(pj) * LANES + c0,
                    make_float4(qo[0], qo[1], qo[2], qo[3]));
      const float4 o4 = make_float4(o[0], o[1], o[2], o[3]);
      runs.add(row, &o4);
    }
  }
  runs.finish();
}

template <int V>
int launch_step(const Step& f, float* aw, void* scratch,
                long long scratch_bytes, cudaStream_t stream) {
  Segmented sg;
  if (!bind_segmented(sg, scratch, scratch_bytes, f.B, f.rw, LANES, 0) ||
      f.wrows <= 0 || f.rw % f.wrows || f.tile <= 0 ||
      (V == 6 && f.tile % PART))
    return static_cast<int>(cudaErrorInvalidValue);
  sg.rows = f.rows;
  sg.g = nullptr;
  sg.out = aw;
  cudaError_t err = clear_marks(sg, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(plan_segmented(f.B, f.rw, LANES).blocks);
  if (blocks > 0) {
    step_kernel<V><<<blocks, SEG_THREADS, 0, stream>>>(f, sg);
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

// v6, v7, v8: `scratch` holds the scratch bytes of segment.cuh's plan for
// B samples into rw rows at width 128 (cymf_sorted_accum_plan); Aw and Q
// need no initialisation, v8's Apool is zeroed by the caller.
extern "C" int cymf_bpr_block_step_v6(
    const float* wp, const int* rows, const float* hi, const float* dj,
    const int* wstart, const int* cs, const int* cn, float* aw, float* q,
    void* scratch, long long scratch_bytes, int B, int rw, int wrows,
    int tile, int K, int s, int cb, float wd, cudaStream_t stream) {
  Step f{};
  f.rows = rows;
  f.hi = hi;
  f.dj = dj;
  f.wp = wp;
  f.wstart = wstart;
  f.cs = cs;
  f.cn = cn;
  f.q = q;
  f.B = B;
  f.rw = rw;
  f.wrows = wrows;
  f.tile = tile;
  f.K = K;
  f.s = s;
  f.cb = cb;
  f.wd = wd;
  return launch_step<6>(f, aw, scratch, scratch_bytes, stream);
}

extern "C" int cymf_bpr_range_step_v7(
    const int* rows, const float* du, const float* hi, const float* dj,
    const int* starts, const int* counts, float* aw, float* q, void* scratch,
    long long scratch_bytes, int B, int rw, int wrows, int tile, int K, int s,
    int cb, float wd, cudaStream_t stream) {
  Step f{};
  f.rows = rows;
  f.du = du;
  f.hi = hi;
  f.dj = dj;
  f.starts = starts;
  f.counts = counts;
  f.q = q;
  f.B = B;
  f.rw = rw;
  f.wrows = wrows;
  f.tile = tile;
  f.K = K;
  f.s = s;
  f.cb = cb;
  f.wd = wd;
  return launch_step<7>(f, aw, scratch, scratch_bytes, stream);
}

extern "C" int cymf_bpr_pool_step_v8(
    const int* rows, const int* rj, const float* du, const float* hi,
    const float* hpool, const int* starts, const int* counts, float* aw,
    float* apool, float* q, void* scratch, long long scratch_bytes, int B,
    int rw, int wrows, int tile, int P, int K, int s, int cb, float wd,
    cudaStream_t stream) {
  Step f{};
  f.rows = rows;
  f.du = du;
  f.hi = hi;
  f.starts = starts;
  f.counts = counts;
  f.rj = rj;
  f.hpool = hpool;
  f.apool = apool;
  f.q = q;
  f.B = B;
  f.rw = rw;
  f.wrows = wrows;
  f.tile = tile;
  f.P = P;
  f.K = K;
  f.s = s;
  f.cb = cb;
  f.wd = wd;
  return launch_step<8>(f, aw, scratch, scratch_bytes, stream);
}
