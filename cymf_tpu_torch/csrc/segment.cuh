// The sample-balanced segmented reduction shared by the sorted
// accumulations (sorted_accum.cu: the single stream #2/#2w and the dual
// form #3/#3w) and the v8 pool step (bpr_fused.cu, #7): the launch plan,
// the scratch layout, a part's run bookkeeping, and the second pass that
// joins the runs parts share and zeroes every row no live sample landed
// on.  Two store policies, a template argument ADD of the device code: a
// run's sum is stored (and every other row zeroed), or added by 128-bit
// atomics onto rows already written (no marks, no zero fill: the dual form
// adds its second stream onto its first that way).  What each kernel sums
// per sample (a stream row, or the fused BPR sample math) stays in its own
// source;
// sorted_accum.cu's note says how the partition works.  Internal linkage,
// like reduce.cuh.
#pragma once

#include <cassert>

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace cymf {
namespace {

constexpr int SEG_LANES = 128;
constexpr int PART = 64;          // samples a warp (parts of 32 and 128
                                  // measured slower at ML-20M)
constexpr int SEG_THREADS = 256;
constexpr int SEG_WARPS = SEG_THREADS / 32;  // parts a CTA
constexpr int ZERO_GAP = 32;      // rows a part zeroes between two of its
                                  // runs
constexpr int ZERO_BLOCKS = 1024; // CTAs that zero the rest at most
constexpr int MAX_GRANULES = 4;   // 128-lane granules one walk holds

// The launch for n samples of `width` lanes into r_pad rows.
struct Plan {
  long long parts, blocks, zero_blocks, scratch_bytes;
};

// `add`: the add policy, which has no mark a row.
inline Plan plan_segmented(int n, int r_pad, int width, bool add = false) {
  Plan q;
  q.parts = (static_cast<long long>(n) + PART - 1) / PART;
  q.blocks = (q.parts + SEG_WARPS - 1) / SEG_WARPS;
  const long long want = (static_cast<long long>(r_pad) + 32 * SEG_WARPS - 1) /
                         (32 * SEG_WARPS);
  q.zero_blocks = want < ZERO_BLOCKS ? want : ZERO_BLOCKS;
  // the parts' two slots (payload and count), their first and last rows,
  // a mark a row; a multiple of 16 bytes without the marks
  q.scratch_bytes = 8 * q.parts * (width + 2) + (add ? 0 : r_pad);
  return q;
}

struct Segmented {
  const int* rows;
  const float* g;
  float* out;
  float* sums;             // [2 parts, width]: part p's first piece at 2p,
                           // its last (when another) at 2p + 1
  float* lens;             // [2 parts]: the pieces' live samples
  int* first;              // [parts]: the part's first live row, -1: none
  int* last;               // [parts]: its last live row, -1: none
  unsigned char* touched;  // [r_pad]: 1 where a live sample lands (the
                           // store policy's)
  int n, r_pad, width, stride, parts, count_lanes;
  int neg_lanes;           // the add policy's: lanes [0, neg_lanes) add
                           // negated
};

// Fills s's sizes and carves its scratch (plan_segmented's bytes, without
// the marks for the add policy, `add`); false if the arguments or the
// scratch do not do.
inline bool bind_segmented(Segmented& s, void* scratch,
                           long long scratch_bytes, int n, int r_pad,
                           int width, int count_lanes, bool add = false) {
  if (width <= 0 || width % SEG_LANES || n < 0 || r_pad < 0) return false;
  const Plan q = plan_segmented(n, r_pad, width, add);
  if (scratch_bytes < q.scratch_bytes) return false;
  s.n = n;
  s.r_pad = r_pad;
  s.width = width;
  s.stride = width + (count_lanes ? SEG_LANES : 0);
  s.parts = static_cast<int>(q.parts);
  s.count_lanes = count_lanes;
  s.neg_lanes = 0;
  char* base = static_cast<char*>(scratch);
  const size_t slots = 2 * static_cast<size_t>(s.parts);
  s.sums = reinterpret_cast<float*>(base);
  s.lens = s.sums + slots * width;
  s.first = reinterpret_cast<int*>(s.lens + slots);
  s.last = s.first + s.parts;
  s.touched = add ? nullptr
                  : reinterpret_cast<unsigned char*>(s.last + s.parts);
  return true;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// float4 atomicAdd in global memory (sm_90) came with CUDA 12.1.
static_assert(CUDART_VERSION >= 12010, "float4 atomicAdd needs CUDA 12.1");

// *dst += v: one 128-bit vector reduction (dst 16-byte aligned).
__device__ __forceinline__ void atomic_add4(float* dst, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

// -v on the columns [c0, c0 + 4) that are < neg.
__device__ __forceinline__ float4 negate_below(float4 v, int c0, int neg) {
  if (c0 + 0 < neg) v.x = -v.x;
  if (c0 + 1 < neg) v.y = -v.y;
  if (c0 + 2 < neg) v.z = -v.z;
  if (c0 + 3 < neg) v.w = -v.w;
  return v;
}

// Writes output row `row`: this lane's payload columns col[k] (k < ng) from
// v, and with `counts` the count granule (len in lane 0, zeros elsewhere).
// ADD adds them instead (lanes < neg_lanes negated, len to lane 0 of the
// count granule; the other lanes keep what was written).
template <bool ADD>
__device__ __forceinline__ void store_row(const Segmented& s, int row,
                                          const int* col, const float4* v,
                                          int ng, bool counts, float len) {
  const int lane = threadIdx.x & 31;
  float* dst = s.out + static_cast<size_t>(row) * s.stride;
  if (ADD) {
#pragma unroll
    for (int k = 0; k < MAX_GRANULES; ++k)
      if (k < ng)
        atomic_add4(dst + col[k], negate_below(v[k], col[k], s.neg_lanes));
    if (counts && lane == 0) atomicAdd(dst + s.width, len);
    return;
  }
#pragma unroll
  for (int k = 0; k < MAX_GRANULES; ++k)
    if (k < ng) *reinterpret_cast<float4*>(dst + col[k]) = v[k];
  if (counts) {
    float4 c = zero4();
    if (lane == 0) c.x = len;
    *reinterpret_cast<float4*>(dst + s.width + lane * 4) = c;
  }
}

// Zeroes output rows (lo, hi) (at most ZERO_GAP of them), count granule
// included, and marks them written.  Warp-collective.
__device__ __forceinline__ void zero_gap(const Segmented& s, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  const int out4 = s.stride / 4;
  for (int r = lo + 1; r < hi; ++r) {
    float4* o = reinterpret_cast<float4*>(s.out + static_cast<size_t>(r) *
                                                      s.stride);
    for (int q = lane; q < out4; q += 32) o[q] = zero4();
  }
  if (lo + 1 + lane < hi) s.touched[lo + 1 + lane] = 1;
}

// Part p's runs over granules [g0, g0 + NG): add() each live sample in
// stream order, finish() at the part's end.  A run that begins and ends
// inside the part is stored at once; the part's first and last pieces go
// to their scratch slots.  The lead walk (g0 == 0) also writes the counts,
// the marks and short gaps (the store policy's) and the part's first and
// last live rows.  Warp-collective: every lane calls with the same rows.
template <int NG, bool ADD = false>
struct PartRuns {
  const Segmented& s;
  const int p;
  const bool lead;
  int col[MAX_GRANULES];
  float4 run[MAX_GRANULES];
  int cur = -1, head = -1, pieces = 0;
  float len = 0.f;

  __device__ __forceinline__ PartRuns(const Segmented& s_, int p_, int g0)
      : s(s_), p(p_), lead(g0 == 0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < MAX_GRANULES; ++k) {
      col[k] = (g0 + k) * SEG_LANES + lane * 4;
      run[k] = zero4();
    }
  }

  // The piece of row `cur` ends: the part's first piece and its last go
  // to their scratch slots, a piece between them is a whole run.
  __device__ __forceinline__ void close(bool last_piece) {
    if (pieces == 0 || last_piece) {
      const int slot = 2 * p + (pieces == 0 ? 0 : 1);
      float* dst = s.sums + static_cast<size_t>(slot) * s.width;
#pragma unroll
      for (int k = 0; k < NG; ++k)
        *reinterpret_cast<float4*>(dst + col[k]) = run[k];
      if (lead && (threadIdx.x & 31) == 0) s.lens[slot] = len;
    } else {
      store_row<ADD>(s, cur, col, run, NG, lead && s.count_lanes, len);
    }
    if (!ADD && lead && (threadIdx.x & 31) == 0) s.touched[cur] = 1;
    ++pieces;
  }

  // Adds this lane's columns v[0..NG) of a live sample of row r.
  __device__ __forceinline__ void add(int r, const float4* v) {
    if (r != cur) {
      assert(r > cur && "live rows must be non-decreasing");
      if (cur >= 0) {
        close(false);
        // rows between two runs of the part: no sample lands on them
        if (!ADD && lead && r - cur - 1 <= ZERO_GAP) zero_gap(s, cur, r);
      }
      if (head < 0) head = r;
      cur = r;
      len = 0.f;
#pragma unroll
      for (int k = 0; k < NG; ++k) run[k] = zero4();
    }
#pragma unroll
    for (int k = 0; k < NG; ++k) add4(run[k], v[k]);
    len += 1.f;
  }

  __device__ __forceinline__ void finish() {
    if (cur >= 0) close(true);
    if (lead && (threadIdx.x & 31) == 0) {
      s.first[p] = head;
      s.last[p] = cur;
    }
  }
};

// The last live row before part p (-1 if none), skipping parts with no
// live sample 32 at a time.  Warp-collective.
__device__ int previous_last(const Segmented& s, int p) {
  const int lane = threadIdx.x & 31;
  for (int q = p - 1; q >= 0; q -= 32) {
    const int at = q - lane;
    const int f = at >= 0 ? s.first[at] : -2;
    const unsigned hit = __ballot_sync(FULL_MASK, f != -1);
    if (hit) {
      const int r = f >= 0 ? s.last[at] : -1;
      return __shfl_sync(FULL_MASK, r, __ffs(hit) - 1);
    }
  }
  return -1;
}

// Stores row `row`, whose first live sample part p holds: scratch slot
// `slot`, plus, with `walk`, the first pieces of the following parts while
// the run goes on.  Warp-collective.
template <bool ADD>
__device__ void emit(const Segmented& s, int p, int slot, int row,
                     bool walk) {
  const int lane = threadIdx.x & 31;
  const int granules = s.width / SEG_LANES;
  for (int g0 = 0; g0 < granules; g0 += MAX_GRANULES) {
    const int ng = min(MAX_GRANULES, granules - g0);
    int col[MAX_GRANULES];
    float4 acc[MAX_GRANULES];
    const float* src = s.sums + static_cast<size_t>(slot) * s.width;
#pragma unroll
    for (int k = 0; k < MAX_GRANULES; ++k) {
      col[k] = (g0 + k) * SEG_LANES + lane * 4;
      acc[k] = k < ng ? *reinterpret_cast<const float4*>(src + col[k])
                      : zero4();
    }
    float len = s.lens[slot];
    for (int q = p + 1; walk; q += 32) {
      // lane i looks at part q + i: it ends the walk if it is past the
      // last part, starts another row, or its run of `row` ends inside it
      const int at = q + lane;
      const int f = at < s.parts ? s.first[at] : -2;
      const int l = f == row ? s.last[at] : -1;
      const unsigned stops = __ballot_sync(
          FULL_MASK, f == -2 || (f >= 0 && f != row) || (f == row && l != row));
      const int end = stops ? __ffs(stops) - 1 : 31;
      unsigned take = __ballot_sync(FULL_MASK, f == row) & ((2u << end) - 1u);
      while (take) {
        // up to four parts' pieces loaded together
        int js[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          js[i] = take ? __ffs(take) - 1 : -1;
          take &= take - 1u;
        }
        float4 x[4][MAX_GRANULES];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* ps = s.sums + static_cast<size_t>(
              2 * (q + max(js[i], 0))) * s.width;
#pragma unroll
          for (int k = 0; k < MAX_GRANULES; ++k)
            x[i][k] = js[i] >= 0 && k < ng
                          ? *reinterpret_cast<const float4*>(ps + col[k])
                          : zero4();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (js[i] < 0) continue;
#pragma unroll
          for (int k = 0; k < MAX_GRANULES; ++k) add4(acc[k], x[i][k]);
          len += s.lens[2 * (q + js[i])];
        }
      }
      if (stops) break;
    }
    store_row<ADD>(s, row, col, acc, ng, g0 == 0 && s.count_lanes, len);
  }
}

// The second pass: CTAs [0, combine_blocks) store the runs that parts
// share (a warp a part: the part's first piece if a run starts there, its
// last piece if it is another); the other CTAs zero every row no live
// sample landed on.
template <bool ADD>
__global__ void __launch_bounds__(SEG_THREADS)
combine_kernel(Segmented s, int combine_blocks) {
  if (static_cast<int>(blockIdx.x) < combine_blocks) {
    const int p = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
    if (p >= s.parts) return;
    const int f = s.first[p];
    if (f < 0) return;
    const int l = s.last[p];
    const int before = previous_last(s, p);
    assert(before <= f && "live rows must be non-decreasing");
    if (before != f) emit<ADD>(s, p, 2 * p, f, l == f);
    if (l != f) emit<ADD>(s, p, 2 * p + 1, l, true);
    return;
  }
  // a warp looks at 32 rows at a time and zeroes the unmarked ones
  const int lane = threadIdx.x & 31;
  const int out4 = s.stride / 4;
  const int warps = (gridDim.x - combine_blocks) * SEG_WARPS;
  for (int r0 = ((blockIdx.x - combine_blocks) * SEG_WARPS +
                 (threadIdx.x >> 5)) * 32;
       r0 < s.r_pad; r0 += warps * 32) {
    unsigned todo = __ballot_sync(
        FULL_MASK, r0 + lane < s.r_pad && !s.touched[r0 + lane]);
    while (todo) {
      const int r = r0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      float4* o = reinterpret_cast<float4*>(s.out + static_cast<size_t>(r) *
                                                        s.stride);
      for (int q = lane; q < out4; q += 32) o[q] = zero4();
    }
  }
}

// Clears the marks before the first pass.
inline cudaError_t clear_marks(const Segmented& s, cudaStream_t stream) {
  return cudaMemsetAsync(s.touched, 0, s.r_pad, stream);
}

// The second pass after the first pass's `blocks` CTAs (the add policy
// zeroes no row).
template <bool ADD = false>
inline cudaError_t launch_combine(const Segmented& s, int blocks,
                                  cudaStream_t stream) {
  const int zero = ADD ? 0 : static_cast<int>(plan_segmented(
                                 s.n, s.r_pad, s.width).zero_blocks);
  if (blocks + zero == 0) return cudaSuccess;
  combine_kernel<ADD><<<blocks + zero, SEG_THREADS, 0, stream>>>(s, blocks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cymf
