// Sequential small-catalog epochs (engine="pallas") on Hopper (sm_90a).
//
// Replaces, in cymf_tpu/ops/pallas_engine.py:
//   bpr_pallas_epoch   (_make_kernel)        -> cymf_bpr_seq_epoch
//   relmf_pallas_epoch (_make_relmf_kernel)  -> cymf_relmf_seq_epoch
//   glove_pallas_epoch (_make_glove_kernel)  -> cymf_glove_seq_epoch
//
// Each walks a whole stream of samples in order, G samples (a "group") at
// a time: every sample of a group reads the same snapshot of the tables,
// computes its loss gradient and one optimizer step on each row it
// touches, and writes the rows back.  Rows are fused: a table row is
// [param Kp | state Kp ...] (Kp = the payload width rounded up to 4; no
// state for sgd, the accumulator for adagrad, m and v for adam), so one
// row read and one row write carry a whole optimizer step.
//
//   BPR    x = wu.(hi - hj), sig = 1/(1 + exp(x)),
//          g_wu = -(sig (hi - hj) - wd wu), g_hi = -(sig wu - wd hi),
//          g_hj = -(-sig wu - wd hj),
//          loss = max(-x, 0) + log1p(exp(-|x|)) + wd (|wu|^2+|hi|^2+|hj|^2)
//   RelMF  s = wu.hi, coef = w - s, g_wu = -coef hi + wd wu,
//          g_hi = -coef wu + wd hi,
//          loss = w (1 - s)^2 + (1 - w) s^2 + wd (|wu|^2 + |hi|^2)
//   GloVe  diff = wc.hx - log(count), g_c = f diff hx (column K+1 masked),
//          g_x = f diff wc (column K masked), loss = 0.5 f diff^2; AdaGrad
//
// with the JAX kernel's optimizers, quirks included: adam's bias
// correction is the constant 1/(1 - beta), adagrad accumulators start at
// one.  A masked sample (padding, a rejected negative) reads but never
// writes, and adds nothing to the loss.
//
// Bound on the H100: latency, not bytes or operations.  Each group
// depends on the writes of the group before it, so the launch is a chain
// of dependent steps: load the group's indices, then its rows (an L2
// round trip: the tables, at most 10 MiB by the engine's gate, stay in
// the 50 MB L2), a warp reduction, a barrier, the row stores, a barrier.
// That chain is ~1-3 us a group, where the bytes a group moves would take
// nanoseconds at 3.35 TB/s.
//
// Design: one thread block for the whole launch, because the TPU grid runs
// in order and CUDA blocks do not; a loop inside the block replaces the
// grid.  The block has G warps, warp t owning sample t of every group; a
// lane holds 4 consecutive columns of each row segment (one float4 load or
// store per segment), and the dot products are warp shuffles.  The JAX
// kernel writes the group's rows in sample order (for each t: W[u], H[i],
// H[j]; GloVe Wc[c], Wx[x]) under pl.when(keep), so the last kept write to
// a row wins.  Here every warp computes its new rows from the snapshot,
// the block synchronises, and a warp stores a row only if no later kept
// write of the group goes to the same row of the same table (checked
// against the group's destinations in shared memory); a second barrier
// makes the stores visible to the next group's reads.  So no two warps
// ever store one row in the same group, and the result does not vary from
// run to run.  The loss is summed by one thread in the JAX kernel's order:
// a group's G terms, added to a per-chunk sum, added to the total once per
// chunk.  Elementwise arithmetic uses round-to-nearest intrinsics, so the
// compiler does not contract it into FMAs and it rounds as the plain
// PyTorch version's does; only the dot products' summation order differs.
//
// What this leaves on the table (later work): the tables could live in
// shared memory (distributed across a cluster where they do not fit one
// SM), the next group's indices could be prefetched, and the next group's
// reads issued while the stores drain.

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

using cymf::warp_sum;

constexpr int MAX_GROUP = 16;
enum Model { BPR = 0, RELMF = 1, GLOVE = 2 };

struct Hyper {
  float lr, wd, b1, omb1, b2, omb2, eps;  // omb = 1 - beta, rounded once
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// A lane's 4 columns of a fused row: v[0] the parameter, v[1..NS] the
// optimizer states.
template <int NS>
struct Row {
  float v[1 + NS][4];
};

template <int NS>
__device__ __forceinline__ void load_row(Row<NS>& r, const float* T, int row,
                                         int Kp, int c0, bool active) {
  const float* base = T + static_cast<size_t>(row) * (1 + NS) * Kp + c0;
#pragma unroll
  for (int s = 0; s <= NS; ++s) {
    const float4 x = active ? *reinterpret_cast<const float4*>(base + s * Kp)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    r.v[s][0] = x.x;
    r.v[s][1] = x.y;
    r.v[s][2] = x.z;
    r.v[s][3] = x.w;
  }
}

template <int NS>
__device__ __forceinline__ void store_row(const Row<NS>& r, float* T, int row,
                                          int Kp, int c0, bool active) {
  if (!active) return;
  float* base = T + static_cast<size_t>(row) * (1 + NS) * Kp + c0;
#pragma unroll
  for (int s = 0; s <= NS; ++s)
    *reinterpret_cast<float4*>(base + s * Kp) =
        make_float4(r.v[s][0], r.v[s][1], r.v[s][2], r.v[s][3]);
}

// One optimizer step on a lane's columns (pallas_engine.py:116-130).
template <int NS>
__device__ __forceinline__ void opt_step(Row<NS>& r, const float g[4],
                                         const Hyper& h) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p = r.v[0][k];
    if constexpr (NS == 2) {
      const float m = add(mul(h.b1, r.v[1][k]), mul(h.omb1, g[k]));
      const float v = add(mul(h.b2, r.v[NS][k]), mul(mul(h.omb2, g[k]), g[k]));
      r.v[0][k] = sub(p, dvd(mul(h.lr, dvd(m, h.omb1)),
                             add(__fsqrt_rn(dvd(v, h.omb2)), h.eps)));
      r.v[1][k] = m;
      r.v[NS][k] = v;
    } else if constexpr (NS == 1) {
      const float a = add(r.v[1][k], mul(g[k], g[k]));
      r.v[0][k] = sub(p, mul(mul(h.lr, g[k]), rsqrtf(a)));
      r.v[1][k] = a;
    } else {
      r.v[0][k] = sub(p, mul(h.lr, g[k]));
    }
  }
}

__device__ __forceinline__ float dot4(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s += a[k] * b[k];
  return s;
}

// Tables A (W, or GloVe's central table) and B (H, or the context table).
// Streams, each n_groups * G long: ia (rows of A), ib (rows of B), ij (BPR:
// the negative's row of B), fa (RelMF: w; GloVe: f), fb (GloVe: log count),
// keep (nonzero = the sample writes).
template <int MODEL, int NS>
__global__ void __launch_bounds__(MAX_GROUP * 32)
seq_epoch_kernel(float* A, float* B, int rows_a, int rows_b,
                 const int* ia, const int* ib, const int* ij,
                 const float* fa, const float* fb, const int* keep,
                 long long n_groups, int groups_per_chunk, int Kp, int kdim,
                 Hyper h, float* loss_out) {
  __shared__ int dst[3][MAX_GROUP];  // the group's kept destinations, or -1
  __shared__ float terms[MAX_GROUP];
  const int G = blockDim.x >> 5;
  const int t = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = lane * 4;
  const bool active = c0 < Kp;
  float chunk_sum = 0.f, total = 0.f;
  int in_chunk = 0;

  for (long long g = 0; g < n_groups; ++g) {
    const long long b = g * G + t;
    const bool kept = keep[b] != 0;
    const float mf = kept ? 1.f : 0.f;
    const int a = ia[b];
    const int c = ib[b];
    const int d = MODEL == BPR ? ij[b] : 0;
    if (a < 0 || a >= rows_a || c < 0 || c >= rows_b || d < 0 || d >= rows_b)
      __trap();  // an index outside its table: fail loudly, never read it
    Row<NS> ra, rb, rc;
    load_row(ra, A, a, Kp, c0, active);
    load_row(rb, B, c, Kp, c0, active);
    if constexpr (MODEL == BPR) load_row(rc, B, d, Kp, c0, active);
    float term;

    if constexpr (MODEL == BPR) {
      const float* wu = ra.v[0];
      const float* hi = rb.v[0];
      const float* hj = rc.v[0];
      float diff[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) diff[k] = sub(hi[k], hj[k]);
      const float x = warp_sum(dot4(wu, diff));
      const float sig = dvd(1.f, add(1.f, expf(x)));  // sigma(-x)
      float g_wu[4], g_hi[4], g_hj[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        g_wu[k] = -sub(mul(sig, diff[k]), mul(h.wd, wu[k]));
        g_hi[k] = -sub(mul(sig, wu[k]), mul(h.wd, hi[k]));
        g_hj[k] = -sub(mul(-sig, wu[k]), mul(h.wd, hj[k]));
      }
      const float l2 = add(add(warp_sum(dot4(wu, wu)), warp_sum(dot4(hi, hi))),
                           warp_sum(dot4(hj, hj)));
      const float softplus = add(fmaxf(-x, 0.f), log1pf(expf(-fabsf(x))));
      term = mul(mf, add(softplus, mul(h.wd, l2)));
      opt_step(ra, g_wu, h);
      opt_step(rb, g_hi, h);
      opt_step(rc, g_hj, h);
    } else if constexpr (MODEL == RELMF) {
      const float* wu = ra.v[0];
      const float* hi = rb.v[0];
      const float w = fa[b];
      const float s = warp_sum(dot4(wu, hi));
      const float coef = sub(w, s);
      float g_wu[4], g_hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        g_wu[k] = add(mul(-coef, hi[k]), mul(h.wd, wu[k]));
        g_hi[k] = add(mul(-coef, wu[k]), mul(h.wd, hi[k]));
      }
      const float l2 = add(warp_sum(dot4(wu, wu)), warp_sum(dot4(hi, hi)));
      const float one_s = sub(1.f, s);
      term = mul(mf, add(add(mul(w, mul(one_s, one_s)),
                             mul(sub(1.f, w), mul(s, s))),
                         mul(h.wd, l2)));
      opt_step(ra, g_wu, h);
      opt_step(rb, g_hi, h);
    } else {
      const float* wc = ra.v[0];
      const float* hx = rb.v[0];
      const float f = fa[b];
      const float diff = sub(warp_sum(dot4(wc, hx)), fb[b]);
      const float fd = mul(f, diff);
      float g_c[4], g_x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = c0 + k;
        g_c[k] = mul(mul(fd, hx[k]), col == kdim + 1 ? 0.f : 1.f);
        g_x[k] = mul(mul(fd, wc[k]), col == kdim ? 0.f : 1.f);
      }
      term = mul(mul(mul(mf, 0.5f), f), mul(diff, diff));
      opt_step(ra, g_c, h);
      opt_step(rb, g_x, h);
    }

    if (lane == 0) {
      terms[t] = term;
      dst[0][t] = kept ? a : -1;
      dst[1][t] = kept ? c : -1;
      dst[2][t] = kept && MODEL == BPR ? d : -1;
    }
    __syncthreads();  // every read of the snapshot is done

    if (kept) {
      // a write goes out unless a later kept write of the group, in the
      // JAX kernel's order, goes to the same row of the same table
      bool win_a = true, win_b = true, win_c = true;
      if constexpr (MODEL == BPR) win_b = d != c;
      for (int t2 = t + 1; t2 < G; ++t2) {
        win_a &= dst[0][t2] != a;
        win_b &= dst[1][t2] != c && dst[2][t2] != c;
        win_c &= dst[1][t2] != d && dst[2][t2] != d;
      }
      if (win_a) store_row(ra, A, a, Kp, c0, active);
      if (win_b) store_row(rb, B, c, Kp, c0, active);
      if constexpr (MODEL == BPR)
        if (win_c) store_row(rc, B, d, Kp, c0, active);
    }
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int t2 = 0; t2 < G; ++t2) s += terms[t2];
      chunk_sum += s;
      if (++in_chunk == groups_per_chunk) {
        total += chunk_sum;
        chunk_sum = 0.f;
        in_chunk = 0;
      }
    }
    __syncthreads();  // the stores are visible to the next group's reads
  }
  if (threadIdx.x == 0) *loss_out = total;
}

template <int MODEL>
int launch(int n_state, float* A, float* B, int rows_a, int rows_b,
           const int* ia, const int* ib, const int* ij, const float* fa,
           const float* fb, const int* keep, long long n, int chunk,
           int group, int Kp, int kdim, const Hyper& h, float* loss,
           cudaStream_t stream) {
  if (group < 1 || group > MAX_GROUP || chunk % group || n % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_groups = n / group;
  const int gpc = chunk / group;
  const dim3 block(group * 32);
  switch (n_state) {
    case 0:
      seq_epoch_kernel<MODEL, 0><<<1, block, 0, stream>>>(
          A, B, rows_a, rows_b, ia, ib, ij, fa, fb, keep, n_groups, gpc, Kp,
          kdim, h, loss);
      break;
    case 1:
      seq_epoch_kernel<MODEL, 1><<<1, block, 0, stream>>>(
          A, B, rows_a, rows_b, ia, ib, ij, fa, fb, keep, n_groups, gpc, Kp,
          kdim, h, loss);
      break;
    case 2:
      seq_epoch_kernel<MODEL, 2><<<1, block, 0, stream>>>(
          A, B, rows_a, rows_b, ia, ib, ij, fa, fb, keep, n_groups, gpc, Kp,
          kdim, h, loss);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest group (warps of the one block) the kernels take.
extern "C" int cymf_seq_epoch_max_group() { return MAX_GROUP; }

extern "C" int cymf_bpr_seq_epoch(float* W, float* H, int rows_w, int rows_h,
                                  const int* u, const int* i, const int* j,
                                  const int* keep, long long n, int chunk,
                                  int group, int Kp, int n_state, float lr,
                                  float wd, float b1, float omb1, float b2,
                                  float omb2, float eps, float* loss,
                                  cudaStream_t stream) {
  const Hyper h{lr, wd, b1, omb1, b2, omb2, eps};
  return launch<BPR>(n_state, W, H, rows_w, rows_h, u, i, j, nullptr,
                     nullptr, keep, n, chunk, group, Kp, 0, h, loss, stream);
}

extern "C" int cymf_relmf_seq_epoch(float* W, float* H, int rows_w,
                                    int rows_h, const int* u, const int* i,
                                    const float* w, const int* keep,
                                    long long n, int chunk, int group, int Kp,
                                    int n_state, float lr, float wd, float b1,
                                    float omb1, float b2, float omb2,
                                    float eps, float* loss,
                                    cudaStream_t stream) {
  const Hyper h{lr, wd, b1, omb1, b2, omb2, eps};
  return launch<RELMF>(n_state, W, H, rows_w, rows_h, u, i, nullptr, w,
                       nullptr, keep, n, chunk, group, Kp, 0, h, loss,
                       stream);
}

extern "C" int cymf_glove_seq_epoch(float* Wc, float* Wx, int rows_c,
                                    int rows_x, const int* c, const int* x,
                                    const float* f, const float* logcnt,
                                    const int* keep, long long n, int chunk,
                                    int group, int Kp, int kdim, float lr,
                                    float* loss, cudaStream_t stream) {
  const Hyper h{lr, 0.f, 0.f, 1.f, 0.f, 1.f, 0.f};
  return launch<GLOVE>(1, Wc, Wx, rows_c, rows_x, c, x, nullptr, f, logcnt,
                       keep, n, chunk, group, Kp, kdim, h, loss, stream);
}
