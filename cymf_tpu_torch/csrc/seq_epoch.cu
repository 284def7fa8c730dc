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
// writes, and adds nothing to the loss.  The JAX kernel writes a group's
// rows in sample order (for each t: W[u], H[i], H[j]; GloVe Wc[c], Wx[x])
// under pl.when(keep), so the last kept write to a row wins; the loss is
// a group's G terms, summed into a per-chunk sum, added to the total once
// per chunk.  Elementwise arithmetic uses round-to-nearest intrinsics, so
// the compiler does not contract it into FMAs and it rounds as the plain
// PyTorch version's does; only the dot products' summation order differs.
//
// Bound on the H100: latency.  Each group depends on the writes of the
// group before it, so a launch is a chain of dependent group steps, where
// the bytes a group moves would take nanoseconds at 3.35 TB/s.  What a
// group's step cost in the first port (one block, indices and rows read
// from device memory on the chain, 4 columns a lane, the winning writes
// and the loss summed on the chain), measured on an H100 by variants with
// one piece removed each (RelMF at ml-100k, 198,656 groups of 8, adam;
// BPR, 7,168 groups): 2.79 us a group for RelMF and 3.51 for BPR, of
// which the optimizer arithmetic 1.31 and 1.84, the winner loop 0.46 and
// 0.31, the rows' L2 round trip 0.18 and 0.24, the loss loop 0.16 and
// 0.04, the index loads ~0.09 (BPR); with all five removed 0.61 and 0.78
// us remained (barriers and the dot products' shuffles).
//
// Design.  One block walks the chain, because the TPU grid runs in order
// and CUDA blocks do not: G "chain" warps, warp t owning sample t of every
// group, plus one "stager" warp.  A chain lane holds CW consecutive
// columns of each row segment (CW = 1 for Kp <= 32, 2 for Kp <= 64, else
// 4: the fewest instructions a warp issues for the optimizer's IEEE
// divisions and square roots, which set the pace), and the dot products
// are warp shuffles.  Per group the chain reads its rows' indices, its
// flags and weights from shared memory, loads its rows, does the math,
// writes its loss term to shared memory, synchronises the chain warps
// (every read of the snapshot is done), stores the rows its flags say it
// wins, and synchronises again (the stores are visible to the next
// group's reads).
//
// Off the chain, the stager walks the stream ahead in slices of SLICE
// samples, double-buffered in shared memory (named barriers FULL/EMPTY):
// it loads a slice's index, weight and keep streams, checks each index
// against its table (__trap: an index outside its table fails loudly),
// and computes each sample's write flags: a kept write goes out unless a
// later kept write of its group, in the JAX kernel's order, goes to the
// same row of the same table.  So no two warps store one row in a group,
// and the result does not vary from run to run.  When the chain has
// finished a slice, the stager sums its loss terms in the JAX kernel's
// order (a group's terms in sample order, then the groups one by one into
// the chunk sum, the chunk sum into the total).  So redesigned, a group
// takes ~0.79 us (RelMF), ~1.14 (BPR) and ~0.50 (GloVe) through L2 on
// the H100; under Adam the optimizer's IEEE arithmetic is still the
// largest piece of it (39% RelMF, 49% BPR), then the dot products'
// shuffles (9-16%; seq_split.py measures the split).
//
// Placement of the tables (seq_plan, which the launch applies; exported
// as cymf_seq_epoch_plan): 1, both fused tables in the block's dynamic
// shared memory (the TPU kernel's VMEM residency), loaded at the start and
// written back at the end, where they fit beside the ring; else 0, in
// device memory (through L2).  Both compute the same bits.  On the H100 the tables in shared
// memory made a group 10-25% faster than through L2 (BPR, RelMF, GloVe on
// catalogs cut to fit).  Spreading them over a thread-block cluster's
// distributed shared memory, with block 0 running the chain, made it
// 30-85% slower than L2, so there is no cluster placement: a remote row
// is farther than an L2 line, and a remote store needs a cluster-scope
// fence before the chain's barrier.  A placement the tables do not fit
// is refused with an error; nothing falls back.

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

using cymf::warp_sum;

constexpr int MAX_GROUP = 16;
// samples of one staged slice; the ring holds two, each with five 32-bit
// streams (a, b, j, fa, fb), the loss terms and a flag byte a sample
constexpr int SLICE = 256;
constexpr int N_STREAMS = 5;
constexpr int RING_BYTES = 2 * SLICE * (4 * N_STREAMS + 4 + 1);
// the opt-in shared memory of one block on sm_90; the tables get the rest
constexpr int SMEM_MAX = 232448;
constexpr int TABLE_BYTES = SMEM_MAX - RING_BYTES;
enum Model { BPR = 0, RELMF = 1, GLOVE = 2 };
// a staged sample's flags: kept, and the writes it wins
enum Flag { WIN_A = 1, WIN_B = 2, WIN_C = 4, KEPT = 8 };
// named barriers: 0 is __syncthreads, 1 the chain's, then FULL and EMPTY
// of each ring buffer
enum Barrier { CHAIN = 1, FULL = 2, EMPTY = 4 };

struct Hyper {
  float lr, wd, b1, omb1, b2, omb2, eps;  // omb = 1 - beta, rounded once
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// 1 where both tables fit the block's shared memory beside the ring, else
// 0 (device memory).
int seq_plan(int rows_a, int rows_b, int row_bytes) {
  return (static_cast<long long>(rows_a) + rows_b) * row_bytes <= TABLE_BYTES;
}

// A lane's CW columns of a fused row: v[0] the parameter, v[1..NS] the
// optimizer states.
template <int NS, int CW>
struct Row {
  float v[1 + NS][CW];
};

template <int CW>
__device__ __forceinline__ void load_cols(float* dst, const float* src) {
  if constexpr (CW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (CW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

template <int CW>
__device__ __forceinline__ void store_cols(float* dst, const float* src) {
  if constexpr (CW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  else if constexpr (CW == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  else
    *dst = src[0];
}

template <int NS, int CW>
__device__ __forceinline__ void load_row(Row<NS, CW>& r, const float* row,
                                         int Kp, int c0, bool active) {
#pragma unroll
  for (int s = 0; s <= NS; ++s) {
    if (active) {
      load_cols<CW>(r.v[s], row + s * Kp + c0);
    } else {
#pragma unroll
      for (int k = 0; k < CW; ++k) r.v[s][k] = 0.f;
    }
  }
}

template <int NS, int CW>
__device__ __forceinline__ void store_row(const Row<NS, CW>& r, float* row,
                                          int Kp, int c0, bool active) {
  if (!active) return;
#pragma unroll
  for (int s = 0; s <= NS; ++s) store_cols<CW>(row + s * Kp + c0, r.v[s]);
}

// One optimizer step on a lane's columns (pallas_engine.py:116-130).
template <int NS, int CW>
__device__ __forceinline__ void opt_step(Row<NS, CW>& r, const float* g,
                                         const Hyper& h) {
#pragma unroll
  for (int k = 0; k < CW; ++k) {
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

template <int CW>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CW; ++k) s += a[k] * b[k];
  return s;
}

// Copies a table between device memory and shared memory, a float4 a
// thread at a time.
__device__ void copy_table(float* shared, float* table, int rows,
                           int stride, bool to_shared) {
  float4* s = reinterpret_cast<float4*>(shared);
  float4* d = reinterpret_cast<float4*>(table);
  const long long n4 = static_cast<long long>(rows) * stride / 4;
  for (long long e = threadIdx.x; e < n4; e += blockDim.x) {
    if (to_shared)
      s[e] = d[e];
    else
      d[e] = s[e];
  }
}

// The ring in the head of the dynamic shared memory: per buffer the five
// streams, the loss terms and the flags.
struct Ring {
  int* words;            // [2][N_STREAMS][SLICE]
  float* terms;          // [2][SLICE]
  unsigned char* flags;  // [2][SLICE]
  __device__ int* stream(int buf, int s) const {
    return words + (buf * N_STREAMS + s) * SLICE;
  }
};

struct Streams {
  const int *ia, *ib, *ij;
  const float *fa, *fb;
  const int* keep;
};

// The stager's part for one slice: stage its streams into buffer `buf`
// and compute every sample's flags.
template <int MODEL>
__device__ void stage_slice(const Ring& ring, int buf, const Streams& st,
                            long long first, int ns, int G, int rows_a,
                            int rows_b, int lane) {
  int* ra = ring.stream(buf, 0);
  int* rb = ring.stream(buf, 1);
  int* rj = ring.stream(buf, 2);
  unsigned char* fl = ring.flags + buf * SLICE;
  for (int q = lane; q < ns; q += 32) {
    const long long e = first + q;
    const int a = st.ia[e];
    const int c = st.ib[e];
    const int d = MODEL == BPR ? st.ij[e] : 0;
    if (a < 0 || a >= rows_a || c < 0 || c >= rows_b || d < 0 || d >= rows_b)
      __trap();  // an index outside its table: fail loudly, never read it
    ra[q] = a;
    rb[q] = c;
    rj[q] = d;
    if (MODEL != BPR) ring.stream(buf, 3)[q] = __float_as_int(st.fa[e]);
    if (MODEL == GLOVE) ring.stream(buf, 4)[q] = __float_as_int(st.fb[e]);
    fl[q] = st.keep[e] != 0 ? KEPT : 0;
  }
  __syncwarp();
  // a kept write goes out unless a later kept write of the group, in the
  // JAX kernel's order (W[u], H[i], H[j] a sample), goes to the same row
  // of the same table; 4 bits a sample, at most SLICE / 32 samples a lane
  static_assert(SLICE / 32 * 4 <= 32, "a lane's flags fit one word");
  unsigned wins = 0;
  for (int q = lane, k = 0; q < ns; q += 32, k += 4) {
    if (!(fl[q] & KEPT)) continue;
    const int t = q % G;
    const int a = ra[q], c = rb[q], d = rj[q];
    bool wa = true, wb = MODEL != BPR || d != c, wc = true;
    for (int q2 = q + 1; q2 < q - t + G; ++q2) {
      if (!(fl[q2] & KEPT)) continue;
      wa &= ra[q2] != a;
      if constexpr (MODEL == BPR) {
        wb &= rb[q2] != c && rj[q2] != c;
        wc &= rb[q2] != d && rj[q2] != d;
      } else {
        wb &= rb[q2] != c;
      }
    }
    const unsigned f = (wa ? WIN_A : 0) | (wb ? WIN_B : 0) |
                       (MODEL == BPR && wc ? WIN_C : 0);
    wins |= f << k;
  }
  __syncwarp();
  for (int q = lane, k = 0; q < ns; q += 32, k += 4)
    fl[q] |= static_cast<unsigned char>((wins >> k) & 0xf);
  __syncwarp();
}

// The stager's part once the chain has finished a slice: its groups' loss
// terms into the running sums, in the JAX kernel's order.
struct LossSum {
  float chunk_sum = 0.f, total = 0.f;
  int in_chunk = 0;
};

__device__ void sum_slice(const Ring& ring, int buf, int gs, int G, int gpc,
                          LossSum& acc, int lane) {
  float* T = ring.terms + buf * SLICE;
  for (int gi = lane; gi < gs; gi += 32) {
    float s = 0.f;
    for (int t = 0; t < G; ++t) s += T[gi * G + t];
    T[gi * G] = s;
  }
  __syncwarp();
  if (lane == 0) {
    for (int gi = 0; gi < gs; ++gi) {
      acc.chunk_sum += T[gi * G];
      if (++acc.in_chunk == gpc) {
        acc.total += acc.chunk_sum;
        acc.chunk_sum = 0.f;
        acc.in_chunk = 0;
      }
    }
  }
  __syncwarp();
}

// Tables A (W, or GloVe's central table) and B (H, or the context table).
// Streams, each n_groups * G long: ia (rows of A), ib (rows of B), ij (BPR:
// the negative's row of B), fa (RelMF: w; GloVe: f), fb (GloVe: log count),
// keep (nonzero = the sample writes).  blockDim.x = (G + 1) * 32.
template <int MODEL, int NS, int CW>
__global__ void __launch_bounds__((MAX_GROUP + 1) * 32)
seq_epoch_kernel(float* A, float* B, int rows_a, int rows_b, Streams st,
                 long long n_groups, int groups_per_chunk, int Kp, int kdim,
                 int placement, Hyper h, float* loss_out) {
  extern __shared__ float4 smem4[];
  const Ring ring{reinterpret_cast<int*>(smem4),
                  reinterpret_cast<float*>(smem4) + 2 * N_STREAMS * SLICE,
                  reinterpret_cast<unsigned char*>(smem4) +
                      4 * 2 * (N_STREAMS + 1) * SLICE};
  const int G = (blockDim.x >> 5) - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = (1 + NS) * Kp;
  // where the chain reads and writes rows: the tables, or their copies in
  // shared memory
  float* TA = A;
  float* TB = B;
  if (placement == 1) {
    TA = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                  RING_BYTES);
    TB = TA + static_cast<size_t>(rows_a) * stride;
    copy_table(TA, A, rows_a, stride, true);
    copy_table(TB, B, rows_b, stride, true);
  }
  __syncthreads();

  const int gps = SLICE / G;  // groups a slice
  const long long n_slices = (n_groups + gps - 1) / gps;
  const int all = (G + 1) * 32;
  auto groups_in = [&](long long s) {  // groups of slice s
    const long long left = n_groups - s * gps;
    return left < gps ? static_cast<int>(left) : gps;
  };
  if (warp == G) {
    // the stager: slice s into buffer s & 1 once the chain is done with
    // slice s - 2, whose loss terms it then sums
    LossSum acc;
    for (long long s = 0; s < n_slices + 2; ++s) {
      const int buf = s & 1;
      if (s >= 2) {
        bar_sync(EMPTY + buf, all);
        const long long done = s - 2;
        sum_slice(ring, buf, groups_in(done), G, groups_per_chunk, acc,
                  lane);
      }
      if (s < n_slices) {
        stage_slice<MODEL>(ring, buf, st, s * gps * G, groups_in(s) * G, G,
                           rows_a, rows_b, lane);
        bar_arrive(FULL + buf, all);
      }
    }
    if (lane == 0) *loss_out = acc.total;
  } else {
    // the chain: warp t runs sample t of every group
    const int t = warp;
    const int c0 = lane * CW;
    const bool active = c0 < Kp;
    const int chain = G * 32;
    for (long long s = 0; s < n_slices; ++s) {
      const int buf = s & 1;
      bar_sync(FULL + buf, all);
      const int gs = groups_in(s);
      const int* sa = ring.stream(buf, 0);
      const int* sb = ring.stream(buf, 1);
      const int* sj = ring.stream(buf, 2);
      const int* sfa = ring.stream(buf, 3);
      const int* sfb = ring.stream(buf, 4);
      float* terms = ring.terms + buf * SLICE;
      const unsigned char* fl = ring.flags + buf * SLICE;
      for (int gi = 0; gi < gs; ++gi) {
        const int q = gi * G + t;
        const unsigned f = fl[q];
        const float mf = (f & KEPT) ? 1.f : 0.f;
        float* pa = TA + static_cast<size_t>(sa[q]) * stride;
        float* pb = TB + static_cast<size_t>(sb[q]) * stride;
        float* pc = MODEL == BPR ? TB + static_cast<size_t>(sj[q]) * stride
                                 : nullptr;
        Row<NS, CW> ra, rb, rc;
        load_row(ra, pa, Kp, c0, active);
        load_row(rb, pb, Kp, c0, active);
        if constexpr (MODEL == BPR) load_row(rc, pc, Kp, c0, active);
        float term;

        if constexpr (MODEL == BPR) {
          const float* wu = ra.v[0];
          const float* hi = rb.v[0];
          const float* hj = rc.v[0];
          float diff[CW];
#pragma unroll
          for (int k = 0; k < CW; ++k) diff[k] = sub(hi[k], hj[k]);
          const float x = warp_sum(dot<CW>(wu, diff));
          const float sig = dvd(1.f, add(1.f, expf(x)));  // sigma(-x)
          float g_wu[CW], g_hi[CW], g_hj[CW];
#pragma unroll
          for (int k = 0; k < CW; ++k) {
            g_wu[k] = -sub(mul(sig, diff[k]), mul(h.wd, wu[k]));
            g_hi[k] = -sub(mul(sig, wu[k]), mul(h.wd, hi[k]));
            g_hj[k] = -sub(mul(-sig, wu[k]), mul(h.wd, hj[k]));
          }
          // the three squared norms in one reduction
          const float l2 = warp_sum(add(add(dot<CW>(wu, wu), dot<CW>(hi, hi)),
                                        dot<CW>(hj, hj)));
          const float softplus = add(fmaxf(-x, 0.f), log1pf(expf(-fabsf(x))));
          term = mul(mf, add(softplus, mul(h.wd, l2)));
          opt_step(ra, g_wu, h);
          opt_step(rb, g_hi, h);
          opt_step(rc, g_hj, h);
        } else if constexpr (MODEL == RELMF) {
          const float* wu = ra.v[0];
          const float* hi = rb.v[0];
          const float w = __int_as_float(sfa[q]);
          const float s_ = warp_sum(dot<CW>(wu, hi));
          const float coef = sub(w, s_);
          float g_wu[CW], g_hi[CW];
#pragma unroll
          for (int k = 0; k < CW; ++k) {
            g_wu[k] = add(mul(-coef, hi[k]), mul(h.wd, wu[k]));
            g_hi[k] = add(mul(-coef, wu[k]), mul(h.wd, hi[k]));
          }
          const float l2 = warp_sum(add(dot<CW>(wu, wu), dot<CW>(hi, hi)));
          const float one_s = sub(1.f, s_);
          term = mul(mf, add(add(mul(w, mul(one_s, one_s)),
                                 mul(sub(1.f, w), mul(s_, s_))),
                             mul(h.wd, l2)));
          opt_step(ra, g_wu, h);
          opt_step(rb, g_hi, h);
        } else {
          const float* wc = ra.v[0];
          const float* hx = rb.v[0];
          const float fw = __int_as_float(sfa[q]);
          const float diff = sub(warp_sum(dot<CW>(wc, hx)),
                                 __int_as_float(sfb[q]));
          const float fd = mul(fw, diff);
          float g_c[CW], g_x[CW];
#pragma unroll
          for (int k = 0; k < CW; ++k) {
            const int col = c0 + k;
            g_c[k] = mul(mul(fd, hx[k]), col == kdim + 1 ? 0.f : 1.f);
            g_x[k] = mul(mul(fd, wc[k]), col == kdim ? 0.f : 1.f);
          }
          term = mul(mul(mul(mf, 0.5f), fw), mul(diff, diff));
          opt_step(ra, g_c, h);
          opt_step(rb, g_x, h);
        }

        if (lane == 0) terms[q] = term;
        bar_sync(CHAIN, chain);  // every read of the snapshot is done
        if (f & WIN_A) store_row(ra, pa, Kp, c0, active);
        if (f & WIN_B) store_row(rb, pb, Kp, c0, active);
        if constexpr (MODEL == BPR)
          if (f & WIN_C) store_row(rc, pc, Kp, c0, active);
        bar_sync(CHAIN, chain);  // the stores are visible to the next group
      }
      bar_arrive(EMPTY + buf, all);
    }
  }

  __syncthreads();
  if (placement == 1) {
    copy_table(TA, A, rows_a, stride, false);
    copy_table(TB, B, rows_b, stride, false);
  }
}

struct Launch {
  float *A, *B;
  int rows_a, rows_b;
  Streams st;
  long long n;
  int chunk, group, placement, Kp, kdim;
  Hyper h;
  float* loss;
};

template <int MODEL, int NS, int CW>
int launch_with(const Launch& L, cudaStream_t stream) {
  auto kernel = seq_epoch_kernel<MODEL, NS, CW>;
  const long long smem =
      RING_BYTES + (L.placement == 1 ? static_cast<long long>(
                                           L.rows_a + L.rows_b) *
                                           (1 + NS) * L.Kp * 4
                                     : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, (L.group + 1) * 32, smem, stream>>>(
      L.A, L.B, L.rows_a, L.rows_b, L.st, L.n / L.group, L.chunk / L.group,
      L.Kp, L.kdim, L.placement, L.h, L.loss);
  return static_cast<int>(cudaGetLastError());
}

template <int MODEL, int NS>
int launch_cw(const Launch& L, cudaStream_t stream) {
  if (L.Kp <= 32) return launch_with<MODEL, NS, 1>(L, stream);
  if (L.Kp <= 64) return launch_with<MODEL, NS, 2>(L, stream);
  return launch_with<MODEL, NS, 4>(L, stream);
}

// placement -1 takes seq_plan's; 0 and 1 force one (tests), and one the
// tables do not fit is refused
template <int MODEL>
int launch(int n_state, Launch L, cudaStream_t stream) {
  const int plan = seq_plan(L.rows_a, L.rows_b, (1 + n_state) * L.Kp * 4);
  if (L.placement == -1) L.placement = plan;
  if (L.group < 1 || L.group > MAX_GROUP || L.chunk % L.group ||
      L.n % L.chunk || L.Kp < 4 || L.Kp > 128 || L.Kp % 4 ||
      L.placement < 0 || L.placement > 1 || (L.placement == 1 && !plan))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n_state) {
    case 0: return launch_cw<MODEL, 0>(L, stream);
    case 1: return launch_cw<MODEL, 1>(L, stream);
    case 2: return launch_cw<MODEL, 2>(L, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The largest group (chain warps of the one block) the kernels take.
extern "C" int cymf_seq_epoch_max_group() { return MAX_GROUP; }

// Where a launch keeps tables of rows_a and rows_b fused rows of
// row_bytes: 1 the block's shared memory, 0 device memory.
extern "C" int cymf_seq_epoch_plan(int rows_a, int rows_b, int row_bytes) {
  return seq_plan(rows_a, rows_b, row_bytes);
}

extern "C" int cymf_bpr_seq_epoch(float* W, float* H, int rows_w, int rows_h,
                                  const int* u, const int* i, const int* j,
                                  const int* keep, long long n, int chunk,
                                  int group, int placement, int Kp,
                                  int n_state, float lr, float wd, float b1,
                                  float omb1, float b2, float omb2, float eps,
                                  float* loss, cudaStream_t stream) {
  const Launch L{W, H, rows_w, rows_h, {u, i, j, nullptr, nullptr, keep},
                 n, chunk, group, placement, Kp, 0,
                 {lr, wd, b1, omb1, b2, omb2, eps}, loss};
  return launch<BPR>(n_state, L, stream);
}

extern "C" int cymf_relmf_seq_epoch(float* W, float* H, int rows_w,
                                    int rows_h, const int* u, const int* i,
                                    const float* w, const int* keep,
                                    long long n, int chunk, int group,
                                    int placement, int Kp, int n_state,
                                    float lr, float wd, float b1, float omb1,
                                    float b2, float omb2, float eps,
                                    float* loss, cudaStream_t stream) {
  const Launch L{W, H, rows_w, rows_h, {u, i, nullptr, w, nullptr, keep},
                 n, chunk, group, placement, Kp, 0,
                 {lr, wd, b1, omb1, b2, omb2, eps}, loss};
  return launch<RELMF>(n_state, L, stream);
}

extern "C" int cymf_glove_seq_epoch(float* Wc, float* Wx, int rows_c,
                                    int rows_x, const int* c, const int* x,
                                    const float* f, const float* logcnt,
                                    const int* keep, long long n, int chunk,
                                    int group, int placement, int Kp,
                                    int kdim, float lr, float* loss,
                                    cudaStream_t stream) {
  const Launch L{Wc, Wx, rows_c, rows_x, {c, x, nullptr, f, logcnt, keep},
                 n, chunk, group, placement, Kp, kdim,
                 {lr, 0.f, 0.f, 1.f, 0.f, 1.f, 0.f}, loss};
  return launch<GLOVE>(1, L, stream);
}
