// Probe kernels on Hopper (sm_90a): three measurements beside the BPR
// sample phase and the step's gathers.
//
// P1 replaces scripts/r5_kernel_variant.py::phase_v4r (_kernel_v4r): the
// v4 sample phase (bpr_sample.cu's function: SW, Q and the step's loss
// from the decorated packed W rows and the logical item rows) with a
// leaner mix of reductions.  The mask column rides the x reduction (one
// float2 warp reduction instead of two float ones) and the l2 term goes
// straight into the block's loss partial, with no per-row reduce.  x, and
// so SW and Q, are reduced in the same butterfly order as bpr_sample.cu's,
// so they come out equal; the loss is summed in another grouping (float32
// round-off).  The script masks the item rows' squares to lanes < K;
// logical item rows are zero there, so P1 sums whole rows as #1 does.
//
// P2 replaces scripts/r5_probes.py::copy_phase (_copy_kernel): the
// streaming floor under the sample phase.  It reads the three (B, 128)
// tiles and writes Du + Di, Di - Dj and a zero (8, 128) loss block.
//
// P3 replaces scripts/roofline_gather.py::pallas_gather: out[k] =
// T[idx[k]] for a (R, W) float32 table.  The TPU kernel issues one DMA a
// row with q in flight on semaphores; here persistent warps keep a batch
// of whole rows' float4 loads in flight before their stores (gather_kernel
// below).  Ids outside [0, R) read nothing and give zero rows.  A form with
// one TMA bulk copy a row into a shared-memory ring and one bulk store a
// stage was measured beside it and lost or tied at every site (PERF.md's
// findings): ~1,000 row copies an SM a call left it issue-bound.
//
// Bounds on the H100: memory, all three.  P1 and P2 read 3 and write 2
// (B, 128) f32 tiles (~10 and ~1 flops an element); P3 reads the ids and
// each distinct row once and writes B rows.

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

using cymf::FULL_MASK;
using cymf::sum_partials_kernel;
using cymf::SUM_THREADS;
using cymf::warp_sum;

constexpr int LANES = 128;
constexpr int WARPS = 8;
constexpr int SAMPLES_PER_WARP = 8;
constexpr int SAMPLES_PER_BLOCK = WARPS * SAMPLES_PER_WARP;

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(FULL_MASK, v.x, o);
    v.y += __shfl_xor_sync(FULL_MASK, v.y, o);
  }
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
phase_v4r_kernel(const float* __restrict__ du, const float* __restrict__ di,
                 const float* __restrict__ dj, float* __restrict__ sw,
                 float* __restrict__ q, float* __restrict__ partials, int B,
                 int K, int s, int cb, float wd) {
  __shared__ float row[WARPS][LANES];   // the warp's decorated W row
  __shared__ float vals[WARPS][LANES];  // sig * (hi - hj)
  __shared__ float warp_loss[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = lane * 4;
  float* r = row[warp];
  float* v = vals[warp];
  float loss_acc = 0.f;  // this lane's share of the block's loss
  const int first = blockIdx.x * SAMPLES_PER_BLOCK + warp * SAMPLES_PER_WARP;

  for (int n = 0; n < SAMPLES_PER_WARP; ++n) {
    const int b = first + n;
    if (b >= B) break;  // uniform across the warp
    const size_t off = static_cast<size_t>(b) * LANES + c0;
    const float4 u4 = *reinterpret_cast<const float4*>(du + off);
    const float4 i4 = *reinterpret_cast<const float4*>(di + off);
    const float4 j4 = *reinterpret_cast<const float4*>(dj + off);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    const float hi[4] = {i4.x, i4.y, i4.z, i4.w};
    const float hj[4] = {j4.x, j4.y, j4.z, j4.w};
    *reinterpret_cast<float4*>(r + c0) = u4;
    __syncwarp();
    float wu[4], diff[4];
    float2 zm = make_float2(0.f, 0.f);  // (x, mask) partials
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = c0 + k;
      float w = 0.f;
      if (l < K) {  // wu[l] = sum_c Du[cb + c] * Du[l + c K]
        w = r[cb] * r[l];
        for (int c = 1; c < s; ++c) w += r[cb + c] * r[l + c * K];
      }
      wu[k] = w;
      diff[k] = hi[k] - hj[k];
      zm.x += w * diff[k];
      sq += w * w + hi[k] * hi[k] + hj[k] * hj[k];
      if (l >= cb) zm.y += u[k];  // the channel sums to the mask
    }
    zm = warp_sum2(zm);
    const float x = zm.x, m = zm.y;
    const float sig = 1.f / (1.f + expf(x));
    loss_acc += wd * sq * m;
    if (lane == 0)  // -log sigmoid(x) = softplus(-x), overflow-free
      loss_acc += (fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x)))) * m;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[c0 + k] = sig * diff[k];
    __syncwarp();
    float o[4], qo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = c0 + k;
      float acc = l >= cb ? u[k] : 0.f;
      for (int c = 0; c < s; ++c)
        acc += r[cb + c] * v[(l - c * K) & (LANES - 1)];
      o[k] = acc;
      qo[k] = sig * wu[k] + (l == K ? m : 0.f);
    }
    __syncwarp();  // r and v are rewritten for the next sample
    *reinterpret_cast<float4*>(sw + off) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(q + off) =
        make_float4(qo[0], qo[1], qo[2], qo[3]);
  }
  loss_acc = warp_sum(loss_acc);
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += warp_loss[w];
    partials[blockIdx.x] = t;
  }
}

constexpr int COPY_THREADS = 256;

__global__ void __launch_bounds__(COPY_THREADS)
copy_phase_kernel(const float4* __restrict__ du, const float4* __restrict__ di,
                  const float4* __restrict__ dj, float4* __restrict__ sw,
                  float4* __restrict__ q, float4* __restrict__ lossb,
                  size_t n4) {
  const size_t stride = static_cast<size_t>(gridDim.x) * COPY_THREADS;
  size_t t = static_cast<size_t>(blockIdx.x) * COPY_THREADS + threadIdx.x;
  if (t < 8 * LANES / 4) lossb[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (; t < n4; t += stride) {
    const float4 a = du[t], b = di[t], c = dj[t];
    sw[t] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    q[t] = make_float4(b.x - c.x, b.y - c.y, b.z - c.z, b.w - c.w);
  }
}

// P3: persistent warps walk batches of NR consecutive output rows (batch
// b goes to global warp b mod the grid's warps).  Lane j < NR holds row
// j's id, fetched one batch ahead; the warp loads every float4 of its NR
// rows (C a lane a row; wider rows in further passes of 32 C float4)
// through the non-coherent path before it stores any, and stores them
// streaming (__stcs), so a warp keeps NR x C 16-byte loads a lane in
// flight at any width.  NR x C <= 32 keeps the values in registers.
constexpr int GATHER_THREADS = 256;

template <int NR, int C>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
              float4* __restrict__ out, int B, int R, int w4) {
  const int lane = threadIdx.x & 31;
  const long long gw =
      (static_cast<long long>(blockIdx.x) * GATHER_THREADS + threadIdx.x) >>
      5;
  const long long nwarps =
      (static_cast<long long>(gridDim.x) * GATHER_THREADS) >> 5;
  const long long batches = (static_cast<long long>(B) + NR - 1) / NR;
  auto batch_id = [&](long long b) {  // lane j: row j of batch b's id
    const long long r = b * NR + lane;
    return b < batches && lane < NR && r < B ? __ldg(idx + r) : -1;
  };
  int next = batch_id(gw);
  for (long long b = gw; b < batches; b += nwarps) {
    const int cur = next;
    next = batch_id(b + nwarps);
    const long long b0 = b * NR;
    int src[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int r = __shfl_sync(FULL_MASK, cur, j);
      src[j] = r >= 0 && r < R ? r : -1;
    }
    for (int c0 = 0; c0 < w4; c0 += 32 * C) {
      float4 v[NR][C];
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = c0 + c * 32 + lane;
          v[j][c] = src[j] >= 0 && col < w4
                        ? __ldg(table + static_cast<size_t>(src[j]) * w4 + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = c0 + c * 32 + lane;
          if (b0 + j < B && col < w4)
            __stcs(out + static_cast<size_t>(b0 + j) * w4 + col, v[j][c]);
        }
    }
  }
}

// The instantiations: NR rows a batch (1-16) by C float4 a lane a row
// (1-8), NR x C <= 32.  Returns the kernel, or nullptr for another pair.
using GatherFn = void (*)(const float4*, const int*, float4*, int, int, int);

template <int C>
GatherFn gather_fn_c(int nr) {
  switch (nr) {
    case 1: return gather_kernel<1, C>;
    case 2: return gather_kernel<2, C>;
    case 4: return gather_kernel<4, C>;
    case 8:
      if constexpr (C <= 4) return gather_kernel<8, C>;
      break;
    case 16:
      if constexpr (C <= 2) return gather_kernel<16, C>;
      break;
  }
  return nullptr;
}

GatherFn gather_fn(int nr, int c) {
  switch (c) {
    case 1: return gather_fn_c<1>(nr);
    case 2: return gather_fn_c<2>(nr);
    case 4: return gather_fn_c<4>(nr);
    case 8: return gather_fn_c<8>(nr);
  }
  return nullptr;
}

}  // namespace

// Number of loss partials (one per block) P1 needs for B rows.
extern "C" int cymf_phase_v4r_blocks(int B) {
  return (B + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK;
}

extern "C" int cymf_phase_v4r(const float* du, const float* di,
                              const float* dj, float* sw, float* q,
                              float* partials, float* loss, int B, int K,
                              int s, int cb, float wd, cudaStream_t stream) {
  const int blocks = cymf_phase_v4r_blocks(B);
  if (blocks > 0)
    phase_v4r_kernel<<<blocks, WARPS * 32, 0, stream>>>(
        du, di, dj, sw, q, partials, B, K, s, cb, wd);
  sum_partials_kernel<<<1, SUM_THREADS, 0, stream>>>(partials, blocks, loss);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cymf_copy_phase(const float* du, const float* di,
                               const float* dj, float* sw, float* q,
                               float* lossb, long long n, int sms,
                               cudaStream_t stream) {
  const size_t n4 = static_cast<size_t>(n) / 4;
  const size_t need = (n4 + COPY_THREADS - 1) / COPY_THREADS;
  const int blocks = static_cast<int>(
      need < static_cast<size_t>(8 * sms) ? (need > 0 ? need : 1) : 8 * sms);
  copy_phase_kernel<<<blocks, COPY_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(du), reinterpret_cast<const float4*>(di),
      reinterpret_cast<const float4*>(dj), reinterpret_cast<float4*>(sw),
      reinterpret_cast<float4*>(q), reinterpret_cast<float4*>(lossb), n4);
  return static_cast<int>(cudaGetLastError());
}

// P3's blocks an SM for `rows` rows a batch and `lane4` float4 a lane a
// row (probes.gather_plan sizes the grid from it); negative: no such
// kernel, or the CUDA error, negated.
extern "C" int cymf_gather_rows_occupancy(int rows, int lane4) {
  const GatherFn fn = gather_fn(rows, lane4);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, GATHER_THREADS, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// P3 with probes.gather_plan's launch: `rows` rows a warp's batch,
// `lane4` float4 a lane a row, `blocks` blocks of GATHER_THREADS.
extern "C" int cymf_gather_rows(const float* table, const int* idx,
                                float* out, int B, int R, int width, int rows,
                                int lane4, int blocks, cudaStream_t stream) {
  const GatherFn fn = gather_fn(rows, lane4);
  if (fn == nullptr || width < 4 || width % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && blocks > 0)
    fn<<<blocks, GATHER_THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), B, R, width / 4);
  return static_cast<int>(cudaGetLastError());
}
