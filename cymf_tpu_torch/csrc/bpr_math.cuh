// The per-sample math of every packed BPR kernel: the v4 sample phase
// (bpr_sample.cu) and the v5-v8 pipelines (bpr_fused.cu).  One device
// function, so that all five round alike.  Internal linkage, like
// reduce.cuh.
//
// One warp works on one sample; lane t holds columns [4t, 4t + 4).  From the
// decorated packed W row Du (payload lanes [0, cb), lanes [cb, cb + s) =
// mask * onehot(slot)) and the logical item rows hi, hj (payload [0, K)):
//   wu   = the user's K-wide slot, moved to lanes [0, K)
//   x    = wu . (hi - hj),  sig = sigmoid(-x)
//   loss = (-log sigmoid(x) + wd (|wu|^2 + |hi|^2 + |hj|^2)) * mask
//   SW   = sig (hi - hj) placed in the slot's lanes, the count channel
//          copied, and the loss added on `loss_lane` (v6-v8) if it is >= 0
//   Q    = sig wu on lanes < K, mask on lane K
// as the TPU kernels compute them (cymf_tpu/ops/fused_sample.py,
// cymf_tpu/ops/fused_step.py), their lane rotations read from a per-warp
// shared copy of the row.  The two sums over the s slots (wu, and the
// rotated placement of SW) run the lane's four columns side by side, each
// column's terms in the same order as alone, so the same bits: four
// independent chains of shared reads and FMAs, where one chain a column
// was the latency that set these kernels' pace.
#pragma once

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace cymf {
namespace {

constexpr int BPR_LANES = 128;

// r: the warp's shared copy of Du (128 floats, written before the call and
// visible to the warp); v: per-warp shared scratch of 128 floats; u, hi, hj:
// this lane's four columns of Du and of the item rows.  The count channel is
// lanes [cb, cmask_hi): v4 takes every lane >= cb (128), v5-v8 [cb, cb + s).
// Writes this lane's columns of SW (o) and Q (qo) and returns the sample's
// loss, the same on every lane.
__device__ __forceinline__ float bpr_sample_math(
    const float* r, float* v, const float u[4], const float hi[4],
    const float hj[4], int c0, int K, int s, int cb, int cmask_hi, float wd,
    int loss_lane, float o[4], float qo[4]) {
  // wu[l] = sum_c Du[cb + c] * Du[l + c K] for l < K, the four columns'
  // sums side by side (each in the same order as one column alone)
  float wu[4], diff[4];
  const float r0 = r[cb];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wu[k] = c0 + k < K ? r0 * r[c0 + k] : 0.f;
  for (int c = 1; c < s; ++c) {
    const float rc = r[cb + c];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < K) wu[k] += rc * r[c0 + k + c * K];
  }
  float x = 0.f, l2 = 0.f, m = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = c0 + k;
    const float w = wu[k];
    diff[k] = hi[k] - hj[k];
    x += w * diff[k];
    l2 += w * w + hi[k] * hi[k] + hj[k] * hj[k];
    if (l >= cb && l < cmask_hi) m += u[k];  // the channel sums to the mask
  }
  x = warp_sum(x);
  l2 = warp_sum(l2);
  m = warp_sum(m);
  const float sig = 1.f / (1.f + expf(x));
  // -log sigmoid(x) = softplus(-x), in its overflow-free form
  const float nls = fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x)));
  const float loss = (nls + wd * l2) * m;

#pragma unroll
  for (int k = 0; k < 4; ++k) v[c0 + k] = sig * diff[k];
  __syncwarp();
  // slot c's lanes receive vals rotated right by c K (lane-wise as the TPU
  // kernel's roll, wrapping at 128); the four columns side by side
  float acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    acc[k] = (c0 + k >= cb && c0 + k < cmask_hi) ? u[k] : 0.f;
  for (int c = 0; c < s; ++c) {
    const float rc = r[cb + c];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] += rc * v[(c0 + k - c * K) & (BPR_LANES - 1)];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = c0 + k;
    if (l == loss_lane) acc[k] += loss;
    o[k] = acc[k];
    qo[k] = sig * wu[k] + (l == K ? m : 0.f);
  }
  __syncwarp();  // r and v are rewritten for the next sample
  return loss;
}

}  // namespace
}  // namespace cymf
