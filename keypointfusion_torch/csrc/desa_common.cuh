// Device code shared by the DESA kernels (csrc/desa_dense.cu = K1
// 'highest', csrc/desa_dense_serving.cu = K1 'default',
// csrc/grouped_mlp_pool.cu = K3). Each runs one block per (joint j, batch
// element b) and one thread per channel c (C = 128), so threadIdx.x is the
// channel throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace desa {

constexpr int kC = 128;  // channels == threads per block
constexpr int kT = 16;   // group slots per tile

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// x rounded to bfloat16, as a float
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// s_d2[m] for the joint at q and every support point m (the N cloud points
// of pxyz, then the J joints of nxyz):
//   (|q|^2 + |x_m|^2) - 2 q.x_m, clamped at 0,
// rounded step by step as ops/pairwise.py says, so ball membership matches
// the plain versions exactly. The caller syncs before reading s_d2.
__device__ __forceinline__ void support_sq_dists(float* s_d2,
                                                 const float* pxyz,
                                                 const float* nxyz, int n,
                                                 int m_total, float qx,
                                                 float qy, float qz) {
  const float q2 = sqnorm3(qx, qy, qz);
  for (int m = threadIdx.x; m < m_total; m += kC) {
    const float* x = m < n ? pxyz + 3 * m : nxyz + 3 * (m - n);
    const float sx = x[0], sy = x[1], sz = x[2];
    const float cross =
        __fmaf_rn(qz, sz, __fmaf_rn(qy, sy, __fmul_rn(qx, sx)));
    const float d =
        __fsub_rn(__fadd_rn(q2, sqnorm3(sx, sy, sz)), __fmul_rn(2.0f, cross));
    s_d2[m] = fmaxf(d, 0.0f);
  }
}

// The group of one radius, written by warp 0: the first s_max support
// points with d2 < r_sq in storage order (32-wide ballots with a running
// count), or the closest point, lowest index among equals, when the ball
// is empty. s_sel[0, *s_nsel) gets the indices. The caller syncs after.
__device__ __forceinline__ void select_group(const float* s_d2, int m_total,
                                             float r_sq, int s_max,
                                             int* s_sel, int* s_nsel) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  int cnt = 0;
  for (int base = 0; base < m_total && cnt < s_max; base += 32) {
    const int m = base + lane;
    const bool in = m < m_total && s_d2[m] < r_sq;
    const unsigned ball = __ballot_sync(0xffffffffu, in);
    const int rank = cnt + __popc(ball & ((1u << lane) - 1u));
    if (in && rank < s_max) s_sel[rank] = m;
    cnt += __popc(ball);
  }
  if (cnt == 0) {
    float bd = __int_as_float(0x7f800000);
    int bi = 0x7fffffff;
    for (int m = lane; m < m_total; m += 32) {
      if (s_d2[m] < bd) {
        bd = s_d2[m];
        bi = m;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_down_sync(0xffffffffu, bd, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (lane == 0) s_sel[0] = bi;
    cnt = 1;
  }
  if (lane == 0) *s_nsel = min(cnt, s_max);
}

// acc[t] += sum over k of w[k * kC] * x[k * kT + t], in order of k: one
// output channel of a [kC, kC] Dense (w points at its column) for the kT
// slots of a tile staged in shared memory as [channel][slot]. Each weight
// the thread loads serves kT slots, and the slot values come as broadcast
// float4 loads. kRoundW rounds each weight to bfloat16 first.
template <bool kRoundW>
__device__ __forceinline__ void tile_dense(const float* __restrict__ w,
                                           const float* x,
                                           float (&acc)[kT]) {
#pragma unroll 4
  for (int k = 0; k < kC; ++k) {
    float wk = __ldg(w + k * kC);
    if (kRoundW) wk = bf(wk);
    const float4* xv = reinterpret_cast<const float4*>(x + k * kT);
#pragma unroll
    for (int q = 0; q < kT / 4; ++q) {
      const float4 v = xv[q];
      acc[4 * q + 0] = fmaf(wk, v.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(wk, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(wk, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(wk, v.w, acc[4 * q + 3]);
    }
  }
}

}  // namespace desa
