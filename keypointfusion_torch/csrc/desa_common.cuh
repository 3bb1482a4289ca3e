// Device code shared by the DESA kernels: the channel width, the rounding
// of |x|^2, and K3's (csrc/grouped_mlp_pool.cu) tile product on the CUDA
// cores. d2 and the group selection of both K1 kernels are in
// csrc/desa_mma.cuh. K3 runs one block per (joint j, batch element b) and
// one thread per channel c (C = 128), so threadIdx.x is the channel there.

#pragma once

#include <cuda_runtime.h>

namespace desa {

constexpr int kC = 128;  // channels
constexpr int kT = 16;   // K3's group slots per tile

// x^2 + y^2 + z^2, each product and sum rounded to float32 in that order
__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// acc[t] += sum over k of w[k * kC] * x[k * kT + t], in order of k: one
// output channel of a [kC, kC] Dense (w points at its column) for the kT
// slots of a tile staged in shared memory as [channel][slot]. Each weight
// the thread loads serves kT slots, and the slot values come as broadcast
// float4 loads.
__device__ __forceinline__ void tile_dense(const float* __restrict__ w,
                                           const float* x,
                                           float (&acc)[kT]) {
#pragma unroll 4
  for (int k = 0; k < kC; ++k) {
    const float wk = __ldg(w + k * kC);
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
