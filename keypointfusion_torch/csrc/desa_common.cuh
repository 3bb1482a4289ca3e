// Device code shared by the DESA kernels: the channel width and the
// rounding of |x|^2. d2 and the group selection of both K1 kernels, and
// the tensor-core helpers of K1 'highest' and K3, are in csrc/desa_mma.cuh.

#pragma once

#include <cuda_runtime.h>

namespace desa {

constexpr int kC = 128;  // channels

// x^2 + y^2 + z^2, each product and sum rounded to float32 in that order
__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

}  // namespace desa
