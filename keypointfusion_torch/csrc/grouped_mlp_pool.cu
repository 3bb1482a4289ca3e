// K3: grouped DESA MLP + max-pool over pre-gathered groups, float32, for
// sm_90a.
//
// Replaces keypointfusion_tpu/kernels/desa_pallas.py:grouped_mlp_pool (the
// pl.pallas_call at line 97). One block per (joint j, batch element b),
// one thread per channel c (C = 128), over the S slots of the group:
//   h1[t] = relu((rel_t Wl + bl) + ((g_t - node) Wf + bf))
//   h2[t] = relu(h1[t] W2 + b2)
//   out   = max of h2 over the slots t with |rel_t|^2 < 1, or t = 0
// rel arrives divided by the radius, the weights BN-folded in Dense layout
// [in, out] (kernels/grouped_mlp_pool.py). The kept slots are recomputed
// from rel, as the JAX kernel recomputes them.
//
// What bounds it on the H100: float32 operations. At the serving shape
// (B=64, J=21, S=64, C=128) one radius is 2*(2*128*128 + 3*128) flops per
// slot, 5.7 GFLOP, a twelfth of a millisecond at the card's float32 peak;
// its input is the 44 MB grouped tensor, 13 microseconds. One thread per
// output channel on the CUDA cores, with the tile product of
// csrc/desa_common.cuh: tiles of kT = 16 slots
// staged in shared memory as [channel][slot], so each weight a thread
// loads serves 16 slots and the 16 slot values come as four broadcast
// float4 loads; h1 stays in shared memory; the only write is [B,J,C].

#include <cuda_runtime.h>

#include "desa_common.cuh"

namespace {

using desa::kC;
using desa::kT;

__global__ void __launch_bounds__(kC)
grouped_mlp_pool_kernel(const float* __restrict__ rel,      // [B,J,S,3]
                        const float* __restrict__ grouped,  // [B,J,S,C]
                        const float* __restrict__ node,     // [B,J,C]
                        const float* __restrict__ wl,       // [3,C]
                        const float* __restrict__ bl,       // [C]
                        const float* __restrict__ wf,       // [C,C]
                        const float* __restrict__ bf,       // [C]
                        const float* __restrict__ w2,       // [C,C]
                        const float* __restrict__ b2,       // [C]
                        float* __restrict__ out,            // [B,J,C]
                        int j_num, int s) {
  __shared__ __align__(16) float s_x[kC * kT];  // g_t - node
  __shared__ __align__(16) float s_h[kC * kT];  // h1
  __shared__ float s_rel[kT * 3];

  const int j = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const size_t group = static_cast<size_t>(b) * j_num + j;
  const float* rel_g = rel + group * s * 3;
  const float* feat_g = grouped + group * s * kC;
  const float node_c = node[group * kC + c];
  const float wl0 = wl[c], wl1 = wl[kC + c], wl2 = wl[2 * kC + c];
  const float bias_l = bl[c], bias_f = bf[c], bias2 = b2[c];

  float mx = __int_as_float(0xff800000);                 // -inf
  for (int t0 = 0; t0 < s; t0 += kT) {
    const int nt = min(kT, s - t0);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      s_x[c * kT + t] =
          t < nt ? __fsub_rn(feat_g[static_cast<size_t>(t0 + t) * kC + c],
                             node_c)
                 : 0.0f;
    }
    if (c < kT * 3) s_rel[c] = c / 3 < nt ? rel_g[t0 * 3 + c] : 0.0f;
    __syncthreads();

    float acc[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[t] = 0.0f;
    desa::tile_dense(wf + c, s_x, acc);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float loc = fmaf(wl2, s_rel[3 * t + 2],
                             fmaf(wl1, s_rel[3 * t + 1],
                                  __fmul_rn(wl0, s_rel[3 * t])));
      s_h[c * kT + t] = fmaxf(
          __fadd_rn(__fadd_rn(loc, bias_l), __fadd_rn(acc[t], bias_f)), 0.0f);
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kT; ++t) acc[t] = 0.0f;
    desa::tile_dense(w2 + c, s_h, acc);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float x = s_rel[3 * t], y = s_rel[3 * t + 1], z = s_rel[3 * t + 2];
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      const bool keep = t0 + t == 0 || d2 < 1.0f;
      if (t < nt && keep) {
        mx = fmaxf(mx, fmaxf(__fadd_rn(acc[t], bias2), 0.0f));
      }
    }
    __syncthreads();  // the next tile overwrites s_x, s_rel and s_h
  }
  out[group * kC + c] = mx;
}

}  // namespace

extern "C" int kpf_grouped_mlp_pool(const float* rel, const float* grouped,
                                    const float* node, const float* wl,
                                    const float* bl, const float* wf,
                                    const float* bf, const float* w2,
                                    const float* b2, float* out, int b,
                                    int j, int s, cudaStream_t stream) {
  const dim3 grid(j, b);
  grouped_mlp_pool_kernel<<<grid, kC, 0, stream>>>(rel, grouped, node, wl,
                                                   bl, wf, bf, w2, b2, out, j,
                                                   s);
  return static_cast<int>(cudaGetLastError());
}
