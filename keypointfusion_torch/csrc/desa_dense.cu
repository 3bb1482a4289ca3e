// K1: whole-DESA eval pass, float32, gather form, for sm_90a.
//
// Replaces keypointfusion_tpu/kernels/desa_dense_pallas.py:desa_dense_fused
// (the pl.pallas_call of its 'highest' mode). One block per (joint j,
// batch element b), one thread per output channel c (C = 128). Support =
// the N cloud points followed by the J joints, M = N + J. BatchNorms come
// folded into the weights (kernels/desa_dense.py:fold_bn); weights are in
// Dense layout [in, out], so thread c reads column c and a warp's reads of
// one row are coalesced.
//   d2[m]   = (|x_j|^2 + |x_m|^2) - 2 x_j.x_m, clamped at 0, rounded
//             step by step as ops/pairwise.py says, so ball membership
//             matches the plain version exactly
//   for each radius r_i (3 of them):
//     group = the first S_i support points with d2 < r_i^2, in storage
//             order (warp 0: 32-wide ballots with a running count), or the
//             closest point, lowest index among equals, if none
//     h1[t]  = relu(b1_i + Wl_i^T (x_m - x_j)/r_i + Wf_i^T (f_m - f_j))
//     h2[t]  = relu(b2_i + W2_i^T h1[t]);  out_i = max over the group
//   out = relu(bfu + Wfu^T [out_0 | out_1 | out_2 | f_j])
//
// What bounds it on the H100: float32 operations. At the serving shape
// (B=64, N=1024, J=21, S=64) a full group costs 2*(2*128*128 + 3*128)
// flops per slot, about 17 GFLOP per call, against some 35 MB of inputs;
// strict float32 on the CUDA cores (no TF32) runs that in about a quarter
// of a millisecond at the card's peak, the bytes in about ten
// microseconds. The design spends its time on those products and little
// else:
//   * the TPU kernel pushed every one of the M support points through the
//     MLP and masked the max; here only the <= S_i group members are
//     gathered, so the work is what the data needs;
//   * the group is processed in tiles of kT = 16 slots staged in shared
//     memory as [channel][slot]; each weight a thread loads serves 16
//     slots, and the 16 slot values come as four broadcast float4 loads
//     (d2, the selection and the tile product are in desa_common.cuh);
//   * h1 never leaves shared memory, and the 512 -> 128 fusion layer runs
//     in the same block, so the only write to device memory is [B,J,C].

#include <cuda_runtime.h>

#include "desa_common.cuh"

namespace {

using desa::kC;
using desa::kT;
constexpr int kS = 64;   // most group slots per radius
constexpr int kR = 3;    // radii

struct Scales {
  float r[kR];
  float r_sq[kR];
  int s[kR];
};

__global__ void __launch_bounds__(kC)
desa_dense_kernel(const float* __restrict__ pcl_feat,   // [B,N,C]
                  const float* __restrict__ node_feat,  // [B,J,C]
                  const float* __restrict__ pcl_xyz,    // [B,N,3]
                  const float* __restrict__ node_xyz,   // [B,J,3]
                  const float* __restrict__ wf,         // [R,C,C]
                  const float* __restrict__ wl,         // [R,3,C]
                  const float* __restrict__ b1,         // [R,C]
                  const float* __restrict__ w2,         // [R,C,C]
                  const float* __restrict__ b2,         // [R,C]
                  const float* __restrict__ wfu,        // [(R+1)C,C]
                  const float* __restrict__ bfu,        // [C]
                  Scales sc, float* __restrict__ out,   // [B,J,C]
                  int n, int j_num) {
  extern __shared__ float s_d2[];                       // [M]
  __shared__ __align__(16) float s_x[kC * kT];          // f_m - f_j
  __shared__ __align__(16) float s_h[kC * kT];          // h1
  __shared__ float s_rel[kT * 3];
  __shared__ int s_sel[kS];
  __shared__ float s_cat[(kR + 1) * kC];
  __shared__ int s_nsel;

  const int j = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int m_total = n + j_num;
  const float* pxyz = pcl_xyz + static_cast<size_t>(b) * n * 3;
  const float* nxyz = node_xyz + static_cast<size_t>(b) * j_num * 3;
  const float* pfeat = pcl_feat + static_cast<size_t>(b) * n * kC;
  const float* nfeat = node_feat + static_cast<size_t>(b) * j_num * kC;
  const float qx = nxyz[3 * j], qy = nxyz[3 * j + 1], qz = nxyz[3 * j + 2];
  const float fj = nfeat[static_cast<size_t>(j) * kC + c];

  desa::support_sq_dists(s_d2, pxyz, nxyz, n, m_total, qx, qy, qz);
  __syncthreads();

  for (int i = 0; i < kR; ++i) {
    desa::select_group(s_d2, m_total, sc.r_sq[i], sc.s[i], s_sel, &s_nsel);
    __syncthreads();
    const int nsel = s_nsel;

    const float* wf_i = wf + static_cast<size_t>(i) * kC * kC;
    const float* w2_i = w2 + static_cast<size_t>(i) * kC * kC;
    const float bias1 = b1[i * kC + c], bias2 = b2[i * kC + c];
    const float wl0 = wl[(i * 3 + 0) * kC + c];
    const float wl1 = wl[(i * 3 + 1) * kC + c];
    const float wl2 = wl[(i * 3 + 2) * kC + c];
    float mx = __int_as_float(0xff800000);              // -inf
    for (int t0 = 0; t0 < nsel; t0 += kT) {
      const int nt = min(kT, nsel - t0);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        float v = 0.0f;
        if (t < nt) {
          const int m = s_sel[t0 + t];
          const float fm = m < n ? pfeat[static_cast<size_t>(m) * kC + c]
                                 : nfeat[static_cast<size_t>(m - n) * kC + c];
          v = __fsub_rn(fm, fj);
        }
        s_x[c * kT + t] = v;
      }
      if (c < kT * 3) {
        const int t = c / 3, d = c % 3;
        float v = 0.0f;
        if (t < nt) {
          const int m = s_sel[t0 + t];
          const float* x = m < n ? pxyz + 3 * m : nxyz + 3 * (m - n);
          const float q = d == 0 ? qx : (d == 1 ? qy : qz);
          v = __fdiv_rn(__fsub_rn(x[d], q), sc.r[i]);
        }
        s_rel[c] = v;
      }
      __syncthreads();

      float acc[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        acc[t] = fmaf(wl0, s_rel[3 * t], bias1);
        acc[t] = fmaf(wl1, s_rel[3 * t + 1], acc[t]);
        acc[t] = fmaf(wl2, s_rel[3 * t + 2], acc[t]);
      }
      desa::tile_dense<false>(wf_i + c, s_x, acc);
#pragma unroll
      for (int t = 0; t < kT; ++t) s_h[c * kT + t] = fmaxf(acc[t], 0.0f);
      __syncthreads();

#pragma unroll
      for (int t = 0; t < kT; ++t) acc[t] = bias2;
      desa::tile_dense<false>(w2_i + c, s_h, acc);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < nt) mx = fmaxf(mx, fmaxf(acc[t], 0.0f));
      }
      __syncthreads();  // the next tile overwrites s_x, s_rel and s_h
    }
    s_cat[i * kC + c] = mx;
  }
  s_cat[kR * kC + c] = fj;
  __syncthreads();

  float acc = bfu[c];
  for (int k = 0; k < (kR + 1) * kC; ++k) {
    acc = fmaf(__ldg(wfu + k * kC + c), s_cat[k], acc);
  }
  out[(static_cast<size_t>(b) * j_num + j) * kC + c] = fmaxf(acc, 0.0f);
}

}  // namespace

extern "C" int kpf_desa_dense(const float* pcl_feat, const float* node_feat,
                              const float* pcl_xyz, const float* node_xyz,
                              const float* wf, const float* wl,
                              const float* b1, const float* w2,
                              const float* b2, const float* wfu,
                              const float* bfu, float r0, float r1, float r2,
                              float r_sq0, float r_sq1, float r_sq2, int s0,
                              int s1, int s2, float* out, int b, int n,
                              int j, cudaStream_t stream) {
  Scales sc;
  sc.r[0] = r0;
  sc.r[1] = r1;
  sc.r[2] = r2;
  sc.r_sq[0] = r_sq0;
  sc.r_sq[1] = r_sq1;
  sc.r_sq[2] = r_sq2;
  sc.s[0] = s0;
  sc.s[1] = s1;
  sc.s[2] = s2;
  const dim3 grid(j, b);
  const size_t smem = static_cast<size_t>(n + j) * sizeof(float);
  desa_dense_kernel<<<grid, kC, smem, stream>>>(
      pcl_feat, node_feat, pcl_xyz, node_xyz, wf, wl, b1, w2, b2, wfu, bfu,
      sc, out, n, j);
  return static_cast<int>(cudaGetLastError());
}
