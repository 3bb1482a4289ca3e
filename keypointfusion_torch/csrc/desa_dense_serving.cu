// K1 serving mode: whole-DESA eval pass, bfloat16 operands, float32 sums,
// gather form, for sm_90a.
//
// Replaces keypointfusion_tpu/kernels/desa_dense_pallas.py:desa_dense_fused
// in its 'default' mode (the pl.pallas_call at line 257 with bfloat16
// MLP operands). One block per (joint j, batch element b), one thread per
// channel c (C = 128); support = the N cloud points followed by the J
// joints; features arrive in bfloat16, coordinates and the BN-folded
// weights (Dense layout [in, out]) in float32. bf() rounds a float32 to
// bfloat16.
//   d2 and the groups: the 'highest' kernel's own code
//     (csrc/desa_common.cuh), so ball membership matches it bit for bit
//   per radius r_i, with inv_r = float32(1/r_i):
//     b_j[c] = (f_j Wf_i + (x_j Wl_i) * inv_r)[c] - b1_i[c]   float32
//     A_m[c] = (f_m bf(Wf_i))[c] + (x_m Wl_i)[c] * inv_r      float32 sums
//     h1     = relu(A_m - b_j),  h2 = relu(bf(h1) bf(W2_i) + b2_i)
//     out_i  = max of h2 over the group
//   out = relu(bf([out_0 | out_1 | out_2 | f_j]) bf(Wfu) + bfu), float32
// That is the JAX kernel's split form (its A_i - B_i[j]) at the points
// where it rounds to bfloat16; the 'highest' kernel's (f_m - f_j) Wf would
// round another quantity.
//
// What bounds it on the H100: operations. At the serving shape a full
// group costs 2*(2*128*128 + 3*128) flops per slot, some 17 GFLOP per
// call, against ~20 MB of inputs; A_m depends only on the point and the
// radius, so the least work computes it once per point a group holds,
// and the card's bfloat16 tensor-core rate would take some 15
// microseconds, the bytes 6. This kernel multiplies the bfloat16 values
// in float32 on the CUDA cores, in the 'highest' kernel's design and on
// its tile product (csrc/desa_common.cuh: tiles of kT = 16 group slots
// staged in shared memory as [channel][slot], each weight a thread loads
// serving 16 slots, h1 kept in shared memory, the 512 -> 128 fusion in the
// same block); it computes A_m per group slot, one product per slot like
// the 'highest' kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "desa_common.cuh"

namespace {

using desa::bf;
using desa::kC;
using desa::kT;
constexpr int kS = 64;   // most group slots per radius
constexpr int kR = 3;    // radii

struct Scales {
  float inv_r[kR];
  float r_sq[kR];
  int s[kR];
};

// d2 in a call of its own: with it inlined this kernel measured 6% slower
// on the H100 at the serving shape (1.00 against 0.95 ms), while the
// 'highest' kernel is the faster with it inlined
__device__ __noinline__ void sq_dists(float* s_d2, const float* pxyz,
                                      const float* nxyz, int n, int m_total,
                                      float qx, float qy, float qz) {
  desa::support_sq_dists(s_d2, pxyz, nxyz, n, m_total, qx, qy, qz);
}

__global__ void __launch_bounds__(kC)
desa_dense_serving_kernel(const __nv_bfloat16* __restrict__ pcl_feat,
                          const __nv_bfloat16* __restrict__ node_feat,
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
  __shared__ __align__(16) float s_x[kC * kT];          // bf16 f_m values
  __shared__ __align__(16) float s_h[kC * kT];          // bf(h1)
  __shared__ float s_xyz[kT * 3];
  __shared__ float s_fj[kC];
  __shared__ int s_sel[kS];
  __shared__ float s_cat[(kR + 1) * kC];
  __shared__ int s_nsel;

  const int j = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int m_total = n + j_num;
  const float* pxyz = pcl_xyz + static_cast<size_t>(b) * n * 3;
  const float* nxyz = node_xyz + static_cast<size_t>(b) * j_num * 3;
  const __nv_bfloat16* pfeat = pcl_feat + static_cast<size_t>(b) * n * kC;
  const __nv_bfloat16* nfeat = node_feat + static_cast<size_t>(b) * j_num * kC;
  const float qx = nxyz[3 * j], qy = nxyz[3 * j + 1], qz = nxyz[3 * j + 2];
  const float fj = __bfloat162float(nfeat[static_cast<size_t>(j) * kC + c]);
  s_fj[c] = fj;

  sq_dists(s_d2, pxyz, nxyz, n, m_total, qx, qy, qz);
  __syncthreads();

  for (int i = 0; i < kR; ++i) {
    desa::select_group(s_d2, m_total, sc.r_sq[i], sc.s[i], s_sel, &s_nsel);
    __syncthreads();
    const int nsel = s_nsel;

    const float* wf_i = wf + static_cast<size_t>(i) * kC * kC;
    const float* w2_i = w2 + static_cast<size_t>(i) * kC * kC;
    const float inv_r = sc.inv_r[i];
    const float bias2 = b2[i * kC + c];
    const float wl0 = wl[(i * 3 + 0) * kC + c];
    const float wl1 = wl[(i * 3 + 1) * kC + c];
    const float wl2 = wl[(i * 3 + 2) * kC + c];
    // the joint's own term, float32 weights and products
    float fterm = 0.0f;
    for (int k = 0; k < kC; ++k) {
      fterm = fmaf(s_fj[k], __ldg(wf_i + k * kC + c), fterm);
    }
    const float lterm = fmaf(wl2, qz, fmaf(wl1, qy, __fmul_rn(wl0, qx)));
    const float bj = __fsub_rn(__fadd_rn(fterm, __fmul_rn(lterm, inv_r)),
                               b1[i * kC + c]);

    float mx = __int_as_float(0xff800000);              // -inf
    for (int t0 = 0; t0 < nsel; t0 += kT) {
      const int nt = min(kT, nsel - t0);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        float v = 0.0f;
        if (t < nt) {
          const int m = s_sel[t0 + t];
          v = __bfloat162float(m < n
                                   ? pfeat[static_cast<size_t>(m) * kC + c]
                                   : nfeat[static_cast<size_t>(m - n) * kC + c]);
        }
        s_x[c * kT + t] = v;
      }
      if (c < kT * 3) {
        const int t = c / 3, d = c % 3;
        float v = 0.0f;
        if (t < nt) {
          const int m = s_sel[t0 + t];
          v = (m < n ? pxyz + 3 * m : nxyz + 3 * (m - n))[d];
        }
        s_xyz[c] = v;
      }
      __syncthreads();

      float acc[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) acc[t] = 0.0f;
      desa::tile_dense<true>(wf_i + c, s_x, acc);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const float loc = fmaf(wl2, s_xyz[3 * t + 2],
                               fmaf(wl1, s_xyz[3 * t + 1],
                                    __fmul_rn(wl0, s_xyz[3 * t])));
        const float a = __fadd_rn(acc[t], __fmul_rn(loc, inv_r));
        s_h[c * kT + t] = bf(fmaxf(__fsub_rn(a, bj), 0.0f));
      }
      __syncthreads();

#pragma unroll
      for (int t = 0; t < kT; ++t) acc[t] = 0.0f;
      desa::tile_dense<true>(w2_i + c, s_h, acc);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < nt) mx = fmaxf(mx, fmaxf(__fadd_rn(acc[t], bias2), 0.0f));
      }
      __syncthreads();  // the next tile overwrites s_x, s_xyz and s_h
    }
    s_cat[i * kC + c] = bf(mx);
  }
  s_cat[kR * kC + c] = fj;
  __syncthreads();

  float acc = 0.0f;
  for (int k = 0; k < (kR + 1) * kC; ++k) {
    acc = fmaf(bf(__ldg(wfu + k * kC + c)), s_cat[k], acc);
  }
  out[(static_cast<size_t>(b) * j_num + j) * kC + c] =
      fmaxf(__fadd_rn(acc, bfu[c]), 0.0f);
}

}  // namespace

extern "C" int kpf_desa_dense_serving(
    const __nv_bfloat16* pcl_feat, const __nv_bfloat16* node_feat,
    const float* pcl_xyz, const float* node_xyz, const float* wf,
    const float* wl, const float* b1, const float* w2, const float* b2,
    const float* wfu, const float* bfu, float inv_r0, float inv_r1,
    float inv_r2, float r_sq0, float r_sq1, float r_sq2, int s0, int s1,
    int s2, float* out, int b, int n, int j, cudaStream_t stream) {
  Scales sc;
  sc.inv_r[0] = inv_r0;
  sc.inv_r[1] = inv_r1;
  sc.inv_r[2] = inv_r2;
  sc.r_sq[0] = r_sq0;
  sc.r_sq[1] = r_sq1;
  sc.r_sq[2] = r_sq2;
  sc.s[0] = s0;
  sc.s[1] = s1;
  sc.s[2] = s2;
  const dim3 grid(j, b);
  const size_t smem = static_cast<size_t>(n + j) * sizeof(float);
  desa_dense_serving_kernel<<<grid, kC, smem, stream>>>(
      pcl_feat, node_feat, pcl_xyz, node_xyz, wf, wl, b1, w2, b2, wfu, bfu,
      sc, out, n, j);
  return static_cast<int>(cudaGetLastError());
}
