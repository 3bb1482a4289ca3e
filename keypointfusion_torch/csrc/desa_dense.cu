// K1 'highest': whole-DESA eval pass at float32 accuracy, gather form, on
// the tensor cores (three tf32 products per product), for sm_90a.
//
// Replaces keypointfusion_tpu/kernels/desa_dense_pallas.py:desa_dense_fused
// in its 'highest' mode (the pl.pallas_call at line 257 with a float32
// MLP), where the TPU's matrix unit emulates float32 in several bfloat16
// passes. Support = the N cloud points followed by the J joints;
// BatchNorms come folded into the weights (kernels/desa_dense.py:fold_bn).
// Per radius r_i:
//   d2 and the groups: csrc/desa_mma.cuh's, which the 'default' kernel
//     shares, so ball membership matches the plain version bit for bit
//   h1    = relu((f_m - f_j) Wf_i + ((x_m - x_j) / r_i) Wl_i + b1_i)
//   h2    = relu(h1 W2_i + b2_i);  out_i = max of h2 over the group
//   out   = relu([out_0 | out_1 | out_2 | f_j] Wfu + bfu)
// f_m - f_j, the coordinate term, the biases, the relus and d2 are float32
// on the CUDA cores. Every product of the MLP and of the fusion is three
// tf32 products summed into float32 (csrc/desa_mma.cuh: split_tf32,
// mma_tf32x3): at the serving shape that stays within 1e-4 of float32
// sums, where one tf32 product alone lies some 0.016 away.
//
// What bounds it on the H100: operations. A full group costs
// 2 * 2 * 128 * 128 flops per slot, 17 GFLOP per call at the serving shape
// (B=64, N=1024, J=21, S=64) against ~35 MB of inputs. The least work at
// float32 accuracy (A_m = f_m Wf_i once per point a group holds, h2 per
// slot, the fusion: ~12.3 G) takes ~0.075 ms as three tf32 products at
// 495 TFLOP/s, the bytes ~0.01 ms. The design:
//   * one block of 8 warps per (tile of kJ = 4 joints, batch element): 384
//     blocks at the serving shape, one per SM (its shared memory), about
//     three full waves over the 132 SMs; d2 of the tile's joints in one
//     pass over the support, then the 8 warps share the kJ x 3 selections;
//   * per radius, the block stages Wf_i and W2_i in float32, packed
//     [out, in] by the wrapper, once in shared memory (cp.async, 128 KB)
//     and runs all its joints against them, two groups at a time: warps
//     0-3 take one joint's group and warps 4-7 another's, 16 slot rows per
//     warp; a warp whose rows all lie beyond the group skips its products;
//   * the weights stay float32 in shared memory (split ahead into hi and
//     lo they would take 256 KB, more than a block may have): each
//     fragment is split as it is loaded (5 operations per element), and
//     f_m - f_j is taken in float32 before the split;
//   * the tensor core truncates the sums it takes, so each k-step's three
//     products go into a fresh fragment that is then added to the
//     accumulator rounded to nearest (one long chain lay 2.4e-4 from the
//     plain version on the H100, this 2.1e-5);
//   * h1 goes from the first product's accumulators to the second's A
//     fragments in registers, split there one k-step at a time: the
//     pack stores W2's input channels in the order (0, 2, 4, 6, 1, 3, 5, 7)
//     within every 8 (csrc/desa_mma.cuh);
//   * each group's rows are gathered with cp.async into its warps' buffer;
//     the next step's rows, and the next radius's Wf, are copied while the
//     second product runs;
//   * the max over the group: in the fragment, across a quad's lanes, then
//     across the warps through shared memory; rows beyond the group count
//     as 0, which is exact since every h2 is >= 0 and a group holds >= 1
//     (a zero row is not 0 after the two relus, hence the mask);
//   * the 512 -> 128 fusion of the tile's joints on the tensor cores too,
//     Wfu streamed through the weight buffers in 4 chunks.
// Shared [rows][128] float32 tiles store 16-byte chunk c of row r at chunk
// c ^ (r % 8), so the 8 rows an ldmatrix reads fall on distinct banks.
// What holds it back (H100, PERF.md): some 0.53 ms against the 0.078 ms
// bound. mma.sync with tf32 operands sustains ~323 TFLOP/s there, not
// 495, and each product carries ~6 other instructions (every warp splits
// all of Wf_i and W2_i for its 16 rows; the fresh-fragment adds); the part
// without products takes 0.09 ms. wgmma, reading B once per warpgroup
// from tiles split once per block, is the next step.

#include <cstdint>

#include <cuda_runtime.h>

#include "desa_common.cuh"
#include "desa_mma.cuh"

namespace {

using desa::kC;
using desa_mma::cp_async16;
using desa_mma::ldmatrix_x4;
using desa_mma::mma_tf32x3;
using desa_mma::split_tf32;
constexpr int kJ = 4;          // joints per block
static_assert(kJ >= 1 && kJ <= 8, "the fusion keeps the tile in rows 0-7");
constexpr int kS = 64;         // most group slots per radius: one tile
constexpr int kR = 3;          // radii
constexpr int kGroups = 2;     // groups multiplied at once, 4 warps each
constexpr int kWarps = 4 * kGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kCat = (kR + 1) * kC;
constexpr int kCatStride = kCat + 4;  // rows 16 bytes apart modulo 128
// floats of d2 that the feature buffers hold before their first use
constexpr int kD2Floats = kGroups * kS * kC;

struct Scales {
  float r[kR];
  float r_sq[kR];
  int s[kR];
};

struct Smem {
  float w[2][kC * kC];           // Wf_i^T, W2_i^T (k permuted); Wfu chunks
  float feat[kGroups][kS * kC];  // the feature rows of two groups; d2 first
  float cat[kJ][kCatStride];     // [out_0 | out_1 | out_2 | f_j]
  float xyz[kGroups][kS][3];
  alignas(16) float vec[5][kC];  // Wl_i (3 rows), b1_i, b2_i
  alignas(16) float wmax[kWarps][kC];
  int16_t sel[kJ][kR][kS];
  int nsel[kJ][kR];
};

// element offset of 16-byte chunk `ch` of row `r` in a swizzled tile
__device__ __forceinline__ int swz(int r, int ch) {
  return r * kC + ((ch ^ (r & 7)) << 2);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// a[i] without indexing the array at run time (no stack frame)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kR], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// a [128, 128] float32 matrix from global memory into a swizzled tile
__device__ __forceinline__ void stage_tile(float* dst, const float* src) {
  for (int idx = threadIdx.x; idx < kC * 32; idx += kThreads) {
    const int r = idx >> 5, ch = idx & 31;
    cp_async16(dst + swz(r, ch), src + r * kC + ch * 4);
  }
}

// the B fragments of n-tiles n0 and n0 + 8 at k-step kk from a tile that
// holds the matrix as [n][k], split into tf32 hi and lo: hi[nt] and lo[nt]
// for n-tile n0 + 8 nt
__device__ __forceinline__ void load_b(uint32_t (&hi)[2][2],
                                       uint32_t (&lo)[2][2],
                                       const float* tile, int n0, int kk,
                                       int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    split_tf32(__uint_as_float(r[q]), hi[q >> 1][q & 1],
               lo[q >> 1][q & 1]);
  }
}

// the groups of the block's joints j0 .. j0 + jn - 1 into sm.sel and
// sm.nsel: d2 of as many joints as fit in the feature buffers (not yet in
// use; all of them at the serving shape), then the warps share the
// (joint, radius) selections
__device__ __forceinline__ void select_groups(Smem& sm, const float* pxyz,
                                              const float* nxyz, int n,
                                              int m_total, int j0, int jn,
                                              const Scales& sc) {
  const int warp = threadIdx.x >> 5;
  float* s_d2 = &sm.feat[0][0];
  const int per_pass = min(jn, kD2Floats / m_total);
  for (int c0 = 0; c0 < jn; c0 += per_pass) {
    const int cn = min(per_pass, jn - c0);
    desa_mma::tile_sq_dists<kJ>(s_d2, pxyz, nxyz, n, m_total, j0 + c0, cn);
    __syncthreads();
    for (int task = warp; task < cn * kR; task += kWarps) {
      const int jj = c0 + task / kR, i = task % kR;
      desa_mma::select_group_warp(s_d2 + (task / kR) * m_total, m_total,
                                  pick(sc.r_sq, i), pick(sc.s, i),
                                  sm.sel[jj][i],
                                  &sm.nsel[jj][i]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
desa_dense_kernel(const float* __restrict__ pcl_feat,   // [B,N,C]
                  const float* __restrict__ node_feat,  // [B,J,C]
                  const float* __restrict__ pcl_xyz,    // [B,N,3]
                  const float* __restrict__ node_xyz,   // [B,J,3]
                  const float* __restrict__ wf_t,       // [R,C,C] [out, in]
                  const float* __restrict__ w2_t,       // [R,C,C] k permuted
                  const float* __restrict__ wfu_t,      // [R+1,C,C]
                  const float* __restrict__ wl,         // [R,3,C]
                  const float* __restrict__ b1,         // [R,C]
                  const float* __restrict__ b2,         // [R,C]
                  const float* __restrict__ bfu,        // [C]
                  Scales sc, float* __restrict__ out,   // [B,J,C]
                  int n, int j_num) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2;         // the warp's group of the step
  const int r0 = (warp & 3) * 16;    // the warp's first slot row
  const int j0 = blockIdx.x * kJ, b = blockIdx.y;
  const int jn = min(kJ, j_num - j0);
  const int m_total = n + j_num;
  const float* pxyz = pcl_xyz + static_cast<size_t>(b) * n * 3;
  const float* nxyz = node_xyz + static_cast<size_t>(b) * j_num * 3;
  const float* pfeat = pcl_feat + static_cast<size_t>(b) * n * kC;
  const float* nfeat = node_feat + static_cast<size_t>(b) * j_num * kC;

  auto stage_vectors = [&](int i) {
    // Wl_i (3 x 128), b1_i and b2_i: 160 16-byte chunks
    if (tid < 160) {
      const float* src = tid < 96 ? wl + i * 3 * kC + 4 * tid
                         : tid < 128 ? b1 + i * kC + 4 * (tid - 96)
                                     : b2 + i * kC + 4 * (tid - 128);
      cp_async16(&sm.vec[0][0] + 4 * tid, src);
    }
  };
  // radius 0's weights travel while the groups are selected
  stage_tile(sm.w[0], wf_t);
  stage_tile(sm.w[1], w2_t);
  stage_vectors(0);
  desa_mma::cp_async_commit();
  for (int idx = tid; idx < jn * kC; idx += kThreads) {
    const int jj = idx / kC, c = idx % kC;
    sm.cat[jj][kR * kC + c] = nfeat[(j0 + jj) * kC + c];
  }
  select_groups(sm, pxyz, nxyz, n, m_total, j0, jn, sc);

  // step s multiplies the groups of joints q kGroups + grp, q = s % sr, at
  // radius s / sr; warp group grp's rows arrive in feat[grp]
  const int sr = (jn + kGroups - 1) / kGroups;  // steps per radius
  const int steps = kR * sr;
  auto gather = [&](int s) {
    const int i = s / sr, q = s % sr;
    for (int gi = 0; gi < kGroups; ++gi) {
      const int jj = q * kGroups + gi;
      if (jj >= jn) break;
      const int nsel = sm.nsel[jj][i];
      const int rows = (nsel + 15) & ~15;  // the warps' rows in use
      const int16_t* sel = sm.sel[jj][i];
      for (int idx = tid; idx < rows * 32; idx += kThreads) {
        const int r = idx >> 5, ch = idx & 31;
        const bool in = r < nsel;
        const int m = in ? sel[r] : 0;
        const float* src = m < n ? pfeat + static_cast<size_t>(m) * kC
                                 : nfeat + static_cast<size_t>(m - n) * kC;
        cp_async16(sm.feat[gi] + swz(r, ch), src + ch * 4, in);
      }
      for (int idx = tid; idx < rows * 3; idx += kThreads) {
        const int r = idx / 3, d = idx % 3;
        const bool in = r < nsel;
        const int m = in ? sel[r] : 0;
        const float* src = m < n ? pxyz + 3 * m : nxyz + 3 * (m - n);
        desa_mma::cp_async4(&sm.xyz[gi][r][d], src + d, in);
      }
    }
  };

  gather(0);
  desa_mma::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int i = s / sr, q = s % sr;
    desa_mma::cp_async_wait<0>();  // step s's rows, radius i's weights
    __syncthreads();

    const int jj = q * kGroups + grp;
    const int nsel = jj < jn ? sm.nsel[jj][i] : 0;
    const bool busy = r0 < nsel;
    float acc[16][4];  // the first product, then h1 in place
    if (busy) {
      const float* feat = sm.feat[grp];
      const float* fj = sm.cat[jj] + kR * kC;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      }
      // (f_m - f_j) Wf_i for the warp's 16 rows, 64 outputs at a time:
      // with all 128 the B fragments in flight spill registers
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll 1
        for (int kk = 0; kk < kC / 8; ++kk) {
          uint32_t a[4], a_hi[4], a_lo[4];
          ldmatrix_x4(a, feat + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
          const float f0 = fj[8 * kk + t], f1 = fj[8 * kk + t + 4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split_tf32(__fsub_rn(__uint_as_float(a[e]), e < 2 ? f0 : f1),
                       a_hi[e], a_lo[e]);
          }
#pragma unroll
          for (int np = 4 * h; np < 4 * h + 4; ++np) {
            uint32_t b_hi[2][2], b_lo[2][2];
            load_b(b_hi, b_lo, sm.w[0], np * 16, kk, lane);
            mma_tf32x3(acc[2 * np], a_hi, a_lo, b_hi[0], b_lo[0]);
            mma_tf32x3(acc[2 * np + 1], a_hi, a_lo, b_hi[1], b_lo[1]);
          }
        }
      }
      // h1 = relu(. + ((x_m - x_j) / r_i) Wl_i + b1_i)
      const float r = pick(sc.r, i);
      const float* qx = nxyz + 3 * (j0 + jj);
      float rel[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          rel[h][d] = __fdiv_rn(
              __fsub_rn(sm.xyz[grp][r0 + g + 8 * h][d], qx[d]), r);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int c = nt * 8 + 2 * t;
        const float2 w0 = ld2(&sm.vec[0][c]), w1 = ld2(&sm.vec[1][c]);
        const float2 w2 = ld2(&sm.vec[2][c]), bc = ld2(&sm.vec[3][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e & 1;
          const float* x = rel[e >> 1];
          const float loc = fmaf(hi ? w2.y : w2.x, x[2],
                                 fmaf(hi ? w1.y : w1.x, x[1],
                                      fmaf(hi ? w0.y : w0.x, x[0],
                                           hi ? bc.y : bc.x)));
          acc[nt][e] = fmaxf(__fadd_rn(acc[nt][e], loc), 0.0f);
        }
      }
    }
    __syncthreads();  // feat, xyz and Wf_i are read for this step
    const bool next_radius = s + 1 < steps && (s + 1) % sr == 0;
    if (s + 1 < steps) gather(s + 1);
    if (next_radius) stage_tile(sm.w[0], wf_t + (i + 1) * kC * kC);
    desa_mma::cp_async_commit();

    if (busy) {
      const bool in_a = r0 + g < nsel, in_b = r0 + g + 8 < nsel;
      // h1 W2_i, 16 outputs (two n-tiles) at a time beside h1's 64
      // registers, so nothing spills; k-step kk's A fragment is n-tile
      // kk's accumulators
#pragma unroll 1
      for (int n0 = 0; n0 < kC; n0 += 16) {
        float acc2[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kC / 8; ++kk) {
          uint32_t a_hi[4], a_lo[4];
          split_tf32(acc[kk][0], a_hi[0], a_lo[0]);
          split_tf32(acc[kk][2], a_hi[1], a_lo[1]);
          split_tf32(acc[kk][1], a_hi[2], a_lo[2]);
          split_tf32(acc[kk][3], a_hi[3], a_lo[3]);
          uint32_t b_hi[2][2], b_lo[2][2];
          load_b(b_hi, b_lo, sm.w[1], n0, kk, lane);
          mma_tf32x3(acc2[0], a_hi, a_lo, b_hi[0], b_lo[0]);
          mma_tf32x3(acc2[1], a_hi, a_lo, b_hi[1], b_lo[1]);
        }
        // h2 = relu(. + b2_i); its max over the warp's rows in the group:
        // 0 stands for the rows past it and for relu's floor
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = n0 + nt * 8 + 2 * t;
          const float2 bc = ld2(&sm.vec[4][c]);
          float m0 = 0.0f, m1 = 0.0f;
          if (in_a) {
            m0 = fmaxf(m0, __fadd_rn(acc2[nt][0], bc.x));
            m1 = fmaxf(m1, __fadd_rn(acc2[nt][1], bc.y));
          }
          if (in_b) {
            m0 = fmaxf(m0, __fadd_rn(acc2[nt][2], bc.x));
            m1 = fmaxf(m1, __fadd_rn(acc2[nt][3], bc.y));
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          if (g == 0) {
            *reinterpret_cast<float2*>(&sm.wmax[warp][c]) =
                make_float2(m0, m1);
          }
        }
      }
    }
    __syncthreads();
    // the next radius's W2, Wl, b1 and b2, now that no warp reads these
    if (next_radius) {
      stage_tile(sm.w[1], w2_t + (i + 1) * kC * kC);
      stage_vectors(i + 1);
      desa_mma::cp_async_commit();
    }
    // out_i of each group: the max over the warps that held its rows
    {
      const int gi = tid >> 7, c = tid & (kC - 1);
      const int jr = q * kGroups + gi;
      if (jr < jn) {
        const int ns = sm.nsel[jr][i];
        float mx = sm.wmax[4 * gi][c];
        for (int w = 1; w < 4 && w * 16 < ns; ++w) {
          mx = fmaxf(mx, sm.wmax[4 * gi + w][c]);
        }
        sm.cat[jr][i * kC + c] = mx;
      }
    }
  }

  // the fusion: rows 0..jn-1 of cat times Wfu (k = 512 in 4 chunks of
  // 128, two staged at a time); warp w computes outputs 16w..16w+15
  float facc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    facc[nt][0] = facc[nt][1] = facc[nt][2] = facc[nt][3] = 0.0f;
  }
  const int arow = (lane & 15) < jn ? (lane & 15) : 0;  // rows >= jn unused
  for (int half = 0; half < 2; ++half) {
    stage_tile(sm.w[0], wfu_t + (2 * half) * kC * kC);
    stage_tile(sm.w[1], wfu_t + (2 * half + 1) * kC * kC);
    desa_mma::cp_async_commit();
    desa_mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll 4
      for (int kk = 0; kk < kC / 8; ++kk) {
        uint32_t a[4], a_hi[4], a_lo[4];
        ldmatrix_x4(a, &sm.cat[arow][(2 * half + q) * kC + kk * 8 +
                                     (lane >> 4) * 4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(__uint_as_float(a[e]), a_hi[e], a_lo[e]);
        }
        uint32_t b_hi[2][2], b_lo[2][2];
        load_b(b_hi, b_lo, sm.w[q], warp * 16, kk, lane);
        mma_tf32x3(facc[0], a_hi, a_lo, b_hi[0], b_lo[0]);
        mma_tf32x3(facc[1], a_hi, a_lo, b_hi[1], b_lo[1]);
      }
    }
    __syncthreads();  // before the next chunks overwrite the buffers
  }
  if (g < jn) {
    float* o = out + (static_cast<size_t>(b) * j_num + j0 + g) * kC;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = warp * 16 + nt * 8 + 2 * t;
      o[c] = fmaxf(__fadd_rn(facc[nt][0], bfu[c]), 0.0f);
      o[c + 1] = fmaxf(__fadd_rn(facc[nt][1], bfu[c + 1]), 0.0f);
    }
  }
}

int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      desa_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem))));
}

}  // namespace

extern "C" int kpf_desa_dense(const float* pcl_feat, const float* node_feat,
                              const float* pcl_xyz, const float* node_xyz,
                              const float* wf_t, const float* w2_t,
                              const float* wfu_t, const float* wl,
                              const float* b1, const float* b2,
                              const float* bfu, float r0, float r1, float r2,
                              float r_sq0, float r_sq1, float r_sq2, int s0,
                              int s1, int s2, float* out, int b, int n,
                              int j, cudaStream_t stream) {
  if (n + j > kD2Floats) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem();
  if (err != 0) return err;
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
  const dim3 grid((j + kJ - 1) / kJ, b);
  desa_dense_kernel<<<grid, kThreads, sizeof(Smem), stream>>>(
      pcl_feat, node_feat, pcl_xyz, node_xyz, wf_t, w2_t, wfu_t, wl, b1, b2,
      bfu, sc, out, n, j);
  return static_cast<int>(cudaGetLastError());
}

// the joints per block, the dynamic shared memory of a block and the
// blocks that fit on an SM
extern "C" int kpf_desa_dense_info(int* joint_tile, int* smem_bytes,
                                   int* blocks_per_sm) {
  *joint_tile = kJ;
  *smem_bytes = static_cast<int>(sizeof(Smem));
  const int err = allow_smem();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, desa_dense_kernel, kThreads, *smem_bytes));
}
