// K1 serving mode: whole-DESA eval pass, bfloat16 operands, float32 sums,
// gather form, on the tensor cores, for sm_90a.
//
// Replaces keypointfusion_tpu/kernels/desa_dense_pallas.py:desa_dense_fused
// in its 'default' mode (the pl.pallas_call at line 257 with bfloat16
// MLP operands). Support = the N cloud points followed by the J joints;
// features arrive in bfloat16, coordinates in float32; bf() rounds a
// float32 to bfloat16. Per radius r_i, with inv_r = float32(1/r_i):
//   d2 and the groups: csrc/desa_mma.cuh's, which the 'highest' kernel
//     shares, so ball membership matches the plain version and the
//     'highest' kernel bit for bit
//   A_m[c] = (f_m bf(Wf_i))[c] + (x_m Wl_i)[c] * inv_r      float32 sums
//   h1     = relu(A_m - b_j),  h2 = relu(bf(h1) bf(W2_i) + b2_i)
//   out_i  = max of h2 over the group
//   out    = relu(bf([out_0 | out_1 | out_2 | f_j]) bf(Wfu) + bfu)
// The joint term b_j = f_j Wf_i + (x_j Wl_i) inv_r - b1_i comes in from
// the wrapper (kernels/desa_dense.py:serving_joint_term), as the JAX
// package computes it outside its Pallas kernel too.
//
// What bounds it on the H100: operations. A full group costs
// 2 * 2 * 128 * 128 bfloat16 flops per slot, some 17 GFLOP per call at
// the serving shape against ~20 MB of inputs; the least work (A_m once per
// point a group holds) takes some 15 microseconds at the card's bfloat16
// tensor-core rate, the bytes 6. The design:
//   * one block of 4 warps per (tile of kJ = 3 joints, batch element: 448
//     blocks at the serving shape, faster on the H100 than kJ = 7, whose
//     192 blocks leave SMs idle; PERF.md); d2 of
//     the tile's joints in one pass over the support, then the 4 warps
//     share the kJ x 3 (joint, radius) selections;
//   * per radius, the block stages bf(Wf_i) and bf(W2_i), packed [out, in]
//     by the wrapper, once in shared memory (cp.async) and runs all its
//     joints against them: each weight is read from L2 once per block and
//     radius, not once per joint;
//   * a group is one tile of 64 slot rows gathered with cp.async, in two
//     buffers: the next (joint, radius)'s rows are on their way while the
//     current ones are multiplied; each warp owns 16 rows, and a warp
//     whose rows all lie beyond the group skips its products;
//   * both 128x128 products run as mma.sync m16n8k16 (bfloat16 in, float32
//     sums, exact products); h1 goes from the first product's accumulators
//     to the second's A operand in registers (csrc/desa_mma.cuh);
//   * the max over the group: in the fragment, across a quad's lanes, then
//     across the warps through shared memory; rows beyond the group count
//     as 0, which is exact since every h2 is >= 0 and a group holds >= 1;
//   * the 512 -> 128 fusion of the tile's joints on the tensor cores too,
//     with bf(Wfu) streamed through the weight buffers in 4 chunks.
// Shared [rows][128] bfloat16 tiles store 16-byte chunk c of row r at chunk
// c ^ (r % 8), so the 8 rows an ldmatrix reads fall on distinct banks
// without padding; that keeps two blocks on an SM.
// What holds it back (H100, PERF.md): the products. Each warp loads all of
// B from shared memory for its 16 rows, so tensor pipe, issue slots and
// shared-memory bandwidth each run about half used with two warps per
// scheduler; wgmma, which reads B once per warpgroup, is the next step.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "desa_common.cuh"
#include "desa_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using desa::kC;
using desa_mma::cp_async16;
using desa_mma::ldmatrix_x4;
using desa_mma::mma_bf16;
constexpr int kJ = 3;          // joints per block
static_assert(kJ >= 1 && kJ <= 8, "the fusion keeps the tile in rows 0-7");
constexpr int kS = 64;         // most group slots per radius: one tile
constexpr int kR = 3;          // radii
constexpr int kWarps = 4;      // each owns 16 slot rows
constexpr int kThreads = 32 * kWarps;
constexpr int kCat = (kR + 1) * kC;
// floats of d2 that the weight and feature buffers hold before use
constexpr int kD2Floats = (2 * kC * kC + 2 * kS * kC) * 2 / 4;

struct Scales {
  float inv_r[kR];
  float r_sq[kR];
  int s[kR];
};

struct Smem {
  bf16 w[2][kC * kC];      // bf(Wf_i)^T, bf(W2_i)^T; Wfu chunks
  bf16 feat[2][kS * kC];   // the feature rows of two groups; w and feat
                           // hold d2 (kD2Floats) before either is used
  bf16 cat[kJ][kCat + 8];  // bf([out_0 | out_1 | out_2 | f_j])
  alignas(16) float xyz[2][kS][3];
  alignas(16) float wl[3][kC];
  alignas(16) float b2[kC];
  alignas(16) float wmax[kWarps][kC];
  int16_t sel[kJ][kR][kS];
  int nsel[kJ][kR];
};

// element offset of 16-byte chunk `ch` of row `r` in a swizzled tile
__device__ __forceinline__ int swz(int r, int ch) {
  return r * kC + ((ch ^ (r & 7)) << 3);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// a [128, 128] bfloat16 matrix from global memory into a swizzled tile
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src) {
  for (int idx = threadIdx.x; idx < kC * 16; idx += kThreads) {
    const int r = idx >> 4, ch = idx & 15;
    cp_async16(dst + swz(r, ch), src + r * kC + ch * 8);
  }
}

// B fragments of n-tiles n0 and n0 + 8 at k-step kk from a tile that
// holds the matrix as [n][k]: {b0, b1} of n0, then {b0, b1} of n0 + 8
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile,
                                       int n0, int kk, int lane) {
  ldmatrix_x4(r, tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
}

// acc[nt] += A (16 rows x 128) times output channels n0..n0+63 of the
// tile's matrix (128 x 128, [n][k]); `a_frag(kk, a)` gives the A fragment
// of k-step kk. Half the outputs at a time keep 32 accumulators live, not
// 64 (fewer registers; the same time on the H100 as the whole width).
template <typename AFrag>
__device__ __forceinline__ void product_half(float (&acc)[8][4],
                                             const bf16* tile, int n0,
                                             int lane, AFrag a_frag) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    uint32_t a[4];
    a_frag(kk, a);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b(b, tile, n0 + np * 16, kk, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// the groups of the block's joints j0 .. j0 + jn - 1 into sm.sel and
// sm.nsel: d2 of as many joints as fit in the weight and feature buffers
// (not yet in use; all of them at the serving shape), then the warps
// share the (joint, radius) selections
__device__ __forceinline__ void select_groups(Smem& sm, const float* pxyz,
                                              const float* nxyz, int n,
                                              int m_total, int j0, int jn,
                                              const Scales& sc) {
  const int warp = threadIdx.x >> 5;
  float* s_d2 = reinterpret_cast<float*>(sm.w);
  const int per_pass = min(jn, kD2Floats / m_total);
  for (int c0 = 0; c0 < jn; c0 += per_pass) {
    const int cn = min(per_pass, jn - c0);
    desa_mma::tile_sq_dists<kJ>(s_d2, pxyz, nxyz, n, m_total, j0 + c0, cn);
    __syncthreads();
    for (int task = warp; task < cn * kR; task += kWarps) {
      const int jj = c0 + task / kR, i = task % kR;
      desa_mma::select_group_warp(s_d2 + (task / kR) * m_total, m_total,
                                  sc.r_sq[i], sc.s[i], sm.sel[jj][i],
                                  &sm.nsel[jj][i]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
desa_dense_serving_kernel(const bf16* __restrict__ pcl_feat,   // [B,N,C]
                          const bf16* __restrict__ node_feat,  // [B,J,C]
                          const float* __restrict__ pcl_xyz,   // [B,N,3]
                          const float* __restrict__ node_xyz,  // [B,J,3]
                          const float* __restrict__ bj,        // [B,J,R,C]
                          const bf16* __restrict__ wf_t,       // [R,C,C]
                          const float* __restrict__ wl,        // [R,3,C]
                          const bf16* __restrict__ w2_t,       // [R,C,C]
                          const float* __restrict__ b2,        // [R,C]
                          const bf16* __restrict__ wfu_t,      // [R+1,C,C]
                          const float* __restrict__ bfu,       // [C]
                          Scales sc, float* __restrict__ out,  // [B,J,C]
                          int n, int j_num) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kJ, b = blockIdx.y;
  const int jn = min(kJ, j_num - j0);
  const int m_total = n + j_num;
  const float* pxyz = pcl_xyz + static_cast<size_t>(b) * n * 3;
  const float* nxyz = node_xyz + static_cast<size_t>(b) * j_num * 3;
  const bf16* pfeat = pcl_feat + static_cast<size_t>(b) * n * kC;
  const bf16* nfeat = node_feat + static_cast<size_t>(b) * j_num * kC;

  select_groups(sm, pxyz, nxyz, n, m_total, j0, jn, sc);
  for (int idx = tid; idx < jn * kC; idx += kThreads) {
    const int jj = idx / kC, c = idx % kC;
    sm.cat[jj][kR * kC + c] = nfeat[(j0 + jj) * kC + c];
  }

  // the (joint, radius) pairs p = i * jn + jj, radius by radius; pair p
  // computes on feat[p % 2] while the rows of pair p + 1 arrive in the
  // other buffer. Every thread commits one cp.async group per pair (the
  // next pair's rows) and one per radius (its weights) in the order it
  // needs them, so waiting for all but the newest group is enough.
  const int pairs = kR * jn;
  auto gather = [&](int p) {
    const int i = p / jn, jj = p % jn, buf = p & 1;
    const int nsel = sm.nsel[jj][i];
    const int rows = (nsel + 15) & ~15;    // the warps' rows in use
    const int16_t* sel = sm.sel[jj][i];
    for (int idx = tid; idx < rows * 16; idx += kThreads) {
      const int r = idx >> 4, ch = idx & 15;
      const bool in = r < nsel;
      const int m = in ? sel[r] : 0;
      const bf16* src = m < n ? pfeat + static_cast<size_t>(m) * kC
                              : nfeat + static_cast<size_t>(m - n) * kC;
      cp_async16(sm.feat[buf] + swz(r, ch), src + ch * 8, in);
    }
    for (int idx = tid; idx < rows * 3; idx += kThreads) {
      const int r = idx / 3, d = idx % 3;
      const bool in = r < nsel;
      const int m = in ? sel[r] : 0;
      const float* src = m < n ? pxyz + 3 * m : nxyz + 3 * (m - n);
      desa_mma::cp_async4(&sm.xyz[buf][r][d], src + d, in);
    }
  };
  auto stage_radius = [&](int i) {
    stage_tile(sm.w[0], wf_t + static_cast<size_t>(i) * kC * kC);
    stage_tile(sm.w[1], w2_t + static_cast<size_t>(i) * kC * kC);
    // wl_i (3 x 128) and b2_i (128): one 16-byte chunk per thread
    static_assert(3 * kC / 4 + kC / 4 == kThreads, "one chunk per thread");
    if (tid < 3 * kC / 4) {
      cp_async16(&sm.wl[0][0] + 4 * tid, wl + i * 3 * kC + 4 * tid);
    } else {
      cp_async16(&sm.b2[0] + 4 * (tid - 3 * kC / 4),
                 b2 + i * kC + 4 * (tid - 3 * kC / 4));
    }
  };

  stage_radius(0);
  gather(0);
  desa_mma::cp_async_commit();
  const int r0 = warp * 16;  // the warp's first slot row
  for (int p = 0; p < pairs; ++p) {
    const int i = p / jn, jj = p % jn, buf = p & 1;
    // the other buffer's last reader passed the previous pair's barrier
    if (p + 1 < pairs) gather(p + 1);
    desa_mma::cp_async_commit();
    desa_mma::cp_async_wait<1>();  // pair p's rows, radius i's weights
    __syncthreads();

    const int nsel = sm.nsel[jj][i];
    if (r0 < nsel) {
      const float inv_r = sc.inv_r[i];
      const float* bjj =
          bj + ((static_cast<size_t>(b) * j_num + j0 + jj) * kR + i) * kC;
      const bf16* feat = sm.feat[buf];
      const float* xa = sm.xyz[buf][r0 + g];
      const float* xb = sm.xyz[buf][r0 + g + 8];
      uint32_t h[8][4];  // bf(h1): the A fragments of the second product
      float acc[8][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // A_m's feature term: the warp's 16 rows times bf(Wf_i)
        product_half(acc, sm.w[0], half * 64, lane,
                     [&](int kk, uint32_t(&a)[4]) {
                       ldmatrix_x4(a, feat + swz(r0 + (lane & 15),
                                                 2 * kk + (lane >> 4)));
                     });
        // h1 = relu(A_m - b_j), rounded to bfloat16
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = half * 64 + nt * 8 + 2 * t;
          const float2 w0 = ld2(&sm.wl[0][c]), w1 = ld2(&sm.wl[1][c]);
          const float2 w2 = ld2(&sm.wl[2][c]);
          const float2 bjc = __ldg(reinterpret_cast<const float2*>(bjj + c));
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 1;
            const float* x = e < 2 ? xa : xb;
            const float loc = fmaf(hi ? w2.y : w2.x, x[2],
                                   fmaf(hi ? w1.y : w1.x, x[1],
                                        __fmul_rn(hi ? w0.y : w0.x, x[0])));
            const float a = __fadd_rn(acc[nt][e], __fmul_rn(loc, inv_r));
            v[e] = fmaxf(__fsub_rn(a, hi ? bjc.y : bjc.x), 0.0f);
          }
          const int kk = half * 4 + (nt >> 1);
          h[kk][(nt & 1) * 2] = desa_mma::pack_bf16(v[0], v[1]);
          h[kk][(nt & 1) * 2 + 1] = desa_mma::pack_bf16(v[2], v[3]);
        }
      }
      const bool in_a = r0 + g < nsel, in_b = r0 + g + 8 < nsel;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        product_half(acc, sm.w[1], half * 64, lane,
                     [&](int kk, uint32_t(&a)[4]) {
#pragma unroll
                       for (int e = 0; e < 4; ++e) a[e] = h[kk][e];
                     });
        // h2 = relu(. + b2_i); its max over the warp's rows in the group:
        // 0 stands for the rows past it and for relu's floor
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = half * 64 + nt * 8 + 2 * t;
          const float2 bc = ld2(&sm.b2[c]);
          float m0 = 0.0f, m1 = 0.0f;
          if (in_a) {
            m0 = fmaxf(m0, __fadd_rn(acc[nt][0], bc.x));
            m1 = fmaxf(m1, __fadd_rn(acc[nt][1], bc.y));
          }
          if (in_b) {
            m0 = fmaxf(m0, __fadd_rn(acc[nt][2], bc.x));
            m1 = fmaxf(m1, __fadd_rn(acc[nt][3], bc.y));
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
    // out_i: the max over the warps that held rows of the group
    float mx = sm.wmax[0][tid];
    for (int w = 1; w * 16 < nsel; ++w) mx = fmaxf(mx, sm.wmax[w][tid]);
    sm.cat[jj][i * kC + tid] = __float2bfloat16_rn(mx);
    // the next radius's weights, now that no warp reads this one's
    if (p + 1 < pairs && (p + 1) % jn == 0) {
      stage_radius(i + 1);
      desa_mma::cp_async_commit();
    }
  }

  // the fusion: rows 0..jn-1 of bf(cat) times bf(Wfu) (k = 512 in 4 chunks
  // of 128, two staged at a time); warp w computes outputs 32w..32w+31
  float facc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    facc[nt][0] = facc[nt][1] = facc[nt][2] = facc[nt][3] = 0.0f;
  }
  const int arow = (lane & 15) < jn ? (lane & 15) : 0;  // rows >= jn unused
  for (int half = 0; half < 2; ++half) {
    stage_tile(sm.w[0], wfu_t + static_cast<size_t>(2 * half) * kC * kC);
    stage_tile(sm.w[1], wfu_t + static_cast<size_t>(2 * half + 1) * kC * kC);
    desa_mma::cp_async_commit();
    desa_mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, &sm.cat[arow][(2 * half + q) * kC + kk * 16 +
                                     (lane >> 4) * 8]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          load_b(bb, sm.w[q], warp * 32 + np * 16, kk, lane);
          mma_bf16(facc[2 * np], a, bb[0], bb[1]);
          mma_bf16(facc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // before the next chunks overwrite the buffers
  }
  if (g < jn) {
    float* o = out + (static_cast<size_t>(b) * j_num + j0 + g) * kC;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = warp * 32 + nt * 8 + 2 * t;
      o[c] = fmaxf(__fadd_rn(facc[nt][0], bfu[c]), 0.0f);
      o[c + 1] = fmaxf(__fadd_rn(facc[nt][1], bfu[c + 1]), 0.0f);
    }
  }
}

// the serving kernel's groups alone (select_groups), so a test can hold
// them against the plain ball query: sel [B,J,R,kS] in slot order, -1 past
// the group; nsel [B,J,R]
__global__ void __launch_bounds__(kThreads)
desa_serving_groups_kernel(const float* __restrict__ pcl_xyz,
                           const float* __restrict__ node_xyz, Scales sc,
                           int16_t* __restrict__ sel,
                           int* __restrict__ nsel, int n, int j_num) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int j0 = blockIdx.x * kJ, b = blockIdx.y;
  const int jn = min(kJ, j_num - j0);
  select_groups(sm, pcl_xyz + static_cast<size_t>(b) * n * 3,
                node_xyz + static_cast<size_t>(b) * j_num * 3, n, n + j_num,
                j0, jn, sc);
  const size_t first = (static_cast<size_t>(b) * j_num + j0) * kR;
  for (int idx = threadIdx.x; idx < jn * kR * kS; idx += kThreads) {
    const int jj = idx / (kR * kS), i = idx / kS % kR, s = idx % kS;
    sel[(first + jj * kR + i) * kS + s] =
        s < sm.nsel[jj][i] ? sm.sel[jj][i][s] : static_cast<int16_t>(-1);
  }
  if (threadIdx.x < jn * kR) {
    nsel[first + threadIdx.x] = sm.nsel[threadIdx.x / kR][threadIdx.x % kR];
  }
}

template <typename Kernel>
int allow_smem(Kernel* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem))));
}

Scales make_scales(float inv_r0, float inv_r1, float inv_r2, float r_sq0,
                   float r_sq1, float r_sq2, int s0, int s1, int s2) {
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
  return sc;
}

}  // namespace

extern "C" int kpf_desa_dense_serving(
    const bf16* pcl_feat, const bf16* node_feat, const float* pcl_xyz,
    const float* node_xyz, const float* bj, const bf16* wf_t,
    const float* wl, const bf16* w2_t, const float* b2, const bf16* wfu_t,
    const float* bfu, float inv_r0, float inv_r1, float inv_r2, float r_sq0,
    float r_sq1, float r_sq2, int s0, int s1, int s2, float* out, int b,
    int n, int j, cudaStream_t stream) {
  // d2 of one joint at least fits in the weight and feature buffers
  static_assert(sizeof(Smem::w) + sizeof(Smem::feat) ==
                    kD2Floats * sizeof(float),
                "d2 spans the weight and feature buffers");
  if (n + j > kD2Floats) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(desa_dense_serving_kernel);
  if (err != 0) return err;
  const Scales sc = make_scales(inv_r0, inv_r1, inv_r2, r_sq0, r_sq1, r_sq2,
                                s0, s1, s2);
  const dim3 grid((j + kJ - 1) / kJ, b);
  desa_dense_serving_kernel<<<grid, kThreads, sizeof(Smem), stream>>>(
      pcl_feat, node_feat, pcl_xyz, node_xyz, bj, wf_t, wl, w2_t, b2, wfu_t,
      bfu, sc, out, n, j);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kpf_desa_dense_serving_groups(
    const float* pcl_xyz, const float* node_xyz, float r_sq0, float r_sq1,
    float r_sq2, int s0, int s1, int s2, int16_t* sel, int* nsel, int b,
    int n, int j, cudaStream_t stream) {
  if (n + j > kD2Floats) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(desa_serving_groups_kernel);
  if (err != 0) return err;
  const Scales sc = make_scales(0.0f, 0.0f, 0.0f, r_sq0, r_sq1, r_sq2, s0,
                                s1, s2);
  const dim3 grid((j + kJ - 1) / kJ, b);
  desa_serving_groups_kernel<<<grid, kThreads, sizeof(Smem), stream>>>(
      pcl_xyz, node_xyz, sc, sel, nsel, n, j);
  return static_cast<int>(cudaGetLastError());
}

// the joints per block, the dynamic shared memory of a block and the
// blocks that fit on an SM
extern "C" int kpf_desa_dense_serving_info(int* joint_tile, int* smem_bytes,
                                           int* blocks_per_sm) {
  *joint_tile = kJ;
  *smem_bytes = static_cast<int>(sizeof(Smem));
  const int err = allow_smem(desa_dense_serving_kernel);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, desa_dense_serving_kernel, kThreads, *smem_bytes));
}
