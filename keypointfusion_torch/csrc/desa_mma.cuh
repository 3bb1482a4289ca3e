// Helpers of both K1 kernels (csrc/desa_dense.cu, 'highest';
// csrc/desa_dense_serving.cu, 'default') and of K3
// (csrc/grouped_mlp_pool.cu: the TF32 split, ldmatrix and the copies):
// tensor-core products, copies, and the one copy of the ball rule, d2
// and the group selection, for a tile of joints (d2 for several joints
// per pass over the support; the selection by any warp of a block, so all
// warps select at once).
//
// mma.sync m16n8k16 with bfloat16 operands and float32 sums; fragments as
// the PTX ISA lays them out, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)
//                           a2 (g, 8+2t..)    a3 (g+8, 8+2t..)
//   B (16 x 8, k x n)       b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C/D (16 x 8, float32)   d0, d1 (g, 2t..2t+1)  d2, d3 (g+8, 2t..)
// so the accumulators of n-tiles 2k and 2k+1 are, once rounded to
// bfloat16 and packed in pairs, the A fragment of k-step k of a product
// that consumes them: a chained product never leaves registers.
//
// mma.sync m16n8k8 with tf32 operands and float32 sums:
//   A (16 x 8)   a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8)    b0 (k t, n g)  b1 (k t+4, n g)
//   C/D          as above
// ldmatrix .b16 on float32 data gives lane l the word (l / 4, l % 4) of
// each 8 x 4 float32 block: the A fragment of a [row][k] tile and the B
// fragment of a [n][k] tile, 16-byte chunks of 4 floats. A product at
// float32 accuracy takes three: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi) (x - hi is exact), both rounded to nearest, ties away
// from zero (as cvt.rna), and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b summed
// small terms first, each k-step's in a fresh float32 fragment added to
// the sum rounded to nearest; lo_a lo_b is dropped.
// The accumulators of n-tile k hold columns 2t, 2t+1, the A fragment of
// k-step k wants columns t, t+4: a consumer whose k runs over the
// producer's columns in the order (0, 2, 4, 6, 1, 3, 5, 7) within every 8
// takes them as they are, a0..a3 = d0, d2, d1, d3.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "desa_common.cuh"

namespace desa_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; with fill false the 16 bytes
// are zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zeros when fill is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 4 : 0));
}

// the copies issued so far by this thread form one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8x8 bfloat16 matrices from shared memory; lanes 8i..8i+7 give the
// row addresses of matrix i, and register i of each lane holds its
// (lane / 4, 2 (lane % 4)..+1) pair of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: one 16x8x16 product, bfloat16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bfloat16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to tf32 (to nearest, ties away from zero), as a 32-bit word:
// half a tf32 ulp added to the magnitude bits, the 13 low bits cleared.
// The same word as cvt.rna.tf32.f32 for every finite x that does not
// round past the largest float (the port's values are far below it), in
// two integer operations where the H100 runs cvt as a longer sequence
// with checks for NaN and infinity (the K1 'highest' kernel measured 10%
// faster, with the same output bits; PERF.md).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in tf32: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b: one 16x8x8 product, tf32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a b (one k-step) at float32 accuracy from split operands: lo_a
// hi_b, then hi_a lo_b, then hi_a hi_b summed in a fresh fragment, which
// is then added to acc rounded to nearest (b_hi/b_lo: {b0, b1} of the
// n-tile). The tensor core truncates each sum it takes: chained in one
// accumulator, every product would cost up to an ulp of acc, always
// towards zero (measured on the H100: 2.4e-4 at the serving shape); in a
// fresh fragment it costs an ulp of one k-step's sum.
__device__ __forceinline__ void mma_tf32x3(float (&acc)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
}

// d2 for up to kJ joints at once: s_d2[c * m_total + m] for the joints
// j0 .. j0 + cn - 1 of nxyz and every support point m (the n cloud points
// of pxyz, then the joints of nxyz), each support point read once:
//   (|q|^2 + |x_m|^2) - 2 (fma(qz, sz, fma(qy, sy, qx sx))), clamped at 0,
// every step rounded to float32 in that order, as ops/pairwise.py rounds
// it, so ball membership matches the plain versions exactly. The caller
// syncs before reading s_d2.
template <int kJ>
__device__ __forceinline__ void tile_sq_dists(float* s_d2, const float* pxyz,
                                              const float* nxyz, int n,
                                              int m_total, int j0, int cn) {
  float qx[kJ], qy[kJ], qz[kJ], q2[kJ];
#pragma unroll
  for (int c = 0; c < kJ; ++c) {
    const float* q = nxyz + 3 * (j0 + min(c, cn - 1));
    qx[c] = q[0];
    qy[c] = q[1];
    qz[c] = q[2];
    q2[c] = desa::sqnorm3(qx[c], qy[c], qz[c]);
  }
#pragma unroll 4
  for (int m = threadIdx.x; m < m_total; m += blockDim.x) {
    const float* x = m < n ? pxyz + 3 * m : nxyz + 3 * (m - n);
    const float sx = x[0], sy = x[1], sz = x[2];
    const float s2 = desa::sqnorm3(sx, sy, sz);
#pragma unroll
    for (int c = 0; c < kJ; ++c) {
      if (c < cn) {
        const float cross = __fmaf_rn(qz[c], sz,
                                      __fmaf_rn(qy[c], sy,
                                                __fmul_rn(qx[c], sx)));
        const float d = __fsub_rn(__fadd_rn(q2[c], s2),
                                  __fmul_rn(2.0f, cross));
        s_d2[c * m_total + m] = fmaxf(d, 0.0f);
      }
    }
  }
}

// The group of one radius, selected by the calling warp, whichever it is:
// the first s_max support points with d2 < r_sq in storage order,
// or the closest point, lowest index among equals, when the ball is empty.
// Four 32-wide ballots per step, so the loads and ballots of a step do not
// wait on each other's counts. s_sel[0, *s_nsel) gets the indices. The
// caller syncs after.
__device__ __forceinline__ void select_group_warp(const float* s_d2,
                                                  int m_total, float r_sq,
                                                  int s_max, int16_t* s_sel,
                                                  int* s_nsel) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int base = 0; base < m_total && cnt < s_max; base += 128) {
    bool in[4];
    unsigned ball[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = base + 32 * q + lane;
      in[q] = m < m_total && s_d2[m] < r_sq;
      ball[q] = __ballot_sync(0xffffffffu, in[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rank = cnt + __popc(ball[q] & below);
      if (in[q] && rank < s_max) {
        s_sel[rank] = static_cast<int16_t>(base + 32 * q + lane);
      }
      cnt += __popc(ball[q]);
    }
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
    if (lane == 0) s_sel[0] = static_cast<int16_t>(bi);
    cnt = 1;
  }
  if (lane == 0) *s_nsel = min(cnt, s_max);
}

}  // namespace desa_mma
