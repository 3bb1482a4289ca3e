// K2 'highest': point -> pixel feature sampler, float32, for sm_90a.
//
// Replaces keypointfusion_tpu/kernels/pixel_sampler_pallas.py:
// sample_pixel_features_fused in its 'highest' mode (the pl.pallas_call at
// line 212; its exact top-4 sweeps at lines 100-113). For every cloud
// point n of batch element b, over the HW back-projected pixel centres x_m:
//   d2[m]  = max((|p|^2 + |x_m|^2) - 2 p.x_m, 0), p.x_m =
//            fma(pz, xz, fma(py, xy, px*xx))  (ops/pairwise.py's rounding)
//   the 4 smallest d2 under the order (d2, m): among equal values the
//            lower index first, as lax.top_k
//   w_i    = 1/(d2_i + 1e-8), divided by (((w_0 + w_1) + w_2) + w_3) + 1e-8
//   out[n] = ((w_0 f[i_0] + w_1 f[i_1]) + w_2 f[i_2]) + w_3 f[i_3]
//
// What bounds it on the H100: bytes. At the serving shape (B=64,
// N=HW=1024, C=277) it reads the 73 MB feature map and writes the 73 MB
// output; one distance pass is about 0.6 G float operations, a few
// microseconds at the card's float32 rate. The JAX kernel builds a dense
// [N,HW] weight matrix for the MXU; here nothing of that size exists. The
// design:
//   * a block serves kPointsPerBlock points of one batch element, one warp
//     per point: its warps work on kWarps points side by side, each warp
//     on K2_POINTS_PER_WARP points in turn. The element's pixel centres are
//     staged once per block in shared memory as float4 (x, y, z, |x|^2),
//     padded to whole groups of chunks with the origin at |x|^2 = +inf: its
//     cross term is 0, so its d2 is +inf for every finite point (a centre
//     at +inf would give 0 * inf = NaN, and a NaN clamped by fmaxf is 0);
//   * one distance pass: lane l computes d2 of its pixels m = l + 32 i once,
//     kGroup chunks' loads at a time, and keeps their bits in registers
//     (kChunks per lane: 32 for HW <= 1024, 64 up to 2048). The clamp at 0
//     is a signed max on the bits: every negative value, -0 included,
//     becomes +0, so the bits order as the values;
//   * t0 < t1 < t2 < t3, the 4 smallest distinct values, by warp
//     reductions on the bits: t0 = the warp's min, then three times the
//     least value above t (each lane's unsigned min of bits - t - 1, where
//     the values at or below t wrap past 2^31; one __reduce_min_sync). The
//     4 nearest all have d2 <= t3;
//   * the candidates (d2 <= t3) as per-lane bit masks; the chunks holding
//     one (an OR over the warp) are visited in order, and __ballot_sync of
//     a chunk's bits gives its candidates lowest lane first: index order.
//     With distinct values there are 4 candidates, a flat background's
//     rings of ties add a few, and when fewer than 4 distinct values exist
//     every pixel is one;
//   * up to 32 candidates: candidate r goes to lane r (through a row of
//     shared memory), which computes its d2 again (the same bits) and its
//     class k, d2 == t_k. Its slot is the number of candidates in lower
//     classes plus those of its class at lower indices: one ballot per
//     class, no serial walk. More candidates (whole tied sets) are walked
//     in index order into a 4-slot list that every lane holds alike, on a
//     strictly smaller d2, so an equal value never passes a lower index;
//     the walk stops once the 4th slot holds t0;
//   * the weights: lane l takes slot l mod 4's 1/(d2 + 1e-8), every lane
//     sums the 4 slot 0 first, lane l divides its slot's by the
//     normalizer: 2 IEEE divisions a lane, not 8;
//   * the rows: lanes across the channels (coalesced 4-byte loads: rows are
//     4 C bytes apart), kRows rows' loads (kPer a lane) issued before the
//     first product, added in slot order. A point costs 4 / kRows round
//     trips to L2, not one per channel step.
// Registers set the occupancy: d2 lives in registers until the slots are
// found, the rows only after that (72 registers, 7 blocks of 4 warps per
// SM at HW <= 1024 on the H100). What holds it back there: issue and
// latency in the distance pass (32 LDS.128 of 4 wavefronts each per point)
// and the scans, not the rows (PERF.md; scripts/torch_k2_variants.py).
// Every rounding is an explicit intrinsic (__fmul_rn, __fmaf_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn), in the plain version's order, so the two agree
// bit for bit. kernels/pixel_sampler.py:_highest_plain_lanes runs the same
// steps on the CPU.

#include <cuda_runtime.h>

// block shape and rows in flight; a -D on the nvcc line overrides them
// (scripts/torch_k2_variants.py --mode highest times such builds side by
// side; -DK2_NO_ROWS there takes the row loads out)
#ifndef K2_WARPS
#define K2_WARPS 4
#endif
#ifndef K2_POINTS_PER_WARP
#define K2_POINTS_PER_WARP 4
#endif
#ifndef K2_ROWS
#define K2_ROWS 4
#endif

namespace {

constexpr int kK = 4;
constexpr int kWarps = K2_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kPointsPerBlock = kWarps * K2_POINTS_PER_WARP;
constexpr int kRows = K2_ROWS;
constexpr int kMaxHW = 2048;
constexpr int kGroup = 8;        // chunks of 32 pixels loaded together
constexpr int kPer = 9;          // channels a lane holds: C = 277 in a pass
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kAll = 0xffffffffu;   // above every value's bits
constexpr unsigned kTop = 0x7fffffffu;   // the largest a value's bits can be
static_assert(kK % kRows == 0, "K2_ROWS must divide 4");

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// The bits of d2 from the point (px, py, pz), p2 = |p|^2, to the staged
// centre q = (x, y, z, |x|^2), clamped at +0.
__device__ __forceinline__ unsigned d2_bits(float px, float py, float pz,
                                            float p2, float4 q) {
  const float cross =
      __fmaf_rn(pz, q.z, __fmaf_rn(py, q.y, __fmul_rn(px, q.x)));
  const float d = __fsub_rn(__fadd_rn(p2, q.w), __fmul_rn(2.0f, cross));
  return static_cast<unsigned>(max(__float_as_int(d), 0));
}

// The pixels padded to whole groups of chunks.
__host__ __device__ __forceinline__ int padded_hw(int hw) {
  return (hw + 32 * kGroup - 1) / (32 * kGroup) * (32 * kGroup);
}

// The least value above t among every lane's d2 (kTop when none): each
// lane's unsigned min of bits - t - 1, where the values at or below t wrap
// past 2^31, then the warp's min.
template <int kChunks>
__device__ __forceinline__ unsigned least_above(const unsigned (&d2)[kChunks],
                                                int chunks, unsigned t) {
  const unsigned above = t + 1u;
  unsigned u = kAll;
#pragma unroll
  for (int g = 0; g < kChunks; g += kGroup) {
    if (g < chunks) {                                 // warp-uniform
#pragma unroll
      for (int i = g; i < g + kGroup; ++i) u = min(u, d2[i] - above);
    }
  }
  u = __reduce_min_sync(kFull, u);
  return u < 0x80000000u ? u + above : kTop;
}

// The 4 slots from at most 32 candidates (their bits in sel_lo, sel_hi):
// candidate r in index order goes to lane r through the warp's row s_cand
// (chunk by chunk, one ballot each, lowest lane first), which computes its
// d2 again (the same bits) and its class k, d2 == t_k (every candidate's d2
// is one of t0..t3). Its slot: the candidates of the lower classes, then
// those of its own class at lower indices, by one ballot per class.
template <int kChunks>
__device__ __forceinline__ void rank_candidates(
    unsigned sel_lo, unsigned sel_hi, unsigned count, unsigned t0,
    unsigned t1, unsigned t2, float px, float py, float pz, float p2,
    const float4* s_pix, int* s_cand, int lane, unsigned (&lv)[kK],
    int (&li)[kK]) {
  const unsigned lanemask_lt = (1u << lane) - 1u;
  __syncwarp();                        // the last point's row is read
  unsigned base = 0;
#pragma unroll
  for (int half = 0; half < kChunks / 32; ++half) {
    const unsigned mine = half == 0 ? sel_lo : sel_hi;
    unsigned todo = __reduce_or_sync(kFull, mine);     // chunks to visit
    while (todo) {                                     // warp-uniform
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned ball = __ballot_sync(kFull, (mine >> j) & 1u);
      if ((mine >> j) & 1u) {
        s_cand[base + __popc(ball & lanemask_lt)] =
            32 * (32 * half + j) + lane;
      }
      base += __popc(ball);
    }
  }
  __syncwarp();
  const bool has = lane < count;
  const int m = has ? s_cand[lane] : 0;
  const unsigned v = has ? d2_bits(px, py, pz, p2, s_pix[m]) : kAll;
  const int cls = (v > t0) + (v > t1) + (v > t2);
  int rank = 0;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const unsigned in_k = __ballot_sync(kFull, has && cls == k);
    if (k < cls) rank += __popc(in_k);
    if (k == cls) rank += __popc(in_k & lanemask_lt);
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int src = __ffs(__ballot_sync(kFull, has && rank == k)) - 1;
    lv[k] = __shfl_sync(kFull, v, src);
    li[k] = __shfl_sync(kFull, m, src);
  }
}

// The 4 slots from any number of candidates (whole tied sets): visited in
// index order, each computes its d2 again and enters the 4-slot list on a
// strictly smaller d2, so an equal value never passes a lower index. The
// walk stops at the first chunk it reaches once the 4th slot holds t0.
template <int kChunks>
__device__ __forceinline__ void walk_candidates(
    unsigned sel_lo, unsigned sel_hi, unsigned t0, float px, float py,
    float pz, float p2, const float4* s_pix, unsigned (&lv)[kK],
    int (&li)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    lv[k] = kAll;
    li[k] = 0;
  }
#pragma unroll
  for (int half = 0; half < kChunks / 32; ++half) {
    const unsigned mine = half == 0 ? sel_lo : sel_hi;
    unsigned todo = __reduce_or_sync(kFull, mine);     // chunks to visit
    while (todo != 0 && lv[kK - 1] != t0) {            // warp-uniform
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      unsigned ball = __ballot_sync(kFull, (mine >> j) & 1u);
      while (ball) {
        const int m = 32 * (32 * half + j) + __ffs(ball) - 1;
        ball &= ball - 1;
        const unsigned v = d2_bits(px, py, pz, p2, s_pix[m]);
        if (v < lv[kK - 1]) {
          lv[kK - 1] = v;
          li[kK - 1] = m;
#pragma unroll
          for (int k = kK - 1; k > 0; --k) {
            if (lv[k] < lv[k - 1]) {
              const unsigned tv = lv[k];
              lv[k] = lv[k - 1];
              lv[k - 1] = tv;
              const int ti = li[k];
              li[k] = li[k - 1];
              li[k - 1] = ti;
            }
          }
        }
      }
    }
  }
}

// Channel ch of the feature row `row` at f.
__device__ __forceinline__ float row_value(const float* __restrict__ f,
                                           int row, int ch) {
#ifdef K2_NO_ROWS
  return static_cast<float>(row + ch);   // the index stands in: no load
#else
  return __ldg(f + ch);
#endif
}

// kChunks: pixel chunks a lane holds (HW <= 32 kChunks)
template <int kChunks>
__global__ void __launch_bounds__(kThreads)
pixel_sampler_kernel(const float* __restrict__ pcl,   // [B,N,3]
                     const float* __restrict__ img,   // [B,HW,3]
                     const float* __restrict__ feat,  // [B,HW,C]
                     float* __restrict__ out,         // [B,N,C]
                     int n, int hw, int c) {
  extern __shared__ float4 s_pix[];                   // [padded_hw(hw)]
  const int span = padded_hw(hw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPointsPerBlock;
  // one row of candidate indices per warp, after the pixel centres
  int* s_cand = reinterpret_cast<int*>(s_pix + span) + 32 * warp;
  const float* img_b = img + static_cast<size_t>(b) * hw * 3;
  for (int m = threadIdx.x; m < span; m += kThreads) {
    if (m < hw) {
      const float x = img_b[3 * m], y = img_b[3 * m + 1],
                  z = img_b[3 * m + 2];
      s_pix[m] = make_float4(x, y, z, sqnorm3(x, y, z));
    } else {
      s_pix[m] = make_float4(0.0f, 0.0f, 0.0f, __uint_as_float(kInfBits));
    }
  }
  __syncthreads();

  const float* feat_b = feat + static_cast<size_t>(b) * hw * c;
  const int chunks = (hw + 31) / 32;
  const int p_end = min(p0 + kPointsPerBlock, n);

  for (int pt = p0 + warp; pt < p_end; pt += kWarps) {
    const float* pp = pcl + (static_cast<size_t>(b) * n + pt) * 3;
    const float px = pp[0], py = pp[1], pz = pp[2];
    const float p2 = sqnorm3(px, py, pz);

    // the one distance pass, with the lane's min
    unsigned d2[kChunks];
    unsigned lo = kAll;
#pragma unroll
    for (int g = 0; g < kChunks; g += kGroup) {
      if (g < chunks) {                               // warp-uniform
#pragma unroll
        for (int i = g; i < g + kGroup; ++i) {
          d2[i] = d2_bits(px, py, pz, p2, s_pix[32 * i + lane]);
          lo = min(lo, d2[i]);
        }
      }
    }
    // t0 < t1 < t2 < t3, the 4 smallest distinct values; kTop past the
    // last when there are fewer (then every pixel is a candidate)
    const unsigned t0 = __reduce_min_sync(kFull, lo);
    const unsigned t1 = least_above(d2, chunks, t0);
    const unsigned t2 = t1 == kTop ? kTop : least_above(d2, chunks, t1);
    const unsigned t = t2 == kTop ? kTop : least_above(d2, chunks, t2);

    // the candidates: bit i of the lane's mask for pixel 32 i + lane
    unsigned sel_lo = 0, sel_hi = 0;   // chunks 0-31, 32-63
#pragma unroll
    for (int g = 0; g < kChunks; g += kGroup) {
      if (g < chunks) {
#pragma unroll
        for (int i = g; i < g + kGroup; ++i) {
          const unsigned sel = d2[i] <= t;
          if (i < 32) sel_lo |= sel << i;
          else sel_hi |= sel << (i & 31);
        }
      }
    }

    // the 4 slots (the same in every lane)
    unsigned lv[kK];
    int li[kK];
    const unsigned count = __reduce_add_sync(
        kFull, __popc(sel_lo) + (kChunks > 32 ? __popc(sel_hi) : 0));
    if (count <= 32) {
      rank_candidates<kChunks>(sel_lo, sel_hi, count, t0, t1, t2, px, py,
                               pz, p2, s_pix, s_cand, lane, lv, li);
    } else {
      walk_candidates<kChunks>(sel_lo, sel_hi, t0, px, py, pz, p2, s_pix,
                               lv, li);
    }

    // the weights: lane l takes slot l mod 4's divisions
    const int s = lane & 3;
    const unsigned vs = s == 0 ? lv[0] : s == 1 ? lv[1] : s == 2 ? lv[2]
                                                                : lv[3];
    const float w = __fdiv_rn(1.0f, __fadd_rn(__uint_as_float(vs), 1e-8f));
    float ws[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) ws[k] = __shfl_sync(kFull, w, k);
    float total = ws[0];
#pragma unroll
    for (int k = 1; k < kK; ++k) total = __fadd_rn(total, ws[k]);
    const float wn = __fdiv_rn(w, __fadd_rn(total, 1e-8f));
#pragma unroll
    for (int k = 0; k < kK; ++k) ws[k] = __shfl_sync(kFull, wn, k);

    // the rows: kRows rows' loads before their products, in slot order
    float* o = out + (static_cast<size_t>(b) * n + pt) * c;
    for (int c0 = 0; c0 < c; c0 += 32 * kPer) {
      float acc[kPer];
#pragma unroll
      for (int r0 = 0; r0 < kK; r0 += kRows) {
        float v[kRows][kPer];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float* f = feat_b + static_cast<size_t>(li[r0 + r]) * c;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int ch = c0 + lane + 32 * k;
            v[r][k] = ch < c ? row_value(f, li[r0 + r], ch) : 0.0f;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const float prod = __fmul_rn(ws[r0 + r], v[r][k]);
            acc[k] = r0 + r == 0 ? prod : __fadd_rn(acc[k], prod);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int ch = c0 + lane + 32 * k;
        if (ch < c) o[ch] = acc[k];
      }
    }
  }
}

size_t smem_bytes(int hw) {
  return static_cast<size_t>(padded_hw(hw)) * sizeof(float4) +
         kWarps * 32 * sizeof(int);
}

using KernelFn = void (*)(const float*, const float*, const float*, float*,
                          int, int, int);

// the build for HW, so that a lane holds no more registers than the
// model's shape needs: 32 chunks up to HW = 1024, 64 above
KernelFn kernel_for(int hw) {
  return hw <= 1024 ? pixel_sampler_kernel<32>
                    : pixel_sampler_kernel<kMaxHW / 32>;
}

}  // namespace

extern "C" int kpf_pixel_sampler(const float* pcl, const float* img,
                                 const float* feat, float* out, int b, int n,
                                 int hw, int c, cudaStream_t stream) {
  if (hw < kK || hw > kMaxHW || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kPointsPerBlock - 1) / kPointsPerBlock, b);
  kernel_for(hw)<<<grid, kThreads, smem_bytes(hw), stream>>>(
      pcl, img, feat, out, n, hw, c);
  return static_cast<int>(cudaGetLastError());
}

// What the launch for (hw, c) uses: points per block, dynamic shared
// memory per block, blocks that fit on one SM, threads per block, rows in
// flight per warp.
extern "C" int kpf_pixel_sampler_info(int hw, int c, int* points_per_block,
                                      int* smem, int* blocks_per_sm,
                                      int* threads, int* rows) {
  (void)c;
  *points_per_block = kPointsPerBlock;
  *smem = static_cast<int>(smem_bytes(hw));
  *threads = kThreads;
  *rows = kRows;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_for(hw), kThreads, *smem));
}
