// K2 serving mode: point -> pixel feature sampler, bfloat16, for sm_90a.
//
// Replaces keypointfusion_tpu/kernels/pixel_sampler_pallas.py:
// sample_pixel_features_fused in its 'default' mode (the pl.pallas_call at
// line 212, the serving branch of its kernel). For every cloud point n of
// batch element b, over the HW back-projected pixel centres x_m:
//   d2[m]  = fma(dz, dz, fma(dx, dx, dy*dy)),  d = p - x_m per coordinate
//            (the rounding of XLA's CPU build of the JAX kernel)
//   t      = the 4th smallest DISTINCT d2 (1e30 if there are fewer)
//   w[m]   = bf16(1 / (d2[m] + 1e-8))       for every m with d2[m] <= t
//   out[n] = bf16( sum_m w[m] f[m] / (sum_m w[m] + 1e-8) ),  f bfloat16,
//            both sums in float32, over the selected m in index order
// Exact ties admit whole rings of pixels, so the number selected has no
// bound: all of HW when the pixels lie at 3 or fewer distinct distances.
//
// What bounds it on the H100: bytes. At the serving shape (B=64,
// N=HW=1024, C=277) it reads the 36 MB bfloat16 map and writes the 36 MB
// output; one distance pass is about 0.5 G float operations, a few
// microseconds at the card's float32 rate. The JAX kernel builds a dense
// [N,HW] weight matrix for the MXU; here nothing of that size exists. The
// design:
//   * a block serves kPointsPerBlock points of one batch element, one warp
//     per point: its warps work on kWarps points side by side, each warp
//     on K2_POINTS_PER_WARP points in turn; the element's pixel centres are
//     staged once per block in shared memory as float4, padded with +inf
//     centres (whose d2 is +inf) to whole groups of chunks;
//   * one distance pass: lane l computes d2 of its pixels m = l + 32 i
//     once, kGroup chunks' loads at a time, and keeps them in registers
//     (kChunks per lane: 32 for HW <= 1024, 64 up to 2048);
//   * the threshold as a reduction: t0 = the warp's min; t_{k+1} = the
//     warp's min of the values above t_k. d2 >= 0, so a float's bits order
//     as the float: each lane takes the unsigned min of bits(d2) -
//     bits(t_k) - 1, where the values at or below t_k wrap to the top, and
//     the warp's min is one __reduce_min_sync;
//   * the selection: bit i of a lane's mask says whether its pixel of chunk
//     i is selected (d2 <= t), and the selected lanes write their d2 to the
//     warp's row in shared memory. The chunks with a selected pixel (an OR
//     over the warp) are visited in order, and __ballot_sync of a chunk's
//     bits gives its selected pixels, lowest lane first: index order. No
//     list of the selected pixels is kept, so their number costs no memory
//     and needs no overflow path;
//   * the sums: the selected pixels, lowest index first, kRows at a time:
//     the warp loads every channel of up to kRows rows into registers
//     (coalesced 2-byte loads, lanes across the channels: with C = 277
//     every other row starts only 2-byte aligned), then adds them in
//     order. A point costs ceil(S / kRows) round trips to L2, not S. Only
//     the selected pixels' weights are divided, once per row by the whole
//     warp.
// Registers set the occupancy: d2 lives in registers only until the
// selection, the rows in flight only in the sums. 4 warps a block and 2
// rows in flight measured fastest on the H100 (PERF.md).
// What holds it back there: issue slots in the distance pass and the
// threshold's three scans (the kernel without its rows takes about 0.09
// of its 0.15 ms), then the rows' round trips; more rows in flight, or
// rows staged through shared memory with cp.async, cost more in registers
// or instructions than they save (scripts/torch_k2_variants.py).
// Every rounding is an explicit intrinsic (__fmaf_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn, __float2bfloat16_rn), in the plain version's
// order, so the two agree bit for bit. kernels/pixel_sampler.py:
// _serving_plain_lanes runs the same steps on the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// block shape and rows in flight; a -D on the nvcc line overrides them
// (scripts/torch_k2_variants.py times such builds side by side)
#ifndef K2_WARPS
#define K2_WARPS 4
#endif
#ifndef K2_POINTS_PER_WARP
#define K2_POINTS_PER_WARP 4
#endif
#ifndef K2_ROWS
#define K2_ROWS 2
#endif

namespace {

constexpr int kWarps = K2_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kPointsPerBlock = kWarps * K2_POINTS_PER_WARP;
constexpr int kRows = K2_ROWS;
constexpr int kMaxHW = 2048;
constexpr int kGroup = 8;         // chunks of 32 pixels loaded together
constexpr int kMaxPerLane = 12;   // channels a lane holds: C <= 384
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;

__device__ __forceinline__ float serving_d2(float px, float py, float pz,
                                            float4 q) {
  const float dx = __fsub_rn(px, q.x);
  const float dy = __fsub_rn(py, q.y);
  const float dz = __fsub_rn(pz, q.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// The pixels padded to whole groups of chunks.
__host__ __device__ __forceinline__ int padded_hw(int hw) {
  return (hw + 32 * kGroup - 1) / (32 * kGroup) * (32 * kGroup);
}

// Adds `count` (<= kRows) queued rows in queue order: lane r holds the
// r-th row's pixel index, s_d2 the selected pixels' d2. Every row's loads
// are issued before the first product; each weight is divided once per
// row, by the whole warp.
template <int kPer>
__device__ __forceinline__ void add_rows(
    const unsigned short* __restrict__ feat_b, int c, const float* s_d2,
    int queued_row, int count, int lane, float (&acc)[kPer], float& total) {
  int m[kRows];
  unsigned short v[kRows][kPer];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = __shfl_sync(kFull, queued_row, r);
    if (r < count) {
      const unsigned short* f = feat_b + static_cast<size_t>(m[r]) * c;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int ch = lane + 32 * k;
        v[r][k] = ch < c ? __ldg(f + ch) : static_cast<unsigned short>(0);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < count) {
      const float w = __bfloat162float(__float2bfloat16_rn(
          __fdiv_rn(1.0f, __fadd_rn(s_d2[m[r]], 1e-8f))));
      total = __fadd_rn(total, w);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        // bfloat16 x bfloat16 is exact in float32: one rounding, as the
        // plain version's separate product and sum
        acc[k] = __fmaf_rn(w, bf16_bits_to_float(v[r][k]), acc[k]);
      }
    }
  }
}

// kPer: channel slots per lane (C <= 32 kPer); kChunks: pixel chunks a
// lane holds (HW <= 32 kChunks)
template <int kPer, int kChunks>
__global__ void __launch_bounds__(kThreads)
pixel_sampler_serving_kernel(const float* __restrict__ pcl,   // [B,N,3]
                             const float* __restrict__ img,   // [B,HW,3]
                             const __nv_bfloat16* __restrict__ feat,
                             __nv_bfloat16* __restrict__ out,  // [B,N,C]
                             int n, int hw, int c) {
  // [span] pixel centres, then one [span] row of d2 per warp
  extern __shared__ float4 s_pix[];
  const int span = padded_hw(hw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPointsPerBlock;
  float* s_d2 = reinterpret_cast<float*>(s_pix + span) + warp * span;
  const float* img_b = img + static_cast<size_t>(b) * hw * 3;
  const float inf = __uint_as_float(kInfBits);
  for (int m = threadIdx.x; m < span; m += kThreads) {
    s_pix[m] = m < hw ? make_float4(img_b[3 * m], img_b[3 * m + 1],
                                    img_b[3 * m + 2], 0.0f)
                      : make_float4(inf, inf, inf, 0.0f);
  }
  __syncthreads();

  const unsigned short* feat_b =
      reinterpret_cast<const unsigned short*>(feat) +
      static_cast<size_t>(b) * hw * c;
  const int chunks = (hw + 31) / 32;
  const int p_end = min(p0 + kPointsPerBlock, n);

  for (int pt = p0 + warp; pt < p_end; pt += kWarps) {
    const float* pp = pcl + (static_cast<size_t>(b) * n + pt) * 3;
    const float px = pp[0], py = pp[1], pz = pp[2];

    // the one distance pass, with the lane's min
    float d2[kChunks];
    unsigned lo = kInfBits;
#pragma unroll
    for (int g = 0; g < kChunks; g += kGroup) {
      if (g < chunks) {                               // warp-uniform
#pragma unroll
        for (int i = g; i < g + kGroup; ++i) {
          d2[i] = serving_d2(px, py, pz, s_pix[32 * i + lane]);
          lo = min(lo, __float_as_uint(d2[i]));
        }
      }
    }
    // the threshold: t0, then three times the least value above t
    unsigned t = __reduce_min_sync(kFull, lo);
#pragma unroll 1
    for (int k = 1; k < 4; ++k) {
      const unsigned above = t + 1u;   // values <= t wrap past 2^31
      unsigned u = 0xffffffffu;
#pragma unroll
      for (int g = 0; g < kChunks; g += kGroup) {
        if (g < chunks) {
#pragma unroll
          for (int i = g; i < g + kGroup; ++i) {
            u = min(u, __float_as_uint(d2[i]) - above);
          }
        }
      }
      u = __reduce_min_sync(kFull, u);
      t = u < 0x80000000u ? u + above : kInfBits;
    }
    const float thresh = t == kInfBits ? 1e30f : __uint_as_float(t);

    // the selection: bit i of the lane's mask for pixel 32 i + lane; the
    // selected pixels' d2 to the warp's row
    __syncwarp();                      // the last point's row is read
    unsigned sel_lo = 0, sel_hi = 0;   // chunks 0-31, 32-63
#pragma unroll
    for (int g = 0; g < kChunks; g += kGroup) {
      if (g < chunks) {
#pragma unroll
        for (int i = g; i < g + kGroup; ++i) {
          const bool sel = d2[i] <= thresh;
          if (sel) s_d2[32 * i + lane] = d2[i];
          if (i < 32) sel_lo |= static_cast<unsigned>(sel) << i;
          else sel_hi |= static_cast<unsigned>(sel) << (i - 32);
        }
      }
    }
    __syncwarp();

    // the sums, in index order, kRows rows at a time
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.0f;
    float total = 0.0f;
    int queued = 0, queued_row = 0;   // lane r < queued: the r-th row
#pragma unroll
    for (int half = 0; half < kChunks / 32; ++half) {
      const unsigned mine = half == 0 ? sel_lo : sel_hi;
      unsigned todo = __reduce_or_sync(kFull, mine);     // chunks to visit
      while (todo) {                                     // warp-uniform
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        // chunk 32 half + j's selected pixels, lowest lane first
        unsigned ball = __ballot_sync(kFull, (mine >> j) & 1u);
        while (ball) {
          const int src = __ffs(ball) - 1;
          ball &= ball - 1;
          if (lane == queued) queued_row = 32 * (32 * half + j) + src;
          if (++queued == kRows) {
            add_rows<kPer>(feat_b, c, s_d2, queued_row, kRows, lane, acc,
                           total);
            queued = 0;
          }
        }
      }
    }
    if (queued > 0) {
      add_rows<kPer>(feat_b, c, s_d2, queued_row, queued, lane, acc,
                     total);
    }

    const float denom = __fadd_rn(total, 1e-8f);
    __nv_bfloat16* o = out + (static_cast<size_t>(b) * n + pt) * c;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int ch = lane + 32 * k;
      if (ch < c) o[ch] = __float2bfloat16_rn(__fdiv_rn(acc[k], denom));
    }
  }
}

size_t smem_bytes(int hw) {
  return static_cast<size_t>(padded_hw(hw)) *
         (sizeof(float4) + kWarps * sizeof(float));
}

using KernelFn = void (*)(const float*, const float*, const __nv_bfloat16*,
                          __nv_bfloat16*, int, int, int);

// the build for (HW, C), so that a lane holds no more registers than the
// model's shape needs: 32 chunks up to HW = 1024 (64 above), 9 channel
// slots up to C = 288 (C = 277; 12 above)
KernelFn kernel_for(int hw, int c) {
  if (hw <= 1024) {
    return c <= 288 ? pixel_sampler_serving_kernel<9, 32>
                    : pixel_sampler_serving_kernel<kMaxPerLane, 32>;
  }
  return c <= 288 ? pixel_sampler_serving_kernel<9, kMaxHW / 32>
                  : pixel_sampler_serving_kernel<kMaxPerLane, kMaxHW / 32>;
}

int allow_smem(KernelFn kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

extern "C" int kpf_pixel_sampler_serving(const float* pcl, const float* img,
                                         const __nv_bfloat16* feat,
                                         __nv_bfloat16* out, int b, int n,
                                         int hw, int c, cudaStream_t stream) {
  if (hw < 4 || hw > kMaxHW || c < 1 || c > 32 * kMaxPerLane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KernelFn kernel = kernel_for(hw, c);
  const size_t smem = smem_bytes(hw);
  if (smem > 48 * 1024) {
    const int err = allow_smem(kernel, smem);
    if (err != 0) return err;
  }
  const dim3 grid((n + kPointsPerBlock - 1) / kPointsPerBlock, b);
  kernel<<<grid, kThreads, smem, stream>>>(pcl, img, feat, out, n, hw, c);
  return static_cast<int>(cudaGetLastError());
}

// What the launch for (hw, c) uses: points per block, dynamic shared
// memory per block, blocks that fit on one SM, threads per block, rows in
// flight per warp.
extern "C" int kpf_pixel_sampler_serving_info(int hw, int c,
                                              int* points_per_block,
                                              int* smem, int* blocks_per_sm,
                                              int* threads, int* rows) {
  const KernelFn kernel = kernel_for(hw, c);
  *points_per_block = kPointsPerBlock;
  *smem = static_cast<int>(smem_bytes(hw));
  *threads = kThreads;
  *rows = kRows;
  const int err = allow_smem(kernel, *smem);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, *smem));
}
