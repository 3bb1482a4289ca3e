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
// fixed bound (13 for a point on a pixel centre of a flat dyadic grid).
//
// What bounds it on the H100: bytes. At the serving shape (B=64,
// N=HW=1024, C=277) it reads the 36 MB bfloat16 map and writes the 36 MB
// output; the two distance passes are about 1.2 G float operations, a few
// tens of microseconds at the card's float32 rate. The design:
//   * pass 1, one thread per point: scan the pixels (staged once per block
//     in shared memory, one broadcast float4 load a step) keeping the 4
//     smallest distinct d2 sorted in registers (fully unrolled);
//   * pass 2, one warp per point: the lanes recompute d2 for 32 pixels at
//     a time with the same intrinsics, a ballot gives the selected ones,
//     and for each, lowest index first, the warp adds w * f[m] with its
//     lanes across the channels (coalesced bfloat16 reads). No list of the
//     selected pixels is kept, so their number costs no memory.
// Every rounding is an explicit intrinsic (__fmaf_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn, __float2bfloat16_rn), in the plain version's
// order, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 4;
constexpr int kThreads = 128;
constexpr int kMaxPerLane = 12;   // channels a lane holds: C <= 384
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float serving_d2(float px, float py, float pz,
                                            float4 q) {
  const float dx = __fsub_rn(px, q.x);
  const float dy = __fsub_rn(py, q.y);
  const float dz = __fsub_rn(pz, q.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

__global__ void __launch_bounds__(kThreads)
pixel_sampler_serving_kernel(const float* __restrict__ pcl,   // [B,N,3]
                             const float* __restrict__ img,   // [B,HW,3]
                             const __nv_bfloat16* __restrict__ feat,
                             __nv_bfloat16* __restrict__ out,  // [B,N,C]
                             int n, int hw, int c) {
  extern __shared__ float4 s_pix[];                   // [HW]
  __shared__ float s_thresh[kThreads];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kThreads;
  const float* img_b = img + static_cast<size_t>(b) * hw * 3;
  for (int m = tid; m < hw; m += kThreads) {
    s_pix[m] = make_float4(img_b[3 * m], img_b[3 * m + 1], img_b[3 * m + 2],
                           0.0f);
  }
  __syncthreads();

  // pass 1: the 4 smallest distinct values, ascending
  if (p0 + tid < n) {
    const float* pp = pcl + (static_cast<size_t>(b) * n + p0 + tid) * 3;
    const float px = pp[0], py = pp[1], pz = pp[2];
    float t[kK];
#pragma unroll
    for (int i = 0; i < kK; ++i) t[i] = __int_as_float(0x7f800000);  // +inf
    for (int m = 0; m < hw; ++m) {
      const float d = serving_d2(px, py, pz, s_pix[m]);
      if (d < t[kK - 1] && d != t[0] && d != t[1] && d != t[2]) {
        t[kK - 1] = d;
#pragma unroll
        for (int i = kK - 1; i > 0; --i) {
          if (t[i] < t[i - 1]) {
            const float tmp = t[i];
            t[i] = t[i - 1];
            t[i - 1] = tmp;
          }
        }
      }
    }
    s_thresh[tid] = t[kK - 1] == __int_as_float(0x7f800000) ? 1e30f
                                                             : t[kK - 1];
  }
  __syncthreads();

  // pass 2: warp w handles the block's points 32w .. 32w+31
  const int warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* feat_b = feat + static_cast<size_t>(b) * hw * c;
  for (int q = 0; q < 32; ++q) {
    const int t = warp * 32 + q;
    const int pt = p0 + t;
    if (pt >= n) break;
    const float* pp = pcl + (static_cast<size_t>(b) * n + pt) * 3;
    const float px = pp[0], py = pp[1], pz = pp[2];
    const float thresh = s_thresh[t];
    float acc[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) acc[i] = 0.0f;
    float total = 0.0f;
    for (int base = 0; base < hw; base += 32) {
      const int m = base + lane;
      float w = 0.0f;
      bool sel = false;
      if (m < hw) {
        const float d = serving_d2(px, py, pz, s_pix[m]);
        sel = d <= thresh;
        w = __bfloat162float(__float2bfloat16_rn(
            __fdiv_rn(1.0f, __fadd_rn(d, 1e-8f))));
      }
      unsigned ball = __ballot_sync(kFull, sel);
      while (ball) {                                  // warp-uniform
        const int src = __ffs(ball) - 1;
        ball &= ball - 1;
        const float ws = __shfl_sync(kFull, w, src);
        total = __fadd_rn(total, ws);
        const __nv_bfloat16* f = feat_b + static_cast<size_t>(base + src) * c;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int ch = lane + 32 * i;
          // bfloat16 x bfloat16 is exact in float32: one rounding, as the
          // plain version's separate product and sum
          if (ch < c) acc[i] = __fmaf_rn(ws, __bfloat162float(f[ch]), acc[i]);
        }
      }
    }
    const float denom = __fadd_rn(total, 1e-8f);
    __nv_bfloat16* o = out + (static_cast<size_t>(b) * n + pt) * c;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int ch = lane + 32 * i;
      if (ch < c) o[ch] = __float2bfloat16_rn(__fdiv_rn(acc[i], denom));
    }
  }
}

}  // namespace

extern "C" int kpf_pixel_sampler_serving(const float* pcl, const float* img,
                                         const __nv_bfloat16* feat,
                                         __nv_bfloat16* out, int b, int n,
                                         int hw, int c, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  const size_t smem = static_cast<size_t>(hw) * sizeof(float4);
  pixel_sampler_serving_kernel<<<grid, kThreads, smem, stream>>>(
      pcl, img, feat, out, n, hw, c);
  return static_cast<int>(cudaGetLastError());
}
