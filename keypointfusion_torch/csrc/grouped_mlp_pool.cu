// K3: grouped DESA MLP + max-pool over pre-gathered groups at float32
// accuracy, on the tensor cores (three tf32 products per product), for
// sm_90a.
//
// Replaces keypointfusion_tpu/kernels/desa_pallas.py:grouped_mlp_pool (the
// pl.pallas_call at line 97). For each group (joint j, batch element b) of
// S slots, C = 128:
//   h1[t] = relu((rel_t Wl + bl) + ((g_t - node) Wf + bf))
//   h2[t] = relu(h1[t] W2 + b2)
//   out   = max of h2 over the slots t with |rel_t|^2 < 1, or t = 0
// rel arrives divided by the radius, the weights BN-folded in Dense layout
// [in, out] (kernels/grouped_mlp_pool.py). The kept slots are recomputed
// from rel, as the JAX kernel recomputes them, with |rel|^2 rounded as
// desa::sqnorm3 rounds it, so the mask matches the plain version bit for
// bit.
//
// What bounds it on the H100: operations. At the serving shape (B=64,
// J=21, S=64) a launch runs 86,016 slots through two 128 x 128 products:
// 5.6 G products, 16.9 G as three TF32 products at 495 TFLOP/s, 0.034 ms
// (on the CUDA cores 0.085 ms); its 46.6 MB of inputs take 0.014 ms. The
// design:
//   * each product at float32 accuracy as three tf32 mma.sync (lo_a hi_b,
//     hi_a lo_b, hi_a hi_b), each k-step's three in a fresh fragment
//     added to the sum rounded to nearest, as csrc/desa_mma.cuh:mma_tf32x3
//     sums them: the tensor core truncates the sums it takes, and one long
//     chain drifts (2.4e-4 measured for K1 'highest'); g - node, the
//     coordinate term, the biases and the relus in float32 on the CUDA
//     cores;
//   * a persistent grid, one block of 16 warps per SM, each block with a
//     contiguous share of the groups, two groups (the last step may hold
//     one) of 64 rows per step (a longer group in steps of 64 rows); a
//     warp takes 16 rows and 64 of the 128 outputs, so 4 warps run on
//     each scheduler at 128 registers; a warp whose rows all lie beyond
//     the group skips its products;
//   * Wf, then W2, stream through shared memory in chunks of 32 k-rows,
//     the same 8 chunks in the same order every step: cp.async copies each
//     chunk as it is in global memory, four chunks ahead, and the block's
//     threads split it into tf32 hi and lo once, for all 16 warps, into
//     fragment order (a lane reads the b0/b1 of its n-tile and k-step as
//     hi and lo with one 16-byte load), a part between each k-step's
//     products, so the split overlaps them;
//   * one __syncthreads per chunk: it publishes the chunk split last and
//     frees the buffers read before it;
//   * h1 goes to the row buffer in place of the rows (one more sync), and
//     the second product reads it as the first read the rows; the next
//     step's rows (with rel and node) come in by cp.async a quarter at a
//     time, each as soon as the second product has read the same columns
//     of h1;
//   * the max: in the fragment and across a quad's lanes; then each warp
//     writes its 64 maxima, and the block takes the max over a group's 4
//     row tiles after the next sync, one coalesced 512-byte store per
//     group. Rows past the group and slots outside the ball count as 0,
//     which is exact: slot 0 is always kept and every h2 is >= 0 (a
//     zero-filled row is not 0 after the two relus, hence the mask).
// Shared [rows][128] float32 tiles store 16-byte chunk c of row r at chunk
// c ^ (r % 8), so the 8 rows an ldmatrix reads fall on distinct banks.
// What holds it back (H100, PERF.md; scripts/torch_k3_variants.py): some
// 0.14 ms against the 0.035 ms bound. Without its products it takes 0.06
// ms (A fragments split by both warps of a row tile, the weight splits,
// syncs, epilogues); the fresh fragments' adds wait on their products (a
// build that chained each product in one accumulator ran 28% faster,
// outside the contract); 672 pairs make 6 steps on 132 SMs where 5.09
// would do.
//
// Switches for timing what the parts cost (scripts/torch_k3_variants.py;
// each gives a wrong output): K3_NO_PRODUCTS drops the mma.sync and the B
// loads; K3_NO_ROWS drops the row gathers. K3_SPLIT_PER_FRAGMENT keeps the
// chunks in float32 and has every warp split each B fragment as it loads
// it (K1 'highest''s way; the same output bits).

#include <cstdint>

#include <cuda_runtime.h>

#include "desa_common.cuh"
#include "desa_mma.cuh"

namespace {

using desa::kC;
using desa_mma::cp_async16;
using desa_mma::cp_async4;
using desa_mma::ldmatrix_x4;
using desa_mma::split_tf32;

constexpr int kGroups = 2;           // groups per step
constexpr int kRows = 64;            // rows of a group per step
constexpr int kWarps = 16;           // 2 groups x 4 row tiles x 2 halves
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 8;           // per step: Wf's 4, then W2's 4
constexpr int kStages = 4;           // chunks in flight as copied
// A chunk: 32 k-rows x 128 columns of Wf or W2, staged with rows 136
// floats apart (8 banks: the split's reads of k-rows t = 0..3 hit 32
// banks)
constexpr int kChunkK = 32, kStride = kC + 8;
constexpr int kQuads = kChunkK * kC / 2;
constexpr int kPerThread = kQuads / kThreads;
static_assert(kPerThread == kChunkK / 8, "one split part per k-step");
constexpr int kCopies = kChunkK * kC / 4 / kThreads;

struct Smem {
  float rows[kGroups][kRows * kC];          // g_t, then h1; swizzled
  float stage[kStages][kChunkK * kStride];
  uint4 split[2][kQuads];                   // fragment order, hi and lo
  float rel[kGroups][kRows][3];
  alignas(16) float node[kGroups][kC];
  alignas(16) float wmax[kGroups * 4][kC];  // per row tile
  alignas(16) float vec[5][kC];             // Wl (3 rows), bl + bf, b2
};

// element offset of 16-byte chunk `ch` of row `r` in a swizzled tile
__device__ __forceinline__ int swz(int r, int ch) {
  return r * kC + ((ch ^ (r & 7)) << 2);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// weight chunk q (of the endless sequence Wf 0-3, W2 0-3, Wf 0-3, ...)
// from global memory into its stage, 16 bytes per copy: chunk i of a
// matrix holds its k-rows 32i..32i+31
__device__ __forceinline__ void copy_chunk(Smem& sm, const float* wf,
                                           const float* w2, int q) {
  const int id = q % kChunks;
  const float* src = (id < kChunks / 2 ? wf : w2) +
                     (id % (kChunks / 2)) * kChunkK * kC;
  float* dst = sm.stage[q % kStages];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int k = idx >> 5, ch = idx & 31;
    cp_async16(dst + k * kStride + 4 * ch, src + k * kC + 4 * ch);
  }
}

// x split into tf32 hi and lo, as 16 bytes hi(x0), hi(x1), lo(x0), lo(x1)
// (with K3_SPLIT_PER_FRAGMENT the float32 values, left to load_b)
__device__ __forceinline__ uint4 split_pair(float x0, float x1) {
#ifdef K3_SPLIT_PER_FRAGMENT
  return make_uint4(__float_as_uint(x0), __float_as_uint(x1), 0u, 0u);
#else
  uint4 v;
  split_tf32(x0, v.x, v.z);
  split_tf32(x1, v.y, v.w);
  return v;
#endif
}

// part i (of kPerThread) of weight chunk q from its stage into split
// buffer q % 2, in fragment order: entry (kk * 16 + nt) * 32 + lane,
// lane = (g, t), holds the b0 and b1 of n-tile nt at k-step kk,
// B[k-row 8 kk + t][n 8 nt + g] and B[8 kk + t + 4][8 nt + g], as
// split_pair gives them
__device__ __forceinline__ void split_part(Smem& sm, int q, int i) {
  const float* src = sm.stage[q % kStages];
  const int quad = threadIdx.x + i * kThreads;
  const int kk = quad >> 9, nt = (quad >> 5) & 15, ln = quad & 31;
  const int k0 = 8 * kk + (ln & 3), n = 8 * nt + (ln >> 2);
  sm.split[q % 2][quad] = split_pair(src[k0 * kStride + n],
                                     src[(k0 + 4) * kStride + n]);
}

// the B fragments (hi and lo) of split entry e
__device__ __forceinline__ void load_b(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                       const uint4* split, int e) {
  const uint4 v = split[e];
#ifdef K3_SPLIT_PER_FRAGMENT
  split_tf32(__uint_as_float(v.x), hi[0], lo[0]);
  split_tf32(__uint_as_float(v.y), hi[1], lo[1]);
#else
  hi[0] = v.x;
  hi[1] = v.y;
  lo[0] = v.z;
  lo[1] = v.w;
#endif
}

// d = a b (d = 0 + a b when `fresh`): one 16x8x8 product, tf32 operands,
// float32 sums; not volatile, so the compiler may interleave independent
// products (csrc/desa_mma.cuh:mma_tf32 is volatile)
template <bool fresh>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if (fresh) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.0f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// the A fragment of k-step k8 for rows r0.. of a swizzled [row][128] tile,
// minus sub (e < 2: column 8 k8 + t, else + 4), split into hi and lo
__device__ __forceinline__ void load_a(uint32_t (&a_hi)[4],
                                       uint32_t (&a_lo)[4], const float* tile,
                                       int r0, int k8, float sub0, float sub1,
                                       int lane) {
  uint32_t a[4];
  ldmatrix_x4(a, tile + swz(r0 + (lane & 15), 2 * k8 + (lane >> 4)));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    split_tf32(__fsub_rn(__uint_as_float(a[e]), e < 2 ? sub0 : sub1),
               a_hi[e], a_lo[e]);
  }
}

// acc[nt] += a b for the warp's 8 n-tiles (its half, oh, of the 16) at
// k-step kk of a split chunk, as csrc/desa_mma.cuh:mma_tf32x3 sums it:
// lo_a hi_b, hi_a lo_b, hi_a hi_b in a fresh fragment, then added to acc
// rounded to nearest; pass by pass over the n-tiles, so their products do
// not wait on each other
__device__ __forceinline__ void kstep(float (&acc)[8][4],
                                      const uint32_t (&a_hi)[4],
                                      const uint32_t (&a_lo)[4],
                                      const uint4* split, int kk, int oh,
                                      int lane) {
#ifndef K3_NO_PRODUCTS
  uint32_t b_hi[8][2], b_lo[8][2];
  float d[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    load_b(b_hi[nt], b_lo[nt], split, (kk * 16 + oh * 8 + nt) * 32 + lane);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma<true>(d[nt], a_lo, b_hi[nt]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma<false>(d[nt], a_hi, b_lo[nt]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma<false>(d[nt], a_hi, b_hi[nt]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], d[nt][e]);
  }
#else
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] += __uint_as_float(a_hi[0] ^ a_lo[nt & 3]);
  }
#endif
}

__global__ void __launch_bounds__(kThreads, 1)
grouped_mlp_pool_kernel(const float* __restrict__ rel,      // [B*J,S,3]
                        const float* __restrict__ grouped,  // [B*J,S,C]
                        const float* __restrict__ node,     // [B*J,C]
                        const float* __restrict__ wl,       // [3,C]
                        const float* __restrict__ bl,       // [C]
                        const float* __restrict__ wf,       // [C,C]
                        const float* __restrict__ bf,       // [C]
                        const float* __restrict__ w2,       // [C,C]
                        const float* __restrict__ b2,       // [C]
                        float* __restrict__ out,            // [B*J,C]
                        int n_groups, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 3;         // the warp's group of the step
  const int tile = warp >> 1;        // its row tile of the block (0-7)
  const int r0 = (tile & 3) * 16;    // its first row of the group
  const int oh = warp & 1;           // its half of the 128 outputs
  // the block's groups: a contiguous share, 2 per step (the last step
  // may hold 1), so shares differ by at most one group
  const int g_begin = static_cast<int>(
      static_cast<long long>(blockIdx.x) * n_groups / gridDim.x);
  const int g_end = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * n_groups / gridDim.x);
  const int row_steps = (s + kRows - 1) / kRows;   // steps per pair
  const int steps = (g_end - g_begin + kGroups - 1) / kGroups * row_steps;
  // the first group of step st
  auto first_of = [&](int st) {
    return g_begin + (st / row_steps) * kGroups;
  };

  // quarter `part` of the rows of step st (their columns 32 part..) into
  // the row buffers, with rel and node in part 0; rows past the group that
  // a busy warp reads are zeros. A quarter goes in as soon as the second
  // product has read the same columns of h1.
  auto gather = [&](int st, int part) {
#ifndef K3_NO_ROWS
    const int f = first_of(st), row0 = (st % row_steps) * kRows;
    for (int gi = 0; gi < kGroups; ++gi) {
      const int grp_id = f + gi;
      if (grp_id >= g_end) break;
      const int n_in = min(kRows, s - row0);
      const int used = (n_in + 15) & ~15;
      const size_t base = static_cast<size_t>(grp_id) * s + row0;
      const int r = tid >> 3, ch = 8 * part + (tid & 7);
      const bool in = r < n_in;
      if (r < used) {
        cp_async16(sm.rows[gi] + swz(r, ch),
                   grouped + (base + (in ? r : 0)) * kC + 4 * ch, in);
      }
      if (part == 0 && tid < used * 3) {
        const bool in3 = tid / 3 < n_in;
        cp_async4(&sm.rel[gi][0][0] + tid,
                  rel + base * 3 + (in3 ? tid : 0), in3);
      }
      if (part == 0 && tid < 32) {
        cp_async16(sm.node[gi] + 4 * tid,
                   node + static_cast<size_t>(grp_id) * kC + 4 * tid);
      }
    }
#endif
  };

  // the output of the groups f, f + 1 whose last step ended, read from
  // the row tiles' maxima (called after a sync that follows their writes)
  auto flush = [&](int f) {
    const int gi = tid >> 7, c = tid & (kC - 1);
    const int grp_id = f + gi;
    if (gi < kGroups && grp_id < g_end) {
      const float* m = &sm.wmax[4 * gi][c];
      out[static_cast<size_t>(grp_id) * kC + c] =
          fmaxf(fmaxf(m[0], m[kC]), fmaxf(m[2 * kC], m[3 * kC]));
    }
  };

  for (int i = tid; i < 5 * kC; i += kThreads) {
    const int v = i / kC, c = i % kC;
    sm.vec[v][c] = v < 3 ? wl[i] : v == 3 ? __fadd_rn(bl[c], bf[c]) : b2[c];
  }
  if (steps == 0) return;

  // chunks 0-3 in flight, the first step's rows with chunk 0
  for (int part = 0; part < 4; ++part) gather(0, part);
#pragma unroll
  for (int q = 0; q < kStages; ++q) {
    copy_chunk(sm, wf, w2, q);
    desa_mma::cp_async_commit();
  }
  desa_mma::cp_async_wait<kStages - 1>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) split_part(sm, 0, i);

  int pending = -1;  // the first group of the pair waiting for a flush
  // Chunk q's turn: chunk q + 1 has landed (and, at a step's first chunk,
  // its rows), all warps are past chunk q - 1's products and chunk q's
  // split; then chunk q + 4 is copied into the stage chunk q left (at W2's
  // chunks 1-3, with a quarter of the next step's rows). The caller
  // splits chunk q + 1 between chunk q's products. Returns the split
  // chunk q's products read.
  auto turn = [&](int st, int c) -> const uint4* {
    const int q = st * kChunks + c;
    if (c == 0) {
      desa_mma::cp_async_wait<0>();
    } else {
      desa_mma::cp_async_wait<kStages - 2>();
    }
    __syncthreads();
    if (c == 0 && pending >= 0) {
      flush(pending);
      pending = -1;
    }
    copy_chunk(sm, wf, w2, q + kStages);
    if (c > kChunks / 2 && st + 1 < steps) {
      gather(st + 1, c - kChunks / 2 - 1);
    }
    desa_mma::cp_async_commit();
    return sm.split[q % 2];
  };

  for (int st = 0; st < steps; ++st) {
    const int f = first_of(st), row0 = (st % row_steps) * kRows;
    const int grp_id = f + grp;
    const int n_in = grp_id < g_end ? min(kRows, s - row0) : 0;
    const bool busy = r0 < n_in;
    float* rows = sm.rows[grp];

    // (g - node) Wf for the warp's 16 rows and 64 outputs
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    }
#pragma unroll 1
    for (int c = 0; c < kChunks / 2; ++c) {
      const uint4* split = turn(st, c);
      const int q = st * kChunks + c;
      const float* nd = sm.node[grp];
      // chunk q + 1 is split a part per k-step, between the products
#pragma unroll
      for (int kk = 0; kk < kChunkK / 8; ++kk) {
        if (busy) {
          const int k8 = c * (kChunkK / 8) + kk;
          uint32_t a_hi[4], a_lo[4];
          load_a(a_hi, a_lo, rows, r0, k8, nd[8 * k8 + t],
                 nd[8 * k8 + t + 4], lane);
          kstep(acc, a_hi, a_lo, split, kk, oh, lane);
        }
        split_part(sm, q + 1, kk);
      }
    }
    // the kept rows g and g + 8 of the warp
    bool keep[2];
    float rl[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
#pragma unroll
      for (int d = 0; d < 3; ++d) rl[h][d] = sm.rel[grp][r][d];
      keep[h] = r < n_in && (row0 + r == 0 ||
                             desa::sqnorm3(rl[h][0], rl[h][1], rl[h][2]) <
                                 1.0f);
    }
    __syncthreads();  // every warp has read its rows: h1 takes their place
    // h1 = relu(. + rel Wl + (bl + bf)) into the row buffer
    if (busy) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = oh * 64 + nt * 8 + 2 * t;
        const float2 v0 = ld2(&sm.vec[0][c]), v1 = ld2(&sm.vec[1][c]);
        const float2 v2 = ld2(&sm.vec[2][c]), bc = ld2(&sm.vec[3][c]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* x = rl[h];
          const float lo = fmaf(v2.x, x[2], fmaf(v1.x, x[1],
                                                 fmaf(v0.x, x[0], bc.x)));
          const float hi = fmaf(v2.y, x[2], fmaf(v1.y, x[1],
                                                 fmaf(v0.y, x[0], bc.y)));
          const int r = r0 + g + 8 * h;
          *reinterpret_cast<float2*>(rows + swz(r, c >> 2) + (c & 3)) =
              make_float2(fmaxf(__fadd_rn(acc[nt][2 * h], lo), 0.0f),
                          fmaxf(__fadd_rn(acc[nt][2 * h + 1], hi), 0.0f));
        }
      }
    }

    // h1 W2 for the warp's 16 rows and 64 outputs (the next turn's sync
    // publishes h1)
    float acc2[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc2[nt][0] = acc2[nt][1] = acc2[nt][2] = acc2[nt][3] = 0.0f;
    }
#pragma unroll 1
    for (int c = kChunks / 2; c < kChunks; ++c) {
      const uint4* split = turn(st, c);
      const int q = st * kChunks + c;
#pragma unroll
      for (int kk = 0; kk < kChunkK / 8; ++kk) {
        if (busy) {
          uint32_t a_hi[4], a_lo[4];
          load_a(a_hi, a_lo, rows, r0,
                 (c - kChunks / 2) * (kChunkK / 8) + kk, 0.0f, 0.0f, lane);
          kstep(acc2, a_hi, a_lo, split, kk, oh, lane);
        }
        split_part(sm, q + 1, kk);
      }
    }
    // h2 = relu(. + b2); its max over the warp's kept rows, 0 standing for
    // the rest and for relu's floor; with the tile's earlier rows of the
    // same pair
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = oh * 64 + nt * 8 + 2 * t;
      const float2 bc = ld2(&sm.vec[4][c]);
      float m0 = 0.0f, m1 = 0.0f;
      if (keep[0]) {
        m0 = fmaxf(m0, __fadd_rn(acc2[nt][0], bc.x));
        m1 = fmaxf(m1, __fadd_rn(acc2[nt][1], bc.y));
      }
      if (keep[1]) {
        m0 = fmaxf(m0, __fadd_rn(acc2[nt][2], bc.x));
        m1 = fmaxf(m1, __fadd_rn(acc2[nt][3], bc.y));
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      if (g == 0) {
        float2* w = reinterpret_cast<float2*>(&sm.wmax[tile][c]);
        if (row0 > 0) {
          const float2 old = *w;
          m0 = fmaxf(m0, old.x);
          m1 = fmaxf(m1, old.y);
        }
        *w = make_float2(m0, m1);
      }
    }
    if (st % row_steps == row_steps - 1) pending = f;
    // every warp has read h1: the last quarter of the next step's rows
    // takes its place
    __syncthreads();
    if (st + 1 < steps) gather(st + 1, 3);
    desa_mma::cp_async_commit();
  }
  desa_mma::cp_async_wait<0>();
  __syncthreads();
  flush(pending);
}

int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      grouped_mlp_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem))));
}

// blocks per SM and SMs of the current device, asked once per device
int launch_shape(int* blocks_per_sm, int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kDevices && cached[dev][0] > 0) {
    *blocks_per_sm = cached[dev][0];
    *sms = cached[dev][1];
    return 0;
  }
  int rc = allow_smem();
  if (rc != 0) return rc;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, grouped_mlp_pool_kernel, kThreads,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dev < kDevices) {
    cached[dev][0] = *blocks_per_sm;
    cached[dev][1] = *sms;
  }
  return 0;
}

}  // namespace

extern "C" int kpf_grouped_mlp_pool(const float* rel, const float* grouped,
                                    const float* node, const float* wl,
                                    const float* bl, const float* wf,
                                    const float* bf, const float* w2,
                                    const float* b2, float* out, int b,
                                    int j, int s, cudaStream_t stream) {
  int blocks_per_sm = 0, sms = 0;
  const int err = launch_shape(&blocks_per_sm, &sms);
  if (err != 0) return err;
  const int n_groups = b * j;
  const int n_pairs = (n_groups + kGroups - 1) / kGroups;
  const int grid = min(n_pairs, blocks_per_sm * sms);
  grouped_mlp_pool_kernel<<<grid, kThreads, sizeof(Smem), stream>>>(
      rel, grouped, node, wl, bl, wf, bf, w2, b2, out, n_groups, s);
  return static_cast<int>(cudaGetLastError());
}

// the groups per block and step, the dynamic shared memory of a block,
// the blocks that fit on an SM and the threads of a block
extern "C" int kpf_grouped_mlp_pool_info(int* groups_per_block,
                                         int* smem_bytes, int* blocks_per_sm,
                                         int* threads) {
  *groups_per_block = kGroups;
  *smem_bytes = static_cast<int>(sizeof(Smem));
  *threads = kThreads;
  int sms = 0;
  return launch_shape(blocks_per_sm, &sms);
}
