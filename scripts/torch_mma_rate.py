#!/usr/bin/env python3
"""The rate of warp-level tensor-core products (mma.sync) on the card.

    python3 scripts/torch_mma_rate.py

Builds a small CUDA library (nvcc, the port's flags) whose kernels run
nothing but mma.sync products on registers: each warp keeps `chains`
independent accumulators and runs `iters` rounds of one product into
each. Timed with CUDA events over 132 x 4 blocks of 1, 2 or 4 warps per
scheduler (4, 8 or 16 warps per block), for
  * m16n8k8 with tf32 operands (2,048 flops a product), as the K1
    'highest' kernel runs them, with 16 chains and with 4;
  * m16n8k16 with bfloat16 operands (4,096 flops), as K1 'default' does.
Prints one line per case (TFLOP/s), the card's name and power limit, and
one JSON object as its last line. Needs a CUDA device and nvcc.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>

template <int kChains, bool kTf32>
__global__ void mma_rate(float* out, int iters) {
  float d[kChains][4];
  for (int c = 0; c < kChains; ++c) {
    d[c][0] = d[c][1] = d[c][2] = d[c][3] = 0.0f;
  }
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = 0x3f800000u + threadIdx.x + e;
  b[0] = 0x3f800000u + threadIdx.x;
  b[1] = 0x3f000000u + threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (kTf32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  float s = 0.0f;
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int kpf_mma_rate(int kind, float* out, int blocks, int threads,
                            int iters, cudaStream_t stream) {
  if (kind == 0) {
    mma_rate<16, true><<<blocks, threads, 0, stream>>>(out, iters);
  } else if (kind == 1) {
    mma_rate<4, true><<<blocks, threads, 0, stream>>>(out, iters);
  } else {
    mma_rate<16, false><<<blocks, threads, 0, stream>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
'''

# kind -> (name, chains, flops per product)
KINDS = {0: ('tf32_m16n8k8', 16, 2048), 1: ('tf32_m16n8k8', 4, 2048),
         2: ('bf16_m16n8k16', 16, 4096)}


def main():
    import torch

    import chip_smoke
    from keypointfusion_torch.kernels import build as kb

    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kb.BUILD_DIR / f'mma_rate-{os.getpid()}.cu'
    lib = src.with_suffix('.so')
    src.write_text(SOURCE)
    subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, '-o', str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).kpf_mma_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    blocks, iters = 132 * 4, 2048
    out = torch.empty(blocks * 1024, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for kind, (name, chains, flops) in KINDS.items():
        for warps in (4, 8, 16):
            threads = 32 * warps

            def run():
                rc = fn(kind, out.data_ptr(), blocks, threads, iters, stream)
                if rc != 0:
                    raise RuntimeError(f'mma_rate failed with cudaError {rc}')

            ms = chip_smoke.cuda_ms(run, 5)
            total = blocks * warps * iters * chains * flops
            rate = total / ms / 1e9
            results.append({'product': name, 'chains': chains,
                            'warps_per_scheduler': warps // 4, 'ms': ms,
                            'tflop_per_s': rate})
            print(f'[rate] {name} chains={chains} '
                  f'warps_per_scheduler={warps // 4} ms={ms:.4f} '
                  f'tflop_per_s={rate:.1f}', flush=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({'mma_rate': results, 'card': card}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
