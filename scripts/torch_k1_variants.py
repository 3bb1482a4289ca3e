#!/usr/bin/env python3
"""Time builds of the K1 'default' kernel side by side, on the card.

    python3 scripts/torch_k1_variants.py SOURCE [SOURCE ...] [--rounds 2]

Each SOURCE is a CUDA file that exports kpf_desa_dense_serving and
kpf_desa_dense_serving_info with the C signatures of
keypointfusion_torch/csrc/desa_dense_serving.cu (the port's kernel, or a
variant of it). Each is built with the port's nvcc flags, with its own
directory and keypointfusion_torch/csrc/ on the include path, then
launched through the
port's wrapper (kernels/desa_dense.py:desa_dense_serving) on
chip_smoke.py's K1 inputs (batch 64, seeded weights): checked against the
plain version at chip_smoke.py's limit (1e-3 of the scale) and timed on
the device with torch.profiler, in mirrored order (A, B, B, A per round).
Prints each build's registers, spills, joints per block, shared memory and
blocks per SM, one line per timing, the card's name and power limit, then
one JSON object as its last line. Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def build(source: Path, index: int):
    """nvcc a source into a library; returns (its path, ptxas's register
    and spill lines)."""
    from keypointfusion_torch.kernels import build as kb
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kb.BUILD_DIR / f'variant-{index}-{source.stem}-{os.getpid()}.so'
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, '-I', str(source.parent), '-I',
           str(kb.CSRC_DIR), '-o', str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {source}:\n{proc.stdout}'
                           f'{proc.stderr}')
    usage = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if 'registers' in ln or 'spill' in ln]
    return lib, usage


def main():
    import torch

    import chip_smoke
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.kernels import desa_dense as k1

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('sources', nargs='+', type=Path)
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    fns, report = {}, {}
    for index, source in enumerate(args.sources):
        spec = str(source)
        lib, usage = build(source, index)
        fn = ctypes.CDLL(str(lib)).kpf_desa_dense_serving
        fn.argtypes = k1.SERVING_KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[spec] = fn
        tile, smem, blocks = k1.serving_kernel_info(lib)
        report[spec] = {'ptxas': usage, 'joint_tile': tile,
                        'smem_bytes': smem, 'blocks_per_sm': blocks,
                        'device_ms': []}
        print(f'[build] {spec} joint_tile={tile} smem_bytes={smem} '
              f'blocks_per_sm={blocks} ptxas={json.dumps(usage)}',
              flush=True)

    dev = torch.device('cuda', 0)
    batch = synthetic_batch(batch_size=chip_smoke.BATCH, point_num=1024,
                            seed=1)
    (pcl_feat, node_feat, pcl_xyz, node_xyz), module = \
        chip_smoke.desa_inputs(dev, batch)
    inputs = (pcl_feat.bfloat16(), node_feat.bfloat16(), pcl_xyz, node_xyz)
    with torch.no_grad():
        w = module.folded_weights()
    pack = k1.serving_weights(w)
    radius, samples = module.radius, module.num_samples
    want = k1.desa_dense_plain(*inputs, w, radius, samples, 'default')
    tol = chip_smoke.K1_SERVING_TOL * max(1.0, float(want.abs().max()))

    def run(spec):
        k1.SERVING_KERNEL._fn = fns[spec]    # the wrapper launches it
        return k1.desa_dense_serving(*inputs, pack, radius, samples)

    ok = True
    for spec in fns:
        err = float((run(spec) - want).abs().max())
        report[spec]['max_abs_err'] = err
        ok &= err <= tol
        print(f'[check] {spec} max_abs_err={err} tol={tol}', flush=True)
    order = list(fns) + list(fns)[::-1]
    for rnd in range(args.rounds):
        for spec in order:
            ms = chip_smoke.device_ms(lambda: run(spec), 20,
                                      'desa_dense_serving_kernel')
            report[spec]['device_ms'].append(ms)
            print(f'[time] round={rnd} {spec} device_ms={ms:.5f}',
                  flush=True)
    k1.SERVING_KERNEL._fn = None
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({'variants': report, 'card': card}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
