#!/usr/bin/env python3
"""Time builds of a K1 kernel side by side, on the card.

    python3 scripts/torch_k1_variants.py SOURCE [SOURCE ...]
        [--mode default|highest] [--rounds 2] [--sass]

Each SOURCE is a CUDA file that exports the mode's C entry point and its
info entry point with the signatures of the port's kernel
(keypointfusion_torch/csrc/desa_dense_serving.cu for 'default',
kpf_desa_dense_serving; csrc/desa_dense.cu for 'highest',
kpf_desa_dense): the port's kernel, or a variant of it. Each is built with
the port's nvcc flags, with its own directory and
keypointfusion_torch/csrc/ on the include path, then launched through the
port's wrapper (kernels/desa_dense.py:desa_dense_serving or
desa_dense_highest) on chip_smoke.py's K1 inputs (batch 64, seeded
weights): checked against the plain version at chip_smoke.py's limit for
the mode (1e-3 of the scale, or 1e-4), compared bit for bit with the first
SOURCE's output, and timed on the device with torch.profiler, in mirrored
order (A, B, B, A per round). Prints each build's registers, spills,
joints per block, shared memory and blocks per SM (with --sass also its
most frequent SASS opcodes, from cuobjdump), one line per timing, the
card's name and power limit, then one JSON object as its last line. Needs
a CUDA device and nvcc.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
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


def sass_opcodes(lib: Path, top: int = 16):
    """The most frequent SASS opcodes of a library's kernels (cuobjdump
    from the CUDA toolkit): [[opcode, count], ...]."""
    from keypointfusion_torch.kernels import build as kb
    tool = shutil.which('cuobjdump') or str(
        Path(kb._nvcc()).parent / 'cuobjdump')
    text = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops = collections.Counter(
        m.group(1).split('.')[0] for m in
        re.finditer(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)',
                    text))
    return [[op, n] for op, n in ops.most_common(top)]


def main():
    import torch

    import chip_smoke
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.kernels import desa_dense as k1

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('sources', nargs='+', type=Path)
    parser.add_argument('--mode', choices=('default', 'highest'),
                        default='default')
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--sass', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    highest = args.mode == 'highest'
    kernel = k1.KERNEL if highest else k1.SERVING_KERNEL

    fns, report = {}, {}
    for index, source in enumerate(args.sources):
        spec = str(source)
        lib, usage = build(source, index)
        fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        fns[spec] = fn
        tile, smem, blocks = k1.kernel_info(args.mode, lib)
        report[spec] = {'ptxas': usage, 'joint_tile': tile,
                        'smem_bytes': smem, 'blocks_per_sm': blocks,
                        'device_ms': []}
        if args.sass:
            report[spec]['sass_top'] = sass_opcodes(lib)
        print(f'[build] {spec} joint_tile={tile} smem_bytes={smem} '
              f'blocks_per_sm={blocks} ptxas={json.dumps(usage)} '
              f'sass_top={json.dumps(report[spec].get("sass_top"))}',
              flush=True)

    dev = torch.device('cuda', 0)
    batch = synthetic_batch(batch_size=chip_smoke.BATCH, point_num=1024,
                            seed=1)
    (pcl_feat, node_feat, pcl_xyz, node_xyz), module = \
        chip_smoke.desa_inputs(dev, batch)
    if not highest:
        pcl_feat, node_feat = pcl_feat.bfloat16(), node_feat.bfloat16()
    inputs = (pcl_feat, node_feat, pcl_xyz, node_xyz)
    with torch.no_grad():
        w = module.folded_weights()
    pack = k1.highest_weights(w) if highest else k1.serving_weights(w)
    launch = k1.desa_dense_highest if highest else k1.desa_dense_serving
    radius, samples = module.radius, module.num_samples
    want = k1.desa_dense_plain(*inputs, w, radius, samples, args.mode)
    tol = chip_smoke.K1_TOL if highest else \
        chip_smoke.K1_SERVING_TOL * max(1.0, float(want.abs().max()))

    def run(spec):
        kernel._fn = fns[spec]    # the wrapper launches it
        return launch(*inputs, pack, radius, samples)

    ok, first = True, None
    for spec in fns:
        got = run(spec)
        first = got if first is None else first
        err = float((got - want).abs().max())
        report[spec]['max_abs_err'] = err
        report[spec]['same_bits_as_first'] = bool(torch.equal(got, first))
        ok &= err <= tol
        print(f'[check] {spec} max_abs_err={err} tol={tol} '
              f'same_bits_as_first={report[spec]["same_bits_as_first"]}',
              flush=True)
    order = list(fns) + list(fns)[::-1]
    for rnd in range(args.rounds):
        for spec in order:
            ms = chip_smoke.device_ms(lambda: run(spec), 20,
                                      kernel.name + '_kernel')
            report[spec]['device_ms'].append(ms)
            print(f'[time] round={rnd} {spec} device_ms={ms:.5f}',
                  flush=True)
    kernel._fn = None
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({'variants': report, 'mode': args.mode, 'card': card}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
