#!/usr/bin/env python3
"""Time builds of K2 'default' (the bfloat16 serving sampler) side by side,
on the card.

    python3 scripts/torch_k2_variants.py SPEC [SPEC ...] [--rounds 2]

Each SPEC is SOURCE[:NAME=VALUE,...][+no_rows]: a CUDA file that exports
kpf_pixel_sampler_serving with the port's signature
(keypointfusion_torch/csrc/pixel_sampler_serving.cu, or another version of
it), the macros to define on the nvcc line (K2_WARPS, K2_POINTS_PER_WARP,
K2_ROWS in the port's source), and, with +no_rows, the source with its row
gathers and sums taken out (`add_rows` never called: what the rest of the
kernel costs; its output is wrong and is not checked). Each is built with
the port's nvcc flags, launched on chip_smoke.py's K2 inputs (batch 64,
1024 points, 32x32 pixels, 277 channels, 8 flat-background elements) and
on its all-selected case, checked against the plain version (one bfloat16
ulp) and timed on the device with torch.profiler in mirrored order (A, B,
B, A per round). Prints each build's ptxas registers and spills, one line
per timing, the card's name and power limit, then one JSON object as its
last line. Needs a CUDA device and nvcc.
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


def start_build(spec: str, index: int):
    """Start nvcc on one SPEC; returns (its library's path, the process,
    whether its rows are taken out)."""
    from keypointfusion_torch.kernels import build as kb
    source, _, rest = spec.partition(':')
    no_rows = spec.endswith('+no_rows')
    source = Path(source.removesuffix('+no_rows'))
    defines = [f'-D{d}' for d in rest.removesuffix('+no_rows').split(',')
               if d]
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f'k2-variant-{index}-{os.getpid()}'
    if no_rows:
        text = source.read_text()
        if 'add_rows<kPer>(' not in text:
            raise ValueError(f'{source} has no add_rows call to take out')
        copy = kb.BUILD_DIR / f'{stem}.cu'
        copy.write_text(text.replace('add_rows<kPer>(',
                                     'if (false) add_rows<kPer>('))
        source = copy
    lib = kb.BUILD_DIR / f'{stem}.so'
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, *defines, '-I', str(kb.CSRC_DIR),
           '-o', str(lib), str(source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True), no_rows


def main():
    import torch

    import chip_smoke
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.kernels import pixel_sampler as k2

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('specs', nargs='+')
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    kernel = k2.SERVING_KERNEL

    fns, report = {}, {}
    builds = [start_build(spec, i) for i, spec in enumerate(args.specs)]
    for spec, (lib, proc, no_rows) in zip(args.specs, builds):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {spec}:\n{log}')
        usage = [ln.strip() for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln]
        fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        fns[spec] = fn
        report[spec] = {'ptxas': usage, 'checked': not no_rows,
                        'device_ms': []}
        try:
            info = k2.serving_kernel_info(1024, 277, lib)
            report[spec]['points_per_block_smem_blocks_per_sm'] = info[:3]
        except AttributeError:       # a source without the info entry
            info = None
        print(f'[build] {spec} info={json.dumps(info)} '
              f'ptxas={json.dumps(usage)}', flush=True)

    dev = torch.device('cuda', 0)
    batch = synthetic_batch(batch_size=chip_smoke.BATCH, point_num=1024,
                            seed=1)
    pcl, img_xyz, feat = chip_smoke.sampler_inputs(dev, batch)
    feat = feat.to(torch.bfloat16)
    e = chip_smoke.TIE_ELEMENTS
    img3 = img_xyz[:e, :3].repeat(1, img_xyz.shape[1] // 3 + 1, 1)
    cases = {'smoke': (pcl, img_xyz, feat),
             'all_selected': (pcl[:e].contiguous(),
                              img3[:, :img_xyz.shape[1]].contiguous(),
                              feat[:e].contiguous())}
    want = {name: k2.sample_pixel_features_plain(*a, mode='default')
            for name, a in cases.items()}

    def run(spec, case='smoke'):
        kernel._fn = fns[spec]    # the wrapper launches it
        return k2.sample_pixel_features_fused(*cases[case], mode='default')

    ok = True
    for spec in fns:
        for case in cases:
            got = run(spec, case)
            ulps = float(((got.float() - want[case].float()).abs()
                          / chip_smoke.bf16_ulp(want[case])).max())
            report[spec][f'{case}_ulps'] = ulps
            ok &= ulps <= 1 or not report[spec]['checked']
            print(f'[check] {spec} {case} ulps={ulps} '
                  f'checked={report[spec]["checked"]}', flush=True)
    order = list(fns) + list(fns)[::-1]
    for rnd in range(args.rounds):
        for spec in order:
            ms = chip_smoke.device_ms(lambda: run(spec), 20,
                                      'pixel_sampler_serving_kernel')
            report[spec]['device_ms'].append(ms)
            print(f'[time] round={rnd} {spec} device_ms={ms:.5f}',
                  flush=True)
    kernel._fn = None
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({'variants': report, 'card': card}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
