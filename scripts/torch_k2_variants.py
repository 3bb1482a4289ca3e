#!/usr/bin/env python3
"""Time builds of K2 (the pixel sampler) side by side, on the card.

    python3 scripts/torch_k2_variants.py [--mode default|highest] SPEC
        [SPEC ...] [--rounds 2]

--mode default (the bfloat16 serving sampler) or highest (the float32
one). Each SPEC is SOURCE[:NAME=VALUE,...][+no_rows]: a CUDA file that
exports the mode's C entry point with the port's signature
(kpf_pixel_sampler_serving in keypointfusion_torch/csrc/
pixel_sampler_serving.cu, kpf_pixel_sampler in csrc/pixel_sampler.cu, or
another version of either), the macros to define on the nvcc line
(K2_WARPS, K2_POINTS_PER_WARP, K2_ROWS in the port's sources), and, with
+no_rows, the source with its row gathers taken out: -DK2_NO_ROWS where
the source reads that macro (csrc/pixel_sampler.cu: each row value
replaced by a number made from its index; the sums and the output stay);
the serving source's `add_rows` never called; the earlier 'highest'
source (one thread per point, commit 47eea2a) with its four `f<r>[ch]`
loads replaced so. Such a
build gives what the rest of the kernel costs; its output is wrong and is
not checked. Each is built with the port's nvcc flags, launched on
chip_smoke.py's K2 inputs (batch 64, 1024 points, 32x32 pixels, 277
channels, 8 flat-background elements) and on its three-position case
(chip_smoke.three_positions: 'default' selects every pixel, 'highest''s 4
nearest all tie), checked against the plain version ('default': one
bfloat16 ulp; 'highest': bit for bit) and timed on the device with
torch.profiler in mirrored order (A, B, B, A per round); a profile that
recorded other than one launch of the kernel per call is taken again (up
to 3 profiles; the profiler can drop events). Prints each
build's ptxas registers and spills and its launch shape, one line per
timing, the card's name and power limit, then one JSON object as its last
line. Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def no_rows_source(text: str):
    """(source text, extra nvcc flags) of a build without its row
    gathers; raises for a source that gives no way to take them out."""
    if 'K2_NO_ROWS' in text:
        return text, ['-DK2_NO_ROWS']
    if 'add_rows<kPer>(' in text:
        return text.replace('add_rows<kPer>(',
                            'if (false) add_rows<kPer>('), []
    loads = re.compile(r'\bf([0-3])\[ch\]')
    if len(loads.findall(text)) == 4:
        return loads.sub(r'static_cast<float>(ch + \1)', text), []
    raise ValueError('the source has no row gathers to take out')


def kernel_ms(fn, iters, name, profiles=3):
    """(device ms per call of fn's one kernel whose name holds `name`, from
    torch.profiler over `iters` calls after a warm-up; the profiles taken).
    A profile that recorded other than `iters` launches of that kernel is
    taken again."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for taken in range(1, profiles + 1):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == cuda and name in e.key]
        if sum(e.count for e in events) == iters:
            total = sum(e.self_device_time_total for e in events)
            return total / iters / 1e3, taken
    raise AssertionError(f'{profiles} profiles did not record {iters} '
                         f'launches of {name!r}')


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
        text, flags = no_rows_source(source.read_text())
        defines += flags
        copy = kb.BUILD_DIR / f'{stem}.cu'
        copy.write_text(text)
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
    parser.add_argument('--mode', choices=('default', 'highest'),
                        default='default')
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    mode = args.mode
    serving = mode == 'default'
    kernel = k2.SERVING_KERNEL if serving else k2.KERNEL

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
            info = k2.kernel_info(mode, 1024, 277, lib)
            report[spec]['points_per_block_smem_blocks_per_sm'] = info[:3]
        except AttributeError:       # a source without the info entry
            info = None
        print(f'[build] {spec} info={json.dumps(info)} '
              f'ptxas={json.dumps(usage)}', flush=True)

    dev = torch.device('cuda', 0)
    batch = synthetic_batch(batch_size=chip_smoke.BATCH, point_num=1024,
                            seed=1)
    pcl, img_xyz, feat = chip_smoke.sampler_inputs(dev, batch)
    if serving:
        feat = feat.to(torch.bfloat16)
    cases = {'smoke': (pcl, img_xyz, feat),
             'three_positions': chip_smoke.three_positions(pcl, img_xyz,
                                                           feat)}
    want = {name: k2.sample_pixel_features_plain(*a, mode=mode)
            for name, a in cases.items()}

    def run(spec, case='smoke'):
        kernel._fn = fns[spec]    # the wrapper launches it
        return k2.sample_pixel_features_fused(*cases[case], mode=mode)

    ok = True
    for spec in fns:
        for case in cases:
            diff = (run(spec, case).float() - want[case].float()).abs()
            if serving:
                err = float((diff / chip_smoke.bf16_ulp(want[case])).max())
                ok &= err <= 1 or not report[spec]['checked']
            else:
                err = float(diff.max())
                ok &= err == 0 or not report[spec]['checked']
            unit = 'ulps' if serving else 'max_abs_err'
            report[spec][f'{case}_{unit}'] = err
            print(f'[check] {spec} {case} {unit}={err} '
                  f'checked={report[spec]["checked"]}', flush=True)
    order = list(fns) + list(fns)[::-1]
    for rnd in range(args.rounds):
        for spec in order:
            ms, taken = kernel_ms(lambda: run(spec), 20,
                                  kernel.name + '_kernel')
            report[spec]['device_ms'].append(ms)
            print(f'[time] round={rnd} {spec} device_ms={ms:.5f} '
                  f'profiles={taken}', flush=True)
    kernel._fn = None
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({'mode': mode, 'variants': report, 'card': card}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
