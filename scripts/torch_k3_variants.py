#!/usr/bin/env python3
"""Time builds of K3 (the grouped DESA MLP + max-pool) side by side, on
the card.

    python3 scripts/torch_k3_variants.py SPEC [SPEC ...] [--rounds 2]
        [--sass]

Each SPEC is SOURCE[:NAME=VALUE,...][+no_products][+no_rows]
[+split_per_fragment]: a CUDA file that exports kpf_grouped_mlp_pool with
the port's signature (keypointfusion_torch/csrc/grouped_mlp_pool.cu, or
another version of it), the macros to define on the nvcc line, and
switches that take a part out: +no_products (-DK3_NO_PRODUCTS: no
mma.sync and no B loads), +no_rows (-DK3_NO_ROWS: no row gathers), both
giving a wrong output that is not checked, and +split_per_fragment
(-DK3_SPLIT_PER_FRAGMENT: every warp splits each B fragment as it loads
it, the control; checked). An earlier source that does not read these
macros (the one-thread-per-channel kernel of commit b36fb9e, with its
desa_common.cuh beside it) has its tile products or its row loads taken
out of its text instead. Each SOURCE's own directory comes first on the
include path, then keypointfusion_torch/csrc/.

Every build runs chip_smoke.py's three K3 launches (desa_inputs at batch
64: 1,344 groups of 64 slots per radius, seeded weights) through the
port's wrapper: checked against the plain version at chip_smoke.K3_TOL
and compared bit for bit with the first SPEC's output, then timed on the
device with torch.profiler in mirrored order (A, B, B, A per round): each
launch profiled on its own (kernel_ms of scripts/torch_k2_variants.py),
the mean over the three. Prints each build's ptxas registers and spills and its launch
shape (when it exports kpf_grouped_mlp_pool_info), with --sass its most
frequent SASS opcodes and its instructions other than HMMA per HMMA
(static counts, from cuobjdump), one line per timing, the card's name and
power limit, then one JSON object as its last line. Needs a CUDA device
and nvcc.
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

from torch_k1_variants import sass_opcodes  # noqa: E402
from torch_k2_variants import kernel_ms  # noqa: E402

SWITCHES = {'+no_products': 'K3_NO_PRODUCTS', '+no_rows': 'K3_NO_ROWS',
            '+split_per_fragment': 'K3_SPLIT_PER_FRAGMENT'}
UNCHECKED = ('+no_products', '+no_rows')


def parse(spec: str):
    """(source, macros to define, switches) of a SPEC."""
    switches = []
    while True:
        for s in SWITCHES:
            if spec.endswith(s):
                switches.insert(0, s)
                spec = spec[:-len(s)]
                break
        else:
            break
    source, _, rest = spec.partition(':')
    return Path(source), [d for d in rest.split(',') if d], switches


def without_parts(text: str, switches):
    """(source text, macros) of a build without the parts `switches` name:
    the macro where the source reads it, else the earlier kernel's tile
    products or row loads taken out of its text."""
    macros = []
    for s in switches:
        macro = SWITCHES[s]
        if macro in text:
            macros.append(macro)
        elif s == '+no_products' and 'desa::tile_dense(' in text:
            text = text.replace('desa::tile_dense(',
                                'if (false) desa::tile_dense(')
        elif s == '+no_rows' and 'feat_g[' in text:
            text = re.sub(r'feat_g\[[^\]]*\]',
                          'static_cast<float>(t + c)', text)
        else:
            raise ValueError(f'the source has no way to take {s} out')
    return text, macros


def start_build(spec: str, index: int):
    """Start nvcc on one SPEC; returns (its library's path, the process,
    whether its output is checked)."""
    from keypointfusion_torch.kernels import build as kb
    source, defines, switches = parse(spec)
    text, macros = without_parts(source.read_text(), switches)
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f'k3-variant-{index}-{os.getpid()}'
    if text != source.read_text():
        copy = kb.BUILD_DIR / f'{stem}.cu'
        copy.write_text(text)
    else:
        copy = source
    lib = kb.BUILD_DIR / f'{stem}.so'
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS,
           *(f'-D{d}' for d in defines + macros),
           '-I', str(source.resolve().parent), '-I', str(kb.CSRC_DIR),
           '-o', str(lib), str(copy)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, proc, not any(s in UNCHECKED for s in switches)


def hmma_ratio(ops):
    """Instructions other than HMMA per HMMA, from [[opcode, count], ...]
    of every opcode."""
    counts = dict(ops)
    hmma = counts.get('HMMA', 0)
    total = sum(counts.values())
    return round((total - hmma) / hmma, 3) if hmma else None


def main():
    import torch

    import chip_smoke
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.kernels import grouped_mlp_pool as k3

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('specs', nargs='+')
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--sass', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = k3.KERNEL

    fns, report = {}, {}
    builds = [start_build(spec, i) for i, spec in enumerate(args.specs)]
    for spec, (lib, proc, checked) in zip(args.specs, builds):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {spec}:\n{log}')
        usage = [ln.strip() for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln]
        fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        fns[spec] = fn
        report[spec] = {'ptxas': usage, 'checked': checked, 'device_ms': []}
        try:
            info = k3.kernel_info(lib)
            report[spec]['groups_per_block_smem_blocks_per_sm_threads'] = info
        except AttributeError:       # a source without the info entry
            info = None
        if args.sass:
            ops = sass_opcodes(lib, top=1000)
            report[spec]['sass_top'] = ops[:16]
            report[spec]['other_per_hmma'] = hmma_ratio(ops)
        print(f'[build] {spec} info={json.dumps(info)} '
              f'ptxas={json.dumps(usage)} '
              f'sass_top={json.dumps(report[spec].get("sass_top"))} '
              f'other_per_hmma={report[spec].get("other_per_hmma")}',
              flush=True)

    dev = torch.device('cuda', 0)
    batch = synthetic_batch(batch_size=chip_smoke.BATCH, point_num=1024,
                            seed=1)
    inputs, module = chip_smoke.desa_inputs(dev, batch)
    calls = chip_smoke.k3_calls(module, inputs)
    want = [k3.grouped_mlp_pool_plain(*a) for a in calls]

    def run(spec, only=None):
        kernel._fn = fns[spec]    # the wrapper launches it
        return [k3.grouped_mlp_pool(*a) for i, a in enumerate(calls)
                if only in (None, i)]

    ok, first = True, None
    for spec in fns:
        got = run(spec)
        first = got if first is None else first
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, f) for g, f in zip(got, first))
        report[spec].update(max_abs_err=err, same_bits_as_first=same)
        ok &= err <= chip_smoke.K3_TOL or not report[spec]['checked']
        print(f'[check] {spec} max_abs_err={err} tol={chip_smoke.K3_TOL} '
              f'checked={report[spec]["checked"]} same_bits_as_first={same}',
              flush=True)
    order = list(fns) + list(fns)[::-1]
    for rnd in range(args.rounds):
        for spec in order:
            per_call = [kernel_ms(lambda: run(spec, i), 20,
                                  kernel.name + '_kernel')
                        for i in range(len(calls))]
            ms = sum(m for m, _ in per_call) / len(calls)
            taken = [n for _, n in per_call]
            report[spec]['device_ms'].append(ms)
            print(f'[time] round={rnd} {spec} device_ms={ms:.5f} '
                  f'profiles={taken}', flush=True)
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
