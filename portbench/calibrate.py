#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3
        [--control-seeds 1,2,3] [--units N]

For each seed: the cell's set-up, `--units` requests or steps through the
timed path (no measured window), then the comparison with the plain
reference, as a run makes it (the program's readings). For each control
seed besides: the reference computed with TF32 products and convolutions
put in the program's place (the control, one precision below the
configuration's float32), and for a training cell the reference trained
on half of each batch's rows (a fault) and the reference run again (how
far two runs of the same float32 code lie apart). Prints one JSON line
per seed, then one with the largest program reading and the smallest
control and fault readings of each number. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(bench, workload: str, seed: int, units: int, control: bool,
             device: str = 'cuda', small=None):
    import torch
    from portbench import harness
    cell = harness.Cell(bench, workload)
    torch.backends.cuda.matmul.allow_tf32 = cell.config.get('tf32', False)
    torch.backends.cudnn.allow_tf32 = cell.config.get('tf32', False)
    run = harness.run_class(cell.traffic['kind'])(cell, seed, device,
                                              small or {})
    run.set_up()
    kind = cell.traffic['kind']
    if kind == 'serve':
        run.stream(count=units)
    elif units:
        run.steps(count=units)
    run.free()
    numbers, failed = run.check()
    out = {'seed': seed, 'failed': failed, 'program': numbers}
    if control:
        if kind == 'serve':
            idx = run.sample()
            want = run.reference_answers(idx)
            out['control'] = run.compare(run.reference_answers(idx, True),
                                         want)
        elif kind == 'eval':
            want = run.reference()
            got = run.reference(tf32=True)
            out['control'] = run.compare(
                got, [(s, got[s][0][-1]) for s in got], want)
        else:
            want = run.reference()
            out['control'] = run.compare(run.reference(tf32=True), want)
            out['half_batch'] = run.compare(run.reference(half=True), want)
            out['repeat'] = run.compare(run.reference(), want)
    del run
    if device == 'cuda':
        torch.cuda.empty_cache()
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control-seeds', default='')
    p.add_argument('--units', type=int, default=4)
    args = p.parse_args()
    from portbench import harness
    bench = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
    seeds = [int(s) for s in args.seeds.split(',') if s]
    controls = {int(s) for s in args.control_seeds.split(',') if s}
    rows = []
    for seed in sorted(set(seeds) | controls):
        row = readings(bench, args.workload, seed, args.units,
                       seed in controls)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {'program_max': {}, 'control_min': {}, 'half_batch_min': {},
               'repeat_max': {}}
    for row in rows:
        for key, agg, part in (('program', max, 'program_max'),
                               ('control', min, 'control_min'),
                               ('half_batch', min, 'half_batch_min'),
                               ('repeat', max, 'repeat_max')):
            for name, value in row.get(key, {}).items():
                have = summary[part].get(name)
                summary[part][name] = value if have is None else agg(have,
                                                                     value)
    print(json.dumps({'workload': args.workload, **summary}))


if __name__ == '__main__':
    main()
