#!/usr/bin/env python3
"""Where a train step of the PyTorch port spends its time, on the card.

    python3 scripts/torch_train_profile.py [--batch 64] [--steps 5]
        [--dtype float32|mixed]

Drives keypointfusion_torch's train step as chip_smoke.py does
(KPFusion-resnet-18 at full width, random weights from a seed, one
synthetic batch of `--batch` crops with 1024 points, AdamW, dropout 0.1
from a CUDA generator; float32 runs with TF32 off) and reports, after 3
warm-up steps:
  * ms per step on the host clock (each step ended by a synchronize) and
    by CUDA events over `--steps` back-to-back steps, and the peak device
    memory;
  * the operations of one step that make the host wait for the card
    (torch.cuda.set_sync_debug_mode), by the line of the port that calls
    them;
  * under torch.profiler, over `--steps` steps: the wall time, the
    device's busy time (the sum of its kernel and copy times; the step runs
    on one stream, so they do not overlap), the idle share, device time by
    kind and by kernel, and the host operations by their own host time.
Prints the card's name and power limit, then one JSON object as its last
line. Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# first match wins: cuDNN's BatchNorm kernels carry 'cudnn' in their names
KINDS = (('batchnorm', ('bn_fw', 'bn_bw', 'batch_norm', 'batchnorm')),
         ('optimizer', ('multi_tensor_apply', 'adam', 'sgd', 'foreach')),
         ('convolution', ('conv', 'cudnn', 'xmma', 'implicit', 'winograd',
                          'dgrad', 'wgrad', 'fprop')),
         ('matmul', ('gemm', 'cutlass', 'cublas')),
         ('copy', ('memcpy', 'memset')),
         ('gather and scatter', ('index', 'scatter', 'gather')),
         ('sort', ('sort', 'radix')),
         ('reduction', ('reduce',)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return 'elementwise and other'


def sync_sites(step_once):
    """{'file:line': count} of the port's lines whose operation made the
    host wait for the card during step_once()."""
    import torch
    sites = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            step_once()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    for w in caught:
        if 'synchroniz' not in str(w.message):
            continue
        sites[f'{os.path.relpath(w.filename)}:{w.lineno}'] += 1
    return dict(sites)


def main():
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch', type=int, default=64)
    parser.add_argument('--steps', type=int, default=5)
    parser.add_argument('--dtype', choices=('float32', 'mixed'),
                        default='float32')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)

    cfg = Config(compute_dtype=args.dtype)
    batch = batch_to_device(synthetic_batch(batch_size=args.batch,
                                            point_num=1024, seed=2), dev)
    state = create_train_state(cfg, batch, device=dev, seed=0)
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for _ in range(3):
        step(state, batch, gen, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    host = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(state, batch, gen, 0)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step(state, batch, gen, 0)
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / args.steps
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    syncs = sync_sites(lambda: step(state, batch, gen, 0))
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, metrics = step(state, batch, gen, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user annotations (the optimizer's 'Optimizer.step#AdamW.step') span
    # kernels already counted
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)
              and not e.key.startswith('Optimizer.')]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    kinds = {}
    for e in device:
        k = kind_of(e.key)
        kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    host_ops = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:12]

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    n = args.steps
    result = {
        'card': card, 'dtype': args.dtype, 'batch': args.batch,
        'steps': n, 'loss': float(metrics['loss']),
        'host_ms_per_step': [round(x, 3) for x in host],
        'event_ms_per_step': round(event_ms, 3),
        'peak_gib': round(peak_gib, 3),
        'profiled_wall_ms_per_step': round(wall_ms / n, 3),
        'device_busy_ms_per_step': round(busy_ms / n, 3)
        if device else 'not measured',
        'device_idle_share': round(1 - busy_ms / wall_ms, 4)
        if device else 'not measured',
        'device_ms_per_step_by_kind': {k: round(v / n, 3) for k, v in sorted(
            kinds.items(), key=lambda kv: -kv[1])},
        'top_kernels': [{'name': e.key[:90], 'calls_per_step': e.count / n,
                         'ms_per_step': round(
                             e.self_device_time_total / 1e3 / n, 3)}
                        for e in top],
        'host_syncs_in_one_step': syncs,
        'top_host_ops': [{'name': e.key[:60], 'calls_per_step': e.count / n,
                          'self_host_ms_per_step': round(
                              e.self_cpu_time_total / 1e3 / n, 3)}
                         for e in host_ops],
    }
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
