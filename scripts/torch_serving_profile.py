#!/usr/bin/env python3
"""Where a serving batch of the PyTorch port spends its time, on the card.

    python3 scripts/torch_serving_profile.py [--batch 64] [--requests 4]
        [--dtype bfloat16|float32]

Drives keypointfusion_torch's StreamingEngine as chip_smoke.py does
(KPFusion-resnet-18 in the engine's compute dtype, bfloat16 by default,
random weights from a seed, bench.py-style 480x640 frames) and reports:
  * the stages of one warm request on the host clock, each ended by a
    synchronize: host staging and copies, device preprocessing, the two
    backbones, sampling and codecs, fusion block 1, fusion block 2, packing;
  * under torch.profiler, over `--requests` requests through
    process_stream: the wall time, the device's busy time (the sum of its
    kernel and copy times; the engine runs on one stream, so they do not
    overlap), the idle share, and device time by kind and by kernel.
Prints the card's name and power limit, then one JSON object as its last
line. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KINDS = (('K1 desa_dense', ('desa_dense_kernel',)),
         ('K1 desa_dense_serving', ('desa_dense_serving_kernel',)),
         ('K2 pixel_sampler', ('pixel_sampler_kernel',)),
         ('K2 pixel_sampler_serving', ('pixel_sampler_serving_kernel',)),
         ('convolution', ('conv', 'cudnn', 'xmma', 'implicit', 'winograd')),
         ('matmul', ('gemm', 'cutlass', 'cublas')),
         ('copy', ('memcpy', 'memset')),
         ('sort', ('sort', 'radix')))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return 'elementwise and other'


def stage_times(eng, frames):
    """Host-clock stages of one request, each ended by a synchronize."""
    import torch
    marks = []

    def mark(label):
        def hook(*_):
            torch.cuda.synchronize()
            marks.append((label, time.perf_counter()))
        return hook

    m = eng.model
    handles = [m.backbone_d.register_forward_pre_hook(mark('preprocess')),
               m.backbone_rgb.register_forward_hook(mark('backbones')),
               m.block1.register_forward_pre_hook(mark('sampling+codecs')),
               m.block1.register_forward_hook(mark('block1')),
               m.block2.register_forward_hook(mark('block2'))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth = eng._to_device(frames['depth'].view(np.int16)).int() & 0xFFFF
    staged = [eng._to_device(frames[k]) for k in
              ('rgb', 'centers', 'cube', 'cam')]
    torch.cuda.synchronize()
    marks.append(('staging+copies', time.perf_counter()))
    eng.pipeline(depth, *staged)
    torch.cuda.synchronize()
    marks.append(('packing', time.perf_counter()))
    for h in handles:
        h.remove()
    out, last = {}, t0
    for label, t in marks:
        out[label] = round((t - last) * 1e3, 3)
        last = t
    out['total'] = round((last - t0) * 1e3, 3)
    return out


def main():
    import torch
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_frames
    from keypointfusion_torch.serving import StreamingEngine

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch', type=int, default=64)
    parser.add_argument('--requests', type=int, default=4)
    parser.add_argument('--dtype', choices=('bfloat16', 'float32'),
                        default='bfloat16')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    eng = StreamingEngine(Config(), batch_size=args.batch,
                          img_hw=(480, 640), dtype=getattr(torch, args.dtype),
                          seed=0)
    rng = np.random.RandomState(0)
    requests = [synthetic_frames(args.batch, rng=rng)
                for _ in range(args.requests + 1)]
    list(eng.process_stream(iter(requests[:1])))          # warm-up
    stages = [stage_times(eng, requests[0]) for _ in range(3)]

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        list(eng.process_stream(iter(requests[1:])))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    kinds = {}
    for e in device:
        k = kind_of(e.key)
        kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    frames = args.requests * args.batch
    result = {
        'card': card, 'dtype': args.dtype, 'batch': args.batch,
        'requests': args.requests,
        'stages_ms_per_request': stages,
        'profiled_wall_ms': round(wall_ms, 3),
        'frames_per_s_profiled': round(frames / wall_ms * 1e3, 1),
        'device_busy_ms': round(busy_ms, 3) if device else 'not measured',
        'device_idle_share': round(1 - busy_ms / wall_ms, 4)
        if device else 'not measured',
        'device_ms_by_kind': {k: round(v, 3) for k, v in sorted(
            kinds.items(), key=lambda kv: -kv[1])},
        'top_kernels': [{'name': e.key[:90], 'calls': e.count,
                         'ms': round(e.self_device_time_total / 1e3, 3)}
                        for e in top],
    }
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
