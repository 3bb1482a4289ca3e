#!/usr/bin/env python3
"""How close K1 'default' comes to its contract, on the card.

    python3 scripts/torch_k1_serving_check.py [--batch 64]

K1 'default' rounds h1 and the fusion input to bfloat16, so any change in
the order of its float32 sums flips some of those roundings, and each flip
moves an output by up to a bfloat16 ulp times a weight. This script takes
chip_smoke.py's K1 inputs (batch 64, seeded weights) and holds the kernel
(csrc/desa_dense_serving.cu) and its plain version
(cuBLAS, TF32 off) against a third evaluation of the same contract whose
sums are taken in float64 and rounded once to float32, at the same
bfloat16 rounding points: if the kernel is as far from it as the plain
version is, their difference is the flips and not a fault. Then it takes
the kernel's device time apart through its inputs: the same call with the
groups capped at 64 (the model's), 32, 16 and 1 slots, so the time that does not shrink with the rows (selection, weight
staging, the fusion, barriers) shows apart from the tensor-core work.
Prints each distance (max and the count of outputs off by more than
1e-4), each time, the card's name and power limit, then one JSON object
as its last line. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def float64_sums(pcl_feat, node_feat, pcl_xyz, node_xyz, w, radius,
                 num_samples):
    """kernels/desa_dense.py:_desa_serving_plain with every product summed
    in float64 and rounded once to float32, the joint term too."""
    import torch

    import chip_smoke
    from keypointfusion_torch.kernels import desa_dense as k1
    from keypointfusion_torch.ops.ball_query import ball_query_slots
    from keypointfusion_torch.ops.pairwise import pairwise_sqdist

    bf = k1._bf16
    mm = lambda a, b: (a.double() @ b.double()).float()
    sup_xyz = torch.cat([pcl_xyz, node_xyz], 1)
    sup_feat = torch.cat([bf(pcl_feat), bf(node_feat)], 1)
    d2 = pairwise_sqdist(node_xyz, sup_xyz)
    b_j = chip_smoke.joint_term_float64(node_feat, node_xyz, w, radius).float()
    rows = torch.arange(d2.shape[0], device=d2.device)[:, None, None]
    outs = []
    for i, (r, s) in enumerate(zip(radius, num_samples)):
        idx, valid = ball_query_slots(d2, r, s)
        a = mm(sup_feat, bf(w.wf[i])) + mm(sup_xyz, w.wl[i]) * (1.0 / r)
        h1 = torch.relu(a[rows, idx] - b_j[:, :, i, None, :])
        h2 = torch.relu(mm(bf(h1), bf(w.w2[i])) + w.b2[i])
        h2 = torch.where(valid[..., None], h2,
                         torch.full_like(h2, -float('inf')))
        outs.append(h2.amax(dim=2))
    fused = bf(torch.cat(outs + [bf(node_feat)], -1))
    return torch.relu(mm(fused, bf(w.wfu)) + w.bfu)


def main():
    import numpy as np
    import torch

    import chip_smoke
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.kernels import desa_dense as k1

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch', type=int, default=64)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.BATCH = args.batch
    dev = torch.device('cuda', 0)
    batch = synthetic_batch(batch_size=args.batch, point_num=1024, seed=1)
    (pcl_feat, node_feat, pcl_xyz, node_xyz), module = \
        chip_smoke.desa_inputs(dev, batch)
    pcl_feat, node_feat = pcl_feat.bfloat16(), node_feat.bfloat16()
    inputs = (pcl_feat, node_feat, pcl_xyz, node_xyz)
    with torch.no_grad():
        w = module.folded_weights()
    radius, samples = module.radius, module.num_samples
    ref = float64_sums(*inputs, w, radius, samples)
    pack = k1.serving_weights(w)
    results = {'plain': k1.desa_dense_plain(*inputs, w, radius, samples,
                                            'default'),
               'kernel': k1.desa_dense_serving(*inputs, pack, radius,
                                               samples)}
    torch.cuda.synchronize()

    def distance(a, b):
        d = (a - b).abs()
        return {'max': float(d.max()), 'over_1e-4': int((d > 1e-4).sum())}

    report = {'batch': args.batch, 'outputs': ref.numel(),
              'scale': float(ref.abs().max()),
              'to_float64_sums': {k: distance(v, ref)
                                  for k, v in results.items()},
              'kernel_to_plain': distance(results['kernel'],
                                          results['plain'])}
    for k, v in report['to_float64_sums'].items():
        print(f'{k} to float64 sums: {v}', flush=True)

    report['device_ms_by_group_cap'] = {}
    for cap in (64, 32, 16, 1):
        ms = chip_smoke.device_ms(
            lambda: k1.desa_dense_serving(*inputs, pack, radius, (cap,) * 3),
            20, 'desa_dense_serving_kernel')
        report['device_ms_by_group_cap'][cap] = ms
        print(f'groups capped at {cap} slots: {ms:.5f} ms', flush=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    report['card'] = card
    print(card)
    print(json.dumps(report))
    return 0 if np.isfinite(report['scale']) else 1


if __name__ == '__main__':
    sys.exit(main())
