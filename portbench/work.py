"""The yardstick's arithmetic: the card's peaks, the least work of each
kernel for its inputs, and the model's FLOPs.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity) at its full 700 W. Work counts the arithmetic of the function,
not of one implementation: each input byte read once, each output byte
written once, each product once (K1 'highest''s three TF32 passes are an
implementation's choice and are not counted three times), and where the
work depends on the data, what these inputs need. A kernel's bound is the
largest of its byte time, its product time over the TF32 peak and its
remaining float32 time over the CUDA cores' peak: an implementation may
overlap those, so their sum would not be a bound. No float32-accurate
implementation computes faster than the TF32 tensor rate, so no share
below can honestly pass 100%.
"""

from __future__ import annotations

from typing import Sequence

import torch

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
F32 = 4


def bound_s(nbytes: float, tf32_flops: float = 0.0,
            fp32_flops: float = 0.0) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, tf32_flops / TF32_FLOP_PER_S,
               fp32_flops / FP32_FLOP_PER_S)


def k1_work(pcl_xyz: torch.Tensor, node_xyz: torch.Tensor, c: int,
            radius: Sequence[float], samples: Sequence[int]):
    """(bytes, products' FLOPs, other float32 FLOPs) of one K1 call (DESA
    over the support set = the cloud then the joints) for these points,
    as `chip_smoke.py` counts them: the first layer's feature product once
    per (element, support point) that some group holds, the second layer
    once per valid group slot, the fusion once per joint; the coordinate
    term, the distances and the joints' own first-layer term on the CUDA
    cores."""
    b, n, _ = pcl_xyz.shape
    j = node_xyz.shape[1]
    m = n + j
    sup = torch.cat([pcl_xyz, node_xyz], 1).float()
    node = node_xyz.float()
    d2 = ((node[:, :, None] - sup[:, None]) ** 2).sum(-1)      # [B,J,M]
    slots = points = 0
    for r, s in zip(radius, samples):
        in_ball = d2 < r * r
        rank = torch.cumsum(in_ball.long(), -1) - in_ball.long()
        held = in_ball & (rank < s)
        empty = ~in_ball.any(-1)
        closest = torch.nn.functional.one_hot(d2.argmin(-1), m).bool()
        held = held | (empty[..., None] & closest)
        slots += int(held.sum())
        points += int(held.any(1).sum())
    fusion = b * j * 2 * (len(radius) + 1) * c * c
    products = (points + slots) * 2 * c * c + fusion
    rest = points * 2 * 3 * c + b * j * m * 9 + b * j * len(radius) * 2 * c * c
    weights = len(radius) * (2 * c * c + 3 * c + 2 * c) \
        + (len(radius) + 1) * c * c + c
    nbytes = F32 * (b * n * c + b * j * c + b * n * 3 + b * j * 3 + weights
                    + b * j * c)
    return nbytes, products, rest


def k2_work(b: int, n: int, hw: int, c: int):
    """(bytes, float32 FLOPs) of one K2 call: one distance pass over every
    (point, pixel) pair (d2 and its clamp), then the weighted sum of 4
    rows."""
    nbytes = F32 * (b * n * 3 + b * hw * 3 + b * hw * c + b * n * c)
    return nbytes, b * n * hw * 9 + b * n * c * 7


def model_flops(kpfusion, config: dict, size: int = 128,
                points: int = 1024) -> float:
    """FLOPs of one frame's forward through the configuration's plain
    reference `kpfusion` (torch.utils.flop_counter: products and
    convolutions, 2 per multiply-add), counted on meta tensors, so
    nothing runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from portbench.reference import geometry as G
    with torch.device('meta'):
        model = kpfusion(config['net'], config['joint_num']).eval()
        fr = G.Frame.make(torch.empty(1, 4), torch.empty(1, 3),
                          torch.empty(1, 3, 3), torch.empty(1, 3), size)
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model(torch.empty(1, size, size, 3), torch.empty(1, size, size, 1),
                  torch.empty(1, points, 3), fr)
    return float(counter.get_total_flops())
