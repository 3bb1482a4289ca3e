"""Losses (port of keypointfusion_tpu/ops/loss.py)."""

import torch


def smooth_l1_loss(x, y, size_average: bool = True):
    """Smooth-L1 with a 0.01 knee: 0.5*z^2 inside, 0.01*(|z|-0.005)
    outside, in float32; the mean over the last axis, then the mean (or
    the sum) over the rest."""
    z = (x - y).float()
    az = z.abs()
    per_elem = torch.where(az < 0.01, 0.5 * z * z, 0.01 * (az - 0.005))
    per_row = per_elem.mean(dim=-1)
    return per_row.mean() if size_average else per_row.sum()
