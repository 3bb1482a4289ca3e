"""Ball-query selection for DESA (port of the eval-path pieces of
keypointfusion_tpu/ops/ball_query.py).

The contract, from the CUDA pointnet2 ball query the reference uses: a
group holds the first S in-ball support points in storage order; when no
point lies in the ball the closest point (lowest index among equals)
stands in. `ball_query_slots` gives the group's valid slots (K1's masked
max); `ball_query_group` the full gather form, whose fill slots repeat
slot 0 as the CUDA kernel pads (K3's input).
"""

import torch

from keypointfusion_torch.ops.pairwise import pairwise_sqdist


def exclusive_rank(in_ball: torch.Tensor) -> torch.Tensor:
    """rank[..., m] = number of True in in_ball[..., :m] (int64)."""
    ib = in_ball.long()
    return torch.cumsum(ib, dim=-1) - ib


def ball_query_slots(d2: torch.Tensor, radius: float, num_samples: int):
    """Group selection for one radius from squared distances d2 [B,J,M].

    Returns (idx [B,J,S] int64 support indices, valid [B,J,S] bool). The
    valid slots are the first S in-ball points in storage order, or slot 0
    alone holding the closest point when the ball is empty."""
    m = d2.shape[-1]
    in_ball = d2 < radius * radius
    sel = in_ball & (exclusive_rank(in_ball) < num_samples)
    arange = torch.arange(m, device=d2.device)
    key = torch.where(sel, arange, m + arange)
    idx = torch.sort(key, dim=-1)[0][..., :num_samples]
    valid = idx < m
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    empty = ~valid[..., 0]
    # torch.argmin returns the first minimal index
    closest = torch.argmin(d2, dim=-1)
    idx[..., 0] = torch.where(empty, closest, idx[..., 0])
    valid[..., 0] = True
    return idx, valid


def ball_query_group(support_xyz, query_xyz, radius: float,
                     num_samples: int, d2=None):
    """Group up to S = num_samples in-ball support points per query point.

    support_xyz [B,M,3], query_xyz [B,J,3], optional d2 [B,J,M] (squared
    distances, ops/pairwise.py). Returns (idx [B,J,S] int64, valid [B,J,S]
    bool, rel_xyz [B,J,S,3] = grouped xyz - query). Slots past the ball's
    count repeat slot 0; an empty ball puts the closest point in every
    slot (valid only in slot 0)."""
    if d2 is None:
        d2 = pairwise_sqdist(query_xyz, support_xyz)
    m = d2.shape[-1]
    in_ball = d2 < radius * radius
    arange = torch.arange(m, device=d2.device)
    key = torch.where(in_ball, arange, m + arange)
    idx = torch.sort(key, dim=-1)[0][..., :num_samples] % m
    valid = torch.gather(in_ball, -1, idx)
    empty = ~valid.any(-1)
    idx[..., 0] = torch.where(empty, torch.argmin(d2, dim=-1), idx[..., 0])
    valid[..., 0] = True
    idx = torch.where(valid, idx, idx[..., :1])
    rel_xyz = group_features(support_xyz, idx) - query_xyz[:, :, None, :]
    return idx, valid, rel_xyz


def group_features(features, idx):
    """features [B,M,C], idx [B,J,S] -> [B,J,S,C]."""
    rows = torch.arange(features.shape[0], device=features.device)
    return features[rows[:, None, None], idx]
