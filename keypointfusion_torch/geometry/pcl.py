"""Point-cloud <-> image correspondence ops (port of
keypointfusion_tpu/geometry/pcl.py).

The JAX package densifies the top-k pixel weights into a [B,N,HW] matrix
because the TPU has no fast gather; here the sampling is a gather-sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from keypointfusion_torch.geometry.camera import (
    CropFrame, inv3x3, points_img_to_3d, transform_points_2d,
    uvd_nl_to_xyz_nl,
)
from keypointfusion_torch.geometry.grid import img_uvd_points
from keypointfusion_torch.ops.pairwise import pairwise_sqdist


def topk_smallest(d2: torch.Tensor, k: int):
    """The k smallest entries along the last axis in ascending order, the
    lower index first among equal values (lax.top_k's order; torch.topk
    does not promise one). Returns (values, int64 indices)."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_largest(x: torch.Tensor, k: int):
    """The k largest entries along the last axis in descending order, the
    lower index first among equal values, as lax.top_k orders them.
    Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def inverse_distance_weights(dist: torch.Tensor) -> torch.Tensor:
    """1/(d2 + 1e-8), divided by its sum + 1e-8; the sum runs over the k
    slots left to right, as the CUDA sampler adds them."""
    closeness = 1.0 / (dist + 1e-8)
    total = closeness[..., 0]
    for i in range(1, closeness.shape[-1]):
        total = total + closeness[..., i]
    return closeness / (total[..., None] + 1e-8)


def img_to_pcl_index(pcl, depth, frame: CropFrame, select_num: int = 9):
    """For each cloud point, the `select_num` nearest image pixels (in
    normalized xyz space) and their inverse-distance weights.

    pcl [B,N,3] normalized xyz; depth [B,H,W,1] normalized crop depth.
    Returns (closeness [B,N,K] float32, index [B,N,K] int64 flat pixel
    ids)."""
    img_xyz = uvd_nl_to_xyz_nl(img_uvd_points(depth), frame)
    dist, idx = topk_smallest(pairwise_sqdist(pcl, img_xyz), select_num)
    return inverse_distance_weights(dist), idx


def sample_pixel_features(flat_feat, closeness, index):
    """Weighted gather-sum: flat_feat [B,HW,C], closeness/index [B,N,K]
    -> [B,N,C] float32, summed over the k slots left to right."""
    b = flat_feat.shape[0]
    flat = flat_feat.float()
    rows = torch.arange(b, device=flat.device)[:, None]
    out = closeness[..., 0, None] * flat[rows, index[..., 0]]
    for i in range(1, index.shape[-1]):
        out = out + closeness[..., i, None] * flat[rows, index[..., i]]
    return out


def img_to_anchor_dis(joint_uvd, depth, frame: CropFrame,
                      gamma: float = 10.0):
    """Geometry adjacency map: per-joint closeness 1/(gamma*d2 + 1) of
    every pixel to the joint in normalized xyz space.

    joint_uvd [B,J,3] (normalized uvd; the reference feeds refined xyz
    through this uvd path and the caller keeps that quirk);
    depth [B,H,W,1]. Returns [B,H,W,J]."""
    b, h, w, _ = depth.shape
    joint_xyz = uvd_nl_to_xyz_nl(joint_uvd, frame)
    img_xyz = uvd_nl_to_xyz_nl(img_uvd_points(depth), frame)
    closeness = 1.0 / (gamma * pairwise_sqdist(joint_xyz, img_xyz) + 1.0)
    return closeness.reshape(b, -1, h, w).permute(0, 2, 3, 1)


def depth_to_pcl_fixed(depth, frame: CropFrame, num_points: int = 1024,
                       generator: Optional[torch.Generator] = None,
                       uniform: Optional[torch.Tensor] = None):
    """Masked depth -> point cloud with fixed-size resampling.

    Back-projects every valid pixel (normalized depth < 0.99) and draws
    `num_points` of them uniformly with replacement. The draws are
    `uniform` [B,num_points] in [0,1) when given (tests inject the JAX
    package's draws), else taken from `generator`.

    depth [B,H,W,1] normalized crop depth. Returns pcl [B,num_points,3]
    normalized xyz (zeros where a sample has no valid pixel)."""
    b, h, w, _ = depth.shape
    dev = depth.device
    flat = depth.reshape(b, h * w)
    valid = flat < 0.99

    d_mm = flat * frame.cube[:, 2:3] / 2.0 + frame.center[:, 2:3]
    cols = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    rows = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    u = cols[None, :].expand(h, w).reshape(-1)
    v = rows[:, None].expand(h, w).reshape(-1)
    uv = torch.stack([u, v], -1)[None].expand(b, h * w, 2)
    uvd = torch.cat([uv, d_mm[..., None]], dim=-1)
    uvd_orig = transform_points_2d(uvd, inv3x3(frame.M))
    xyz = points_img_to_3d(uvd_orig, frame.fx, frame.fy, frame.fu,
                           frame.fv, frame.flip)
    xyz_nl = (xyz - frame.center[:, None, :]) / (frame.cube[:, None, :]
                                                 / 2.0)

    # valid pixel positions compacted to the front by one sort, then
    # uniform ordinals into the valid prefix
    hw = h * w
    positions = torch.arange(hw, device=dev)[None, :]
    compacted, _ = torch.sort(torch.where(valid, positions, hw + positions),
                              dim=-1)
    total = valid.sum(-1, keepdim=True)
    if uniform is None:
        uniform = torch.rand((b, num_points), generator=generator,
                             device=dev)
    targets = torch.minimum((uniform * total.float()).long(),
                            torch.clamp_min(total - 1, 0))
    idx = torch.gather(compacted, 1, targets)
    idx = torch.where(idx >= hw, torch.zeros_like(idx), idx)
    pcl = torch.gather(xyz_nl, 1, idx[..., None].expand(b, num_points, 3))
    any_valid = valid.any(-1)[:, None, None]
    return torch.where(any_valid, pcl, torch.zeros_like(pcl))
