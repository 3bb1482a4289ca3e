"""Point sampling and orientation utilities (port of
keypointfusion_tpu/geometry/sampling.py).

`calculate_com`, `farthest_point_sample` and `pca_orient` are the JAX
package's numpy host functions, copied. `farthest_point_sample_torch` is
the batched FPS on tensors, and the two correspondence functions run on
tensors through ops/pairwise.py's distances; their top-k takes the lower
index first among equal distances, as lax.top_k does (pixel grids give
exact ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from keypointfusion_torch.geometry.camera import (
    CropFrame, uvd_nl_to_xyz_nl, xyz_nl_to_uvd_nl,
)
from keypointfusion_torch.geometry.grid import img_uvd_points
from keypointfusion_torch.geometry.pcl import topk_smallest
from keypointfusion_torch.ops.pairwise import pairwise_sqdist


def calculate_com(depth: np.ndarray, min_depth: float, max_depth: float
                  ) -> np.ndarray:
    """Depth-image center of mass (u, v, mean depth) within a depth band;
    (300, 300, 500) when the band is empty."""
    dc = depth.copy()
    dc[(dc < min_depth) | (dc > max_depth)] = 0
    num = np.count_nonzero(dc)
    if num == 0:
        return np.array((300., 300., 500.))
    ys, xs = np.nonzero(dc > 0)
    return np.array([xs.mean(), ys.mean(), dc.sum() / num])


def farthest_point_sample(xyz: np.ndarray, npoint: int,
                          rng: Optional[np.random.RandomState] = None
                          ) -> np.ndarray:
    """Host FPS of xyz [N,3] -> sorted unique indices, as the reference's
    loader returns them; fewer points than npoint are padded by random
    picks from `rng` (np.random when None)."""
    rng = rng or np.random
    n = xyz.shape[0]
    if n < npoint:
        extra = rng.choice(np.arange(n), size=npoint - n, replace=False) \
            if npoint - n <= n else rng.choice(np.arange(n),
                                               size=npoint - n)
        return np.unique(np.append(np.arange(n), extra))
    centroids = np.zeros(npoint, np.int64)
    distance = np.full(n, 1e10)
    farthest = rng.randint(0, npoint)
    for i in range(npoint):
        centroids[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, -1)
        distance = np.minimum(distance, d)
        farthest = int(distance.argmax())
    return np.unique(centroids)


def farthest_point_steps(xyz: torch.Tensor, start: torch.Tensor,
                         npoint: int) -> torch.Tensor:
    """Batched FPS from given start indices: xyz [B,N,3], start [B] ->
    idx [B,npoint] (duplicates kept; argmax takes the first maximum, as
    jnp.argmax does)."""
    b, n, _ = xyz.shape
    distance = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    farthest = start.long()
    picked = []
    for _ in range(npoint):
        picked.append(farthest)
        centroid = torch.gather(xyz, 1, farthest[:, None, None].expand(
            b, 1, 3))
        d = torch.sum((xyz - centroid) ** 2, -1)
        distance = torch.minimum(distance, d)
        farthest = torch.argmax(distance, -1)
    return torch.stack(picked, dim=1)


def farthest_point_sample_torch(xyz: torch.Tensor, npoint: int,
                                generator: Optional[torch.Generator] = None
                                ) -> torch.Tensor:
    """Batched FPS on the points' device: xyz [B,N,3] -> idx [B,npoint].
    Each element starts at an index drawn uniformly from `generator` (JAX
    draws it from a key), then runs farthest_point_steps."""
    b, n, _ = xyz.shape
    start = torch.randint(0, n, (b,), generator=generator,
                          device=xyz.device)
    return farthest_point_steps(xyz, start, npoint)


def pca_orient(pcl: np.ndarray, joint: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PCA canonical orientation: the cloud and joints rotated into the
    principal frame, the second axis recomputed as cross(third, first)
    for a right-handed basis. Returns (pcl, joint, coeff)."""
    centered = pcl - pcl.mean(0, keepdims=True)
    u, _, vh = np.linalg.svd(centered, full_matrices=False)
    # sklearn-style deterministic sign (svd_flip): largest-|u| row positive
    signs = np.sign(u[np.abs(u).argmax(axis=0), range(u.shape[1])])
    vh = vh * signs[:, None]
    coeff = vh.T                                   # columns = components
    coeff[:, 1] = np.cross(coeff[:, 2], coeff[:, 0])
    return pcl @ coeff, joint @ coeff, coeff


def img_to_pcl_index_softmax(pcl, depth, frame: CropFrame,
                             select_num: int = 64, scale: float = 30.0):
    """Softmax-weighted nearest pixels of each cloud point in normalized
    xyz: pcl [B,N,3], depth [B,H,W,1] -> (closeness [B,N,K], idx [B,N,K]
    int64)."""
    img_xyz = uvd_nl_to_xyz_nl(img_uvd_points(depth), frame)
    d2, idx = topk_smallest(pairwise_sqdist(pcl, img_xyz), select_num)
    dist = torch.sqrt(d2 + 1e-8)
    dist = dist - torch.amin(dist, -1, keepdim=True)
    closeness = 1.0 - dist / torch.amax(dist, -1, keepdim=True)
    return torch.softmax(closeness * scale, dim=-1), idx


def pcl_to_img_index(pcl, img_size: int, frame: CropFrame,
                     select_num: int = 9):
    """The nearest image pixels of each cloud point in pixel space:
    pcl [B,N,3] -> (inverse-distance weights [B,N,K] over their sum,
    idx [B,N,K] int64 flat pixel ids)."""
    b = pcl.shape[0]
    pcl_uv = (xyz_nl_to_uvd_nl(pcl, frame)[..., :2] + 1) / 2 * img_size
    px = torch.arange(img_size, dtype=torch.float32, device=pcl.device) \
        + 0.5
    u = px[None, :].expand(img_size, img_size).reshape(-1)
    v = px[:, None].expand(img_size, img_size).reshape(-1)
    coords = torch.stack([u, v], -1)[None].expand(b, img_size * img_size, 2)
    d2, idx = topk_smallest(pairwise_sqdist(pcl_uv, coords), select_num)
    dist = torch.sqrt(d2 + 1e-8)
    closeness = 1.0 / (dist + 1e-8)
    return closeness / (torch.sum(closeness, -1, keepdim=True) + 1e-8), idx
