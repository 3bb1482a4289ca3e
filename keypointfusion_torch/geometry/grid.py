"""Pixel-coordinate grids (port of keypointfusion_tpu/geometry/grid.py).

The reference builds its coordinate mesh as
    coord_u = 2*(col + 0.5)/S - 1,   coord_v = 2*(row + 0.5)/S - 1
with channel order (u, v).
"""

import numpy as np
import torch

from keypointfusion_torch.utils.device import device_constant


def _uv_grid_host(size: int) -> torch.Tensor:
    r = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u = np.broadcast_to(r[None, :], (size, size))
    v = np.broadcast_to(r[:, None], (size, size))
    return torch.from_numpy(np.stack([u, v], axis=-1))


def uv_grid(size: int, device=None) -> torch.Tensor:
    """[S, S, 2] grid of normalized (u, v) pixel-center coordinates,
    computed in float32 exactly as the JAX package computes it. One
    tensor per (size, device), shared by every caller: read it, never
    write into it."""
    return device_constant(('uv_grid', int(size)), device,
                           lambda d: _uv_grid_host(int(size)).to(d))


def img_uvd_points(depth: torch.Tensor) -> torch.Tensor:
    """Depth map [B,H,W,1] -> per-pixel normalized uvd points [B,H*W,3]."""
    b, h, w, _ = depth.shape
    if h != w:
        raise ValueError(f'square crops only, got {h}x{w}')
    grid = uv_grid(h, depth.device).expand(b, h, w, 2)
    return torch.cat([grid, depth], dim=-1).reshape(b, h * w, 3)
