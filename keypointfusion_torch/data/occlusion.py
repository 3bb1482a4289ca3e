"""Occlusion and visibility utilities of the demo preprocessing (port of
keypointfusion_tpu/data/occlusion.py; the reference's
dataloader/processing_depth.py:1097-1131), on the caller's device.

mask_image keeps the JAX module's static shape: always `num_masks`
spheres around joints drawn with replacement (the reference draws 3..10
without). Its draws come from a torch.Generator; mask_image_from_draws
is its deterministic core, so the JAX module's jax.random draws can be
handed to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from keypointfusion_torch.geometry.grid import uv_grid
from keypointfusion_torch.utils.device import resolve_device


def joint_visibility(pcl: torch.Tensor, joint: torch.Tensor, joint_kernel,
                     min_support: int = 10) -> torch.Tensor:
    """A joint is visible when more than min_support cloud points fall
    inside its kernel radius (processing_depth.py:1097-1104).

    pcl [B,N,3], joint [B,J,3], joint_kernel a number or [J] -> bool
    [B,J]."""
    offset = joint[:, :, None, :] - pcl[:, None, :, :]
    dis = torch.sqrt(torch.sum(offset ** 2, -1) + 1e-8)
    k = torch.as_tensor(joint_kernel, dtype=torch.float32,
                        device=joint.device).expand(joint.shape[1])
    k = k[None, :, None]
    heatmap = (k - dis) / k
    return torch.sum(heatmap > 0, dim=-1) > min_support


def offset_map_visibility(offset_map: torch.Tensor, joint_num: int = 21,
                          min_support: int = 10) -> torch.Tensor:
    """Visibility from a dense 5J map's heatmap channels
    (processing_depth.py:1106-1109). offset_map [B,H,W,5J] NHWC."""
    heat = offset_map[..., joint_num * 3:joint_num * 4]
    return torch.sum(heat > 0, dim=(1, 2)) > min_support


def mask_image_draws(batch: int, joint_num: int, num_masks: int = 6,
                     generator: Optional[torch.Generator] = None,
                     device=None):
    """mask_image's three draws: joint ids [B,M] uniform in [0, J), the
    centres' jitter [B,M,3] and the radii's fractions [B,M], both
    uniform in [0, 1), on `device` (utils/device.py:resolve_device; the
    generator's device)."""
    device = resolve_device(device)
    joint_id = torch.randint(0, joint_num, (batch, num_masks),
                             generator=generator, device=device)
    jitter = torch.rand((batch, num_masks, 3), generator=generator,
                        device=device)
    radius = torch.rand((batch, num_masks), generator=generator,
                        device=device)
    return joint_id, jitter, radius


def mask_image_from_draws(depth: torch.Tensor, joint_uvd: torch.Tensor,
                          joint_id: torch.Tensor, jitter: torch.Tensor,
                          radius: torch.Tensor, mask_offset: float = 0.2,
                          mask_para: float = 0.3) -> torch.Tensor:
    """mask_image given its draws (mask_image_draws): every pixel whose
    (u, v, depth) lies inside one of the spheres is set to 1."""
    b, h, w, _ = depth.shape
    centers = torch.gather(joint_uvd, 1,
                           joint_id[..., None].expand(-1, -1, 3))
    centers = centers + (jitter - 0.5) * mask_offset * 2
    radius = radius * mask_para
    grid = uv_grid(h, depth.device).reshape(1, h * w, 2)
    mesh = torch.cat([grid.expand(b, h * w, 2), depth.reshape(b, h * w, 1)],
                     dim=-1)
    dis = torch.sqrt(torch.sum(
        (mesh[:, None, :, :] - centers[:, :, None, :]) ** 2, -1))
    hit = torch.sum(dis < radius[..., None], dim=1) > 0       # [B,HW]
    return torch.where(hit.reshape(b, h, w, 1), torch.ones_like(depth),
                       depth)


def mask_image(depth: torch.Tensor, joint_uvd: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               mask_offset: float = 0.2, mask_para: float = 0.3,
               num_masks: int = 6) -> torch.Tensor:
    """Random spherical occlusion: depth pixels near jittered joint
    locations set to 1 (processing_depth.py:1111-1131). depth [B,H,W,1]
    normalized crop, joint_uvd [B,J,3]; the draws come from `generator`
    on depth's device."""
    draws = mask_image_draws(depth.shape[0], joint_uvd.shape[1], num_masks,
                             generator, depth.device)
    return mask_image_from_draws(depth, joint_uvd, *draws,
                                 mask_offset=mask_offset,
                                 mask_para=mask_para)
