"""Dense-map <-> joint codecs of the serving and training paths (port of
keypointfusion_tpu/ops/codecs.py). Dense maps are NHWC; the 5J channel
order is [3J offsets (ch = j*3 + axis), J heatmap, J weight]."""

from __future__ import annotations

import numbers

import torch

from keypointfusion_torch.geometry.grid import uv_grid
from keypointfusion_torch.ops.resize import resize_nearest_torch
from keypointfusion_torch.utils.device import device_constant


def _kernel_row(kernel_size, joint_num, device=None):
    k = torch.as_tensor(kernel_size, dtype=torch.float32, device=device)
    if k.ndim == 0:
        k = k.expand(joint_num)
    return k[None, :]


def _kernel_key(kernel_size):
    """A float, or a tuple of floats for a per-joint list; None for a
    tensor or a value of another shape."""
    if isinstance(kernel_size, torch.Tensor):
        return None
    if isinstance(kernel_size, numbers.Real):
        return float(kernel_size)
    try:
        return tuple(float(v) for v in kernel_size)
    except (TypeError, ValueError):
        return None


def _kernel_arr(kernel_size, joint_num, device=None):
    """Scalar or per-joint [J] kernel -> [1, J] float32: for a number or
    a list of numbers one tensor per (value, J, device), shared by every
    caller (read it, never write into it); a tensor is converted on every
    call."""
    key = _kernel_key(kernel_size)
    if key is None:
        return _kernel_row(kernel_size, joint_num, device)
    return device_constant(('kernel_row', key, int(joint_num)), device,
                           lambda d: _kernel_row(key, joint_num, d))


def _pixel_coords(depth, size: int):
    """The nearest-resized depth [B,S,S,1] and the pixels' normalized uvd
    [B,S*S,3]."""
    b = depth.shape[0]
    depth_ds = resize_nearest_torch(depth, size)
    grid = uv_grid(size, depth.device).expand(b, size, size, 2)
    return depth_ds, torch.cat([grid, depth_ds], dim=-1).reshape(
        b, size * size, 3)


def joint_to_offset(joint, depth, kernel_size, feature_size):
    """Encode joints [B,J,3] (normalized uvd) to dense unit-offset +
    heatmap maps [B,fs,fs,4J] over the depth crop [B,H,W,1], with 1e-8
    inside the sqrt; pixels outside the kernel or on the background are
    0."""
    b, j, _ = joint.shape
    fs = int(feature_size)
    depth_ds, coords = _pixel_coords(depth, fs)
    offset = joint[:, None, None, :, :] \
        - coords.reshape(b, fs, fs, 1, 3)                   # [B,fs,fs,J,3]
    dist = torch.sqrt(torch.sum(offset ** 2, dim=-1) + 1e-8)
    offset_norm = offset / dist[..., None]
    k = _kernel_arr(kernel_size, j, joint.device)[:, None, None, :]
    heatmap = (k - dist) / k
    mask = (heatmap >= 0).float() * (depth_ds < 0.99).float()
    offset_norm = (offset_norm * mask[..., None]).reshape(b, fs, fs, j * 3)
    return torch.cat([offset_norm, heatmap * mask], dim=-1)


def offset_to_joint_weight(offset_map, depth, kernel_size):
    """Decode a predicted 5J map [B,H,W,5J] to joints [B,J,3] via softmax
    weights over the pixels; background pixels get weight -1e8."""
    b, h, w, c = offset_map.shape
    j = c // 5
    depth_ds, coords = _pixel_coords(depth, h)

    offset_unit = offset_map[..., :3 * j].reshape(b, h * w, j, 3)
    heatmap = offset_map[..., 3 * j:4 * j].reshape(b, h * w, j)
    weight = offset_map[..., 4 * j:].reshape(b, h * w, j)

    depth_flat = depth_ds.reshape(b, h * w, 1)
    mask = (depth_flat < 0.99).to(offset_map.dtype)
    heatmap_masked = heatmap * mask
    weight_masked = torch.where(depth_flat > 0.99,
                                torch.full_like(weight, -1e8), weight)
    normal_weight = torch.softmax(weight_masked, dim=1)

    k = _kernel_arr(kernel_size, j, offset_map.device)[:, None, :]
    dist = k - heatmap_masked * k
    wd = (normal_weight * dist * mask)[..., None]
    t_off = torch.sum(wd * offset_unit, dim=1)
    # JAX promotes a bfloat16 map's weights to the float32 coordinates
    t_coord = torch.einsum('bmj,bmc->bjc', normal_weight.to(coords.dtype),
                           coords)
    return t_off + t_coord


def offset_to_joint_softmax(offset_map, depth, kernel_size, scale=30.0):
    """Decode a 4J map [B,H,W,4J] (no weight channel) to joints [B,J,3]
    through a softmax of the scaled, masked heatmap over the pixels."""
    b, h, w, c = offset_map.shape
    j = c // 4
    depth_ds, coords = _pixel_coords(depth, h)
    offset_unit = offset_map[..., :3 * j].reshape(b, h * w, j, 3)
    heatmap = offset_map[..., 3 * j:].reshape(b, h * w, j)
    mask = (depth_ds.reshape(b, h * w, 1) < 0.99).to(offset_map.dtype)
    heatmap_masked = heatmap * mask
    normal_heatmap = torch.softmax(heatmap_masked * scale, dim=1)
    k = _kernel_arr(kernel_size, j, offset_map.device)[:, None, :]
    dist = k - heatmap_masked * k
    wd = (normal_heatmap * dist * mask)[..., None]
    t_off = torch.sum(wd * offset_unit, dim=1)
    t_coord = torch.einsum('bmj,bmc->bjc', normal_heatmap, coords)
    return t_off + t_coord


def joint_to_heatmap(joint_uv, std, heatmap_size, sigma=1.5):
    """Gaussian heatmaps [B,S,S,J] from normalized uv [B,J,2]."""
    s = int(heatmap_size)
    px = torch.arange(s, dtype=torch.float32, device=joint_uv.device) + 0.5
    mesh_x = px[None, :].expand(s, s)
    mesh_y = px[:, None].expand(s, s)
    jx = (joint_uv[..., 0] + 1.0) / 2.0 * s
    jy = (joint_uv[..., 1] + 1.0) / 2.0 * s
    dx = (mesh_x[None, :, :, None] - jx[:, None, None, :]) / std
    dy = (mesh_y[None, :, :, None] - jy[:, None, None, :]) / std
    return torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma ** 2))


def pcl_joint_to_offset(joint, pcl, kernel_size):
    """Encode joints [B,J,3] against a cloud [B,N,3] -> [B,N,4J]
    (3J unit offsets joint-major + J closeness). No epsilon inside the
    sqrt; 1e-8 on the division."""
    b, j, _ = joint.shape
    n = pcl.shape[1]
    offset = joint[:, :, None, :] - pcl[:, None, :, :]        # [B,J,N,3]
    dis = torch.sqrt(torch.sum(offset ** 2, dim=-1))
    offset_norm = offset / (dis[..., None] + 1e-8)
    k = _kernel_arr(kernel_size, j, joint.device)[..., None]  # [1,J,1]
    closeness = (k - dis) / k
    mask = (closeness >= 0).float() * (pcl[:, None, :, 2] < 0.99).float()
    closeness = closeness * mask
    offset_norm = offset_norm * mask[..., None]
    off_flat = offset_norm.permute(0, 2, 1, 3).reshape(b, n, j * 3)
    return torch.cat([off_flat, closeness.permute(0, 2, 1)], dim=-1)


def pcl_offset_to_joint_weight(pcl_result, pcl, kernel_size):
    """Decode per-point 5J predictions [B,N,5J] on a cloud [B,N,3] to
    joints [B,J,3] through softmax weights over the points; points on the
    background (z > 0.99) get weight -1e8."""
    b, n, c = pcl_result.shape
    j = c // 5
    offset = pcl_result[..., :3 * j].reshape(b, n, j, 3)
    heatmap = pcl_result[..., 3 * j:4 * j]
    weight = pcl_result[..., 4 * j:]
    weight_masked = torch.where(pcl[..., 2:] > 0.99,
                                torch.full_like(weight, -1e8), weight)
    normal_weight = torch.softmax(weight_masked, dim=1)
    k = _kernel_arr(kernel_size, j, pcl_result.device)[:, None, :]
    dist = k - heatmap * k
    contrib = (offset * dist[..., None] + pcl[:, :, None, :]) \
        * normal_weight[..., None]
    return torch.sum(contrib, dim=1)
