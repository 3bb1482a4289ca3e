"""The other dense codecs of the reference's feature family and the
feature-type dispatch of the pixel stage (port of
keypointfusion_tpu/ops/codecs_extra.py).

`joint_to_feature` encodes ground-truth joints as Config.feature_type asks
and `feature_to_joint` decodes a predicted dense map by its first type:
'weight_offset' (the default, ops/codecs.py), 'weight_offset_nosoftmax',
'offset' and 'heatmap' decode; 'heatmap_depth', 'heatmap_depthoffset',
'plainoffset_depth', 'plainoffset_depthoffset' and 'weight_pos' only
encode, and their decode raises NotImplementedError where the JAX
function's does. All maps are NHWC.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from keypointfusion_torch.geometry.grid import uv_grid
from keypointfusion_torch.geometry.pcl import topk_largest
from keypointfusion_torch.ops.codecs import (
    _kernel_arr, _pixel_coords, joint_to_heatmap, joint_to_offset,
    offset_to_joint_softmax, offset_to_joint_weight,
)
from keypointfusion_torch.ops.resize import resize_nearest_torch


def offset_to_joint_topk(offset_map, depth, kernel_size, topk: int = 30):
    """The 'offset' decode by top-k heatmap voting: a 4J map [B,H,W,4J] ->
    joints [B,J,3], each the heatmap-weighted mean of its `topk` strongest
    pixels' votes. Among equal heatmap values the lower pixel index goes
    first, as lax.top_k takes them."""
    b, h, w, c = offset_map.shape
    j = c // 4
    _, coords = _pixel_coords(depth, h)                     # [B,HW,3]
    offset_unit = offset_map[..., :3 * j].reshape(b, h * w, j, 3)
    heatmap = offset_map[..., 3 * j:].reshape(b, h * w, j)

    value, idx = topk_largest(heatmap.transpose(1, 2), topk)  # [B,J,K]
    off_sel = torch.gather(offset_unit.transpose(1, 2), 2,
                           idx[..., None].expand(b, j, topk, 3))
    coords_sel = torch.gather(coords[:, None].expand(b, j, h * w, 3), 2,
                              idx[..., None].expand(b, j, topk, 3))
    k = _kernel_arr(kernel_size, j, offset_map.device)[..., None]
    dist = k - value * k
    joint = torch.sum((off_sel * dist[..., None] + coords_sel)
                      * value[..., None], dim=2)
    return joint / (torch.sum(value, -1, keepdim=True) + 1e-8)


def offset_to_joint_weight_nosoftmax(offset_map, depth, kernel_size):
    """The 'weight_offset_nosoftmax' decode: a 5J map -> joints [B,J,3]
    weighted by the raw masked weight channel over its sum. The sum is not
    guarded: where it is <= 0 (possible at random init) the joint is
    inf or NaN, as in the JAX function."""
    b, h, w, c = offset_map.shape
    j = c // 5
    depth_ds, coords = _pixel_coords(depth, h)
    coords = coords[:, :, None, :]                          # [B,HW,1,3]
    offset_unit = offset_map[..., :3 * j].reshape(b, h * w, j, 3)
    heatmap = offset_map[..., 3 * j:4 * j].reshape(b, h * w, j)
    weight = offset_map[..., 4 * j:].reshape(b, h * w, j)
    mask = (depth_ds.reshape(b, h * w, 1) < 0.99).to(offset_map.dtype)
    offset_m = offset_unit * mask[..., None]
    heat_m = heatmap * mask
    weight_m = weight * mask
    k = _kernel_arr(kernel_size, j, offset_map.device)[:, None, :]
    dist = k - heat_m * k
    num = torch.sum((offset_m * dist[..., None] + coords)
                    * weight_m[..., None], dim=1)
    return num / (torch.sum(weight_m, 1)[..., None] + 0.0)


def heatmap_to_joint_softmax(heatmap, scale: float = 30.0):
    """2D decode of heatmaps [B,H,W,J]: the softmax of the scaled map over
    the pixels times their normalized uv -> [B,J,2]."""
    b, h, w, j = heatmap.shape
    grid = uv_grid(h, heatmap.device).reshape(h * w, 2)
    nh = torch.softmax(heatmap.reshape(b, h * w, j) * scale, dim=1)
    return torch.einsum('bmj,mc->bjc', nh, grid)


def joint_to_plain_offset(joint, depth, kernel_size, feature_size):
    """2D unit-offset + heatmap encoding on the reference's mesh with an
    (fs - 1) denominator (not uv_grid's pixel centres). Returns
    ([B,fs,fs,3J]: 2J uv offsets joint-major then J heatmaps, mask
    [B,fs,fs,J])."""
    b, j, _ = joint.shape
    fs = int(feature_size)
    depth_ds = resize_nearest_torch(depth, fs)
    r = 2.0 * torch.arange(fs, dtype=torch.float32,
                           device=joint.device) / (fs - 1.0) - 1.0
    grid = torch.stack([r[None, :].expand(fs, fs), r[:, None].expand(fs, fs)],
                       dim=-1)
    offset = joint[:, None, None, :, :2] - grid[None, :, :, None, :]
    dist = torch.sqrt(torch.sum(offset ** 2, dim=-1) + 1e-8)
    offset_norm = offset / dist[..., None]
    k = _kernel_arr(kernel_size, j, joint.device)[:, None, None, :]
    heatmap = (k - dist) / k
    mask = (heatmap >= 0).float() * (depth_ds < 0.99).float()
    out = torch.cat(
        [(offset_norm * mask[..., None]).reshape(b, fs, fs, 2 * j),
         heatmap * mask], dim=-1)
    return out, mask


def joint_to_depth_offset(joint, depth, mask, feature_size):
    """Per-joint depth offsets from the resized depth, masked:
    [B,fs,fs,J]."""
    depth_ds = resize_nearest_torch(depth, int(feature_size))
    return (joint[:, None, None, :, 2] - depth_ds) * mask


def joint_to_gaussian_heatmap(joint, depth, std, heatmap_size):
    """Gaussian heatmaps at sigma 1/sqrt(2) and their validity mask
    (>= 0.01 on the foreground), both [B,S,S,J]. sigma is the float32
    value JAX computes, so 2 sigma^2 rounds as there."""
    sigma = 1.0 / torch.sqrt(torch.tensor(2.0))
    hm = joint_to_heatmap(joint[..., :2], std, heatmap_size, sigma=sigma)
    depth_ds = resize_nearest_torch(depth, heatmap_size)
    mask = (hm >= 0.01).float() * (depth_ds < 0.99).float()
    return hm, mask


def plain_offset_to_joint_softmax(offset, weight, kernel_size,
                                  scale: float = 30.0):
    """2D decode of uv offsets [B,H,W,2J] and weights [B,H,W,J] through a
    softmax of the scaled weights over the pixels -> [B,J,2]."""
    b, h, w, c = offset.shape
    j = c // 2
    grid = uv_grid(h, offset.device).reshape(h * w, 2)
    off = offset.reshape(b, h * w, j, 2)
    wgt = weight.reshape(b, h * w, j)
    k = _kernel_arr(kernel_size, j, offset.device)[:, None, :]
    dist = k - wgt * k
    nw = torch.softmax(scale * wgt, dim=1)
    return torch.sum((off * dist[..., None] + grid[None, :, None, :])
                     * nw[..., None], dim=1)


def depth_to_map(depth_nl, heatmap_size: int = 32):
    """Per-joint depths [B,J] in [-1, 1] as constant maps [B,S,S,J] in
    [0, 1]."""
    b, j = depth_nl.shape
    m = ((depth_nl + 1.0) / 2.0)[:, None, None, :]
    return m.expand(b, heatmap_size, heatmap_size, j)


def joint_to_pc(joint, generator: Optional[torch.Generator] = None,
                sample_point: int = 1024, radius: float = 0.08,
                cloud_per_joint: int = 100):
    """Joints [B,J,3] -> a typed synthetic cloud [B,sample_point,4]: xyz
    and the 1-based joint type. Each joint gets `cloud_per_joint` points
    at a uniform radius in [0, radius) and uniform angles in [0, pi); one
    selection of `sample_point` of the J * cloud_per_joint points, without
    replacement, serves every batch element. The draws come from
    `generator` (on the joints' device), where JAX draws from a key."""
    b, j, _ = joint.shape
    n = cloud_per_joint
    dev = joint.device
    draw = lambda: torch.rand((b, j, n), generator=generator, device=dev)
    r = draw() * radius
    theta = draw() * math.pi
    phi = draw() * math.pi
    x = r * torch.sin(phi) * torch.cos(theta)
    y = r * torch.sin(phi) * torch.sin(theta)
    z = r * torch.cos(phi)
    pts = joint[:, :, None, :] + torch.stack([x, y, z], dim=-1)
    types = torch.arange(1, j + 1, dtype=torch.float32, device=dev)
    types = types[None, :, None, None].expand(b, j, n, 1)
    cloud = torch.cat([pts, types.to(pts.dtype)], dim=-1).reshape(b, j * n, 4)
    sel = torch.randperm(j * n, generator=generator, device=dev)
    return cloud[:, sel[:sample_point], :]


# ------------------------------------------------ feature-type dispatch ---

def joint_to_feature(joint, depth, feature_paras, feature_size,
                     feature_types):
    """GT encoding: per (para, type) pair the dense map of that type,
    concatenated on the channels."""
    feats = []
    for para, ftype in zip(feature_paras, feature_types):
        if ftype == 'heatmap':
            hm, _ = joint_to_gaussian_heatmap(joint, depth, para,
                                              feature_size)
            feats.append(hm)
        elif ftype == 'heatmap_depth':
            hm, mask = joint_to_gaussian_heatmap(joint, depth, para,
                                                 feature_size)
            d = joint[:, None, None, :, 2].expand(hm.shape)
            feats.append(torch.cat(
                [hm, torch.where(mask > 0, d, torch.full_like(d, -1.0))],
                dim=-1))
        elif ftype == 'heatmap_depthoffset':
            hm, mask = joint_to_gaussian_heatmap(joint, depth, para,
                                                 feature_size)
            feats.append(torch.cat(
                [hm, joint_to_depth_offset(joint, depth, mask,
                                           feature_size)], dim=-1))
        elif ftype == 'plainoffset_depth':
            po, _ = joint_to_plain_offset(joint, depth, para, feature_size)
            d = joint[:, None, None, :, 2].expand(
                joint.shape[0], feature_size, feature_size, joint.shape[1])
            feats.append(torch.cat([po, d], dim=-1))
        elif ftype == 'plainoffset_depthoffset':
            po, mask = joint_to_plain_offset(joint, depth, para,
                                             feature_size)
            feats.append(torch.cat(
                [po, joint_to_depth_offset(joint, depth, mask,
                                           feature_size)], dim=-1))
        elif ftype in ('offset', 'weight_offset',
                       'weight_offset_nosoftmax'):
            feats.append(joint_to_offset(joint, depth, para, feature_size))
        elif ftype == 'weight_pos':
            b, j, _ = joint.shape
            f = joint[:, None, None].expand(b, feature_size, feature_size,
                                            j, 3)
            feats.append(f.reshape(b, feature_size, feature_size, 3 * j))
        else:
            raise NotImplementedError(ftype)
    return torch.cat(feats, dim=-1)


def feature_to_joint(depth, pixel_pd, feature_types, feature_paras,
                     joint_num=None):
    """Prediction decode by the first feature type -> joints [B,J,3]
    (normalized uvd; 'heatmap' gives d = 0). joint_num slices the map to
    the channels the decode reads: the backbone emits 5J, 'offset' reads
    4J and 'heatmap' J."""
    ftype = feature_types[0]
    para = feature_paras[0]
    j = joint_num
    if ftype == 'weight_offset':
        return offset_to_joint_weight(pixel_pd, depth, para)
    if ftype == 'weight_offset_nosoftmax':
        return offset_to_joint_weight_nosoftmax(pixel_pd, depth, para)
    if ftype == 'offset':
        if j is not None:
            pixel_pd = pixel_pd[..., :4 * j]
        return offset_to_joint_softmax(pixel_pd, depth, para)
    if ftype == 'heatmap':
        if j is not None:
            pixel_pd = pixel_pd[..., :j]
        uv = heatmap_to_joint_softmax(pixel_pd)
        return torch.cat([uv, uv.new_zeros(uv.shape[:2] + (1,))], dim=-1)
    raise NotImplementedError(ftype)
