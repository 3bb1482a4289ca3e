"""Plain preprocessing of full RGB-D frames into the model's inputs, for
the benchmark's reference: the KPFusion reference's centred letterbox crop
with cv2 INTER_NEAREST source pixels, the cube's z-threshold and
normalization, and a fixed-size point cloud drawn from the hand's pixels.
Imports nothing of the program under test."""

from __future__ import annotations

import torch

from portbench.reference.geometry import Frame, affine2d, img_to_3d, inv3x3


def _bounds(center, cube, cam):
    fx, fy = cam[:, 0], cam[:, 1]
    cu, cv, cz = center[:, 0], center[:, 1], center[:, 2]
    xs = torch.floor((cu * cz / fx - cube[:, 0] / 2.) / cz * fx + 0.5)
    xe = torch.floor((cu * cz / fx + cube[:, 0] / 2.) / cz * fx + 0.5)
    ys = torch.floor((cv * cz / fy - cube[:, 1] / 2.) / cz * fy + 0.5)
    ye = torch.floor((cv * cz / fy + cube[:, 1] / 2.) / cz * fy + 0.5)
    return xs, xe, ys, ye, cz - cube[:, 2] / 2.0, cz + cube[:, 2] / 2.0


def _src_index(size: int, sz, pad, start, extent):
    o = torch.arange(size, dtype=torch.float32, device=sz.device)[None]
    rel = o - pad[:, None]
    inside = (rel >= 0) & (rel < sz[:, None])
    src = torch.floor(rel * (extent[:, None] / sz[:, None])) + start[:, None]
    return torch.where(inside, src, torch.full_like(src, -1.0)).long()


def crop(depth_full, rgb_full, center, cube, cam, size: int = 128):
    """depth_full [B,H,W] mm, rgb_full [B,H,W,3], center [B,3] (u, v, z
    mm), cube [B,3], cam [B,4], float32 -> (depth [B,S,S,1] in [-1, 1],
    rgb [B,S,S,3] 0..255, Frame)."""
    b, h0, w0 = depth_full.shape
    xs, xe, ys, ye, zs, ze = _bounds(center, cube, cam)
    wb, hb = xe - xs, ye - ys
    wide = wb > hb
    full = torch.full_like(wb, float(size))
    sz_x = torch.where(wide, full, torch.floor(wb * size / hb))
    sz_y = torch.where(wide, torch.floor(hb * size / wb), full)
    pad_x = torch.floor(size / 2.0 - sz_x / 2.0)
    pad_y = torch.floor(size / 2.0 - sz_y / 2.0)
    scale = torch.where(hb > wb, sz_y / hb, sz_x / wb)
    M = torch.zeros((b, 3, 3), device=depth_full.device)
    M[:, 0, 0] = scale
    M[:, 1, 1] = scale
    M[:, 2, 2] = 1.0
    M[:, 0, 2] = pad_x - scale * xs
    M[:, 1, 2] = pad_y - scale * ys
    sx = _src_index(size, sz_x, pad_x, xs, xe - xs)
    sy = _src_index(size, sz_y, pad_y, ys, ye - ys)
    valid = ((sy >= 0) & (sy < h0))[:, :, None] \
        & ((sx >= 0) & (sx < w0))[:, None, :]
    cy = sy.clamp(0, h0 - 1)[:, :, None]
    cx = sx.clamp(0, w0 - 1)[:, None, :]
    rows = torch.arange(b, device=depth_full.device)[:, None, None]
    zero = torch.zeros((), device=depth_full.device)
    d = torch.where(valid, depth_full[rows, cy, cx], zero)
    rgb = torch.where(valid[..., None], rgb_full[rows, cy, cx], zero)
    zs, ze = zs[:, None, None], ze[:, None, None]
    d = torch.where((d < zs) & (d != 0), zs, d)
    d = torch.where((d > ze) & (d != 0), torch.zeros_like(d), d)
    premax = torch.amax(d, dim=(1, 2), keepdim=True)
    cz = center[:, 2][:, None, None]
    half = cube[:, 2][:, None, None] / 2.0
    d = torch.where((d == premax) | (d == 0), (cz + half).expand_as(d), d)
    d = torch.minimum(torch.maximum(d, cz - half), cz + half)
    fr = Frame.make(cam, center, M, cube, size)
    fr.center = img_to_3d(center[:, None], fr)[:, 0]
    return ((d - cz) / half)[..., None], rgb, fr


def point_cloud(depth, fr: Frame, uniform):
    """Back-projects the hand's pixels (normalized depth < 0.99) and takes
    pixel floor(u * count) of them in storage order for each draw u of
    `uniform` [B,N] in [0, 1); zeros where a crop has no such pixel.
    Returns normalized xyz [B,N,3] clamped to [-1, 1]."""
    b, h, w, _ = depth.shape
    dev = depth.device
    flat = depth.reshape(b, h * w)
    valid = flat < 0.99
    d_mm = flat * fr.cube[:, 2:3] / 2.0 + fr.center[:, 2:3]
    c = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    r = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    uv = torch.stack([c[None, :].expand(h, w).reshape(-1),
                      r[:, None].expand(h, w).reshape(-1)], -1)
    uvd = torch.cat([uv[None].expand(b, h * w, 2), d_mm[..., None]], -1)
    xyz = img_to_3d(affine2d(uvd, inv3x3(fr.M)), fr)
    xyz = (xyz - fr.center[:, None]) / (fr.cube[:, None] / 2.0)
    pos = torch.arange(h * w, device=dev)[None]
    order = torch.sort(torch.where(valid, pos, h * w + pos), -1)[0]
    count = valid.sum(-1, keepdim=True)
    pick = torch.minimum((uniform * count.float()).long(),
                         torch.clamp_min(count - 1, 0))
    idx = torch.gather(order, 1, pick)
    idx = torch.where(idx >= h * w, torch.zeros_like(idx), idx)
    pcl = torch.gather(xyz, 1, idx[..., None].expand(*idx.shape, 3))
    pcl = torch.where(valid.any(-1)[:, None, None], pcl,
                      torch.zeros_like(pcl))
    return pcl.clamp(-1.0, 1.0)


def preprocess(depth_full, rgb_full, center, cube, cam, uniform,
               size: int = 128):
    """Full frames -> (rgb [B,S,S,3] in [0, 1], depth, pcl, Frame)."""
    depth, rgb, fr = crop(depth_full.float(), rgb_full.float(),
                          center.float(), cube.float(), cam.float(), size)
    return (rgb * (1.0 / 255.0), depth, point_cloud(depth, fr, uniform),
            fr)
