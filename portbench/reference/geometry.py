"""Plain float32 geometry and codecs of KPFusion, for the benchmark's
reference. Imports nothing of the program under test.

Written from the KPFusion reference's semantics (normalized uvd/xyz crop
frames, the ball query of pointnet2, the 'weight_offset' codec). Where a
comparison decides a discrete choice (ball membership, the 4 nearest
pixels), distances are rounded in one stated order, so that both sides of
a comparison fall the same way on exact ties:
    |a|^2 = (a0*a0 + a1*a1) + a2*a2
    a.b   = fma(a2, b2, fma(a1, b1, a0*b0))
    d2    = max((|a|^2 + |b|^2) - 2*(a.b), 0)
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Frame:
    """Per-sample camera and crop: fx/fy/fu/fv [B], center [B,3] camera mm,
    M [B,3,3] original pixels -> crop pixels, cube [B,3] mm."""
    fx: torch.Tensor
    fy: torch.Tensor
    fu: torch.Tensor
    fv: torch.Tensor
    center: torch.Tensor
    M: torch.Tensor
    cube: torch.Tensor
    img_size: int = 128

    @classmethod
    def make(cls, cam, center, M, cube, img_size=128):
        cam = cam.float()
        return cls(cam[:, 0], cam[:, 1], cam[:, 2], cam[:, 3],
                   center.float(), M.float(), cube.float(), int(img_size))


def inv3x3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a, co_b, co_c = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj / det[..., None, None]


def img_to_3d(uvd, fr: Frame):
    fx, fy, fu, fv = (t[:, None] for t in (fr.fx, fr.fy, fr.fu, fr.fv))
    x = (uvd[..., 0] - fu) * uvd[..., 2] / fx
    y = (uvd[..., 1] - fv) * uvd[..., 2] / fy
    return torch.stack([x, y, uvd[..., 2]], -1)


def affine2d(uvd, M):
    M = M[:, None]
    u, v = uvd[..., 0], uvd[..., 1]
    return torch.stack([M[..., 0, 0] * u + M[..., 0, 1] * v + M[..., 0, 2],
                        M[..., 1, 0] * u + M[..., 1, 1] * v + M[..., 1, 2],
                        uvd[..., 2]], -1)


def uvd_nl_to_xyz_nl(uvd, fr: Frame):
    """Normalized crop uvd -> normalized xyz (centred, over cube/2)."""
    uv = (uvd[..., :2] + 1.0) * (fr.img_size / 2.0)
    d = uvd[..., 2:] * (fr.cube[:, None, 2:] / 2.0) + fr.center[:, None, 2:]
    xyz = img_to_3d(affine2d(torch.cat([uv, d], -1), inv3x3(fr.M)), fr)
    return (xyz - fr.center[:, None]) / (fr.cube[:, None] / 2.0)


def xyz_nl_to_uvd_nl(xyz, fr: Frame):
    center, half = fr.center[:, None], fr.cube[:, None] / 2.0
    p = xyz * half + center
    fx, fy, fu, fv = (t[:, None] for t in (fr.fx, fr.fy, fr.fu, fr.fv))
    uvd = torch.stack([p[..., 0] * fx / (p[..., 2] + 1e-8) + fu,
                       p[..., 1] * fy / p[..., 2] + fv, p[..., 2]], -1)
    uvd = affine2d(uvd, fr.M)
    return torch.cat([uvd[..., :2] / fr.img_size * 2.0 - 1.0,
                      (uvd[..., 2:] - center[..., 2:]) / half[..., 2:]], -1)


def uv_grid(size: int, device):
    r = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
        / size * 2.0 - 1.0
    return torch.stack([r[None, :].expand(size, size),
                        r[:, None].expand(size, size)], -1)


def pixel_uvd(depth):
    """[B,S,S,1] -> [B,S*S,3] normalized uvd of every pixel."""
    b, s = depth.shape[0], depth.shape[1]
    grid = uv_grid(s, depth.device).expand(b, s, s, 2)
    return torch.cat([grid, depth], -1).reshape(b, s * s, 3)


def resize_nearest(x, size: int):
    """NHWC nearest resize, source floor(dst * in / out)."""
    h = x.shape[1]
    if h == size:
        return x
    idx = (torch.arange(size, device=x.device) * h) // size
    return x[:, idx][:, :, idx]


def _fma(x, y, z):
    return (x.double() * y.double() + z.double()).float()


def sqdist(a, b):
    """a [B,N,3], b [B,M,3] -> [B,N,M] in the rounding order above."""
    a, b = a.float(), b.float()
    cross = a[:, :, None, 0] * b[:, None, :, 0]
    for i in (1, 2):
        cross = _fma(a[:, :, None, i], b[:, None, :, i], cross)
    na = a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]
    nb = b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1] + b[..., 2] * b[..., 2]
    return torch.clamp_min((na[:, :, None] + nb[:, None, :]) - 2.0 * cross,
                           0.0)


def gather_rows(feat, idx):
    """feat [B,M,C], idx [B,...] -> [B,...,C]."""
    b = feat.shape[0]
    rows = torch.arange(b, device=feat.device).reshape(
        (b,) + (1,) * (idx.ndim - 1))
    return feat[rows, idx]


def ball_group(d2, radius: float, s: int):
    """pointnet2's ball query from d2 [B,J,M]: the first s support points
    inside the ball in storage order, the closest (lowest index) when the
    ball is empty. Returns (idx [B,J,s], valid [B,J,s]); invalid slots
    repeat slot 0."""
    m = d2.shape[-1]
    in_ball = d2 < radius * radius
    ar = torch.arange(m, device=d2.device)
    idx = torch.sort(torch.where(in_ball, ar, m + ar), -1)[0][..., :s] % m
    valid = torch.gather(in_ball, -1, idx)
    empty = ~valid.any(-1)
    idx[..., 0] = torch.where(empty, torch.argmin(d2, -1), idx[..., 0])
    valid[..., 0] = True
    return torch.where(valid, idx, idx[..., :1]), valid


def sample_pixels(pcl, img_xyz, flat, k: int = 4, rows: int = 64):
    """Each cloud point's k nearest pixels (lowest index first among
    equals), weights 1/(d2 + 1e-8) over their sum + 1e-8, and the
    weighted sum of their feature rows, summed over the slots left to
    right. pcl [B,N,3], img_xyz [B,HW,3], flat [B,HW,C] -> [B,N,C]
    float32; `rows` batch elements at a time, to bound the distances'
    memory."""
    outs = []
    for i in range(0, pcl.shape[0], rows):
        d2 = sqdist(pcl[i:i + rows], img_xyz[i:i + rows])
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        del d2
        dist, idx = vals[..., :k], idx[..., :k]
        close = 1.0 / (dist + 1e-8)
        total = close[..., 0]
        for j in range(1, k):
            total = total + close[..., j]
        close = close / (total[..., None] + 1e-8)
        f = flat[i:i + rows].float()
        out = close[..., 0, None] * gather_rows(f, idx[..., 0])
        for j in range(1, k):
            out = out + close[..., j, None] * gather_rows(f, idx[..., j])
        outs.append(out)
    return torch.cat(outs)


def pixel_coords(depth, size: int):
    b = depth.shape[0]
    ds = resize_nearest(depth, size)
    grid = uv_grid(size, depth.device).expand(b, size, size, 2)
    return ds, torch.cat([grid, ds], -1).reshape(b, size * size, 3)


def joint_to_offset(joint, depth, kernel: float, fs: int):
    """The 'weight_offset' target: [B,fs,fs,4J] unit offsets + heatmap."""
    b, j, _ = joint.shape
    ds, coords = pixel_coords(depth, fs)
    off = joint[:, None, None] - coords.reshape(b, fs, fs, 1, 3)
    dist = torch.sqrt(torch.sum(off ** 2, -1) + 1e-8)
    heat = (kernel - dist) / kernel
    mask = (heat >= 0).float() * (ds < 0.99).float()
    unit = (off / dist[..., None] * mask[..., None]).reshape(b, fs, fs,
                                                             3 * j)
    return torch.cat([unit, heat * mask], -1)


def offset_to_joint(omap, depth, kernel: float):
    """Decode a 5J map [B,H,W,5J] to joints [B,J,3] (normalized uvd):
    softmax of the weight channels over the hand's pixels."""
    b, h, w, c = omap.shape
    j = c // 5
    ds, coords = pixel_coords(depth, h)
    unit = omap[..., :3 * j].reshape(b, h * w, j, 3)
    heat = omap[..., 3 * j:4 * j].reshape(b, h * w, j)
    weight = omap[..., 4 * j:].reshape(b, h * w, j)
    d = ds.reshape(b, h * w, 1)
    mask = (d < 0.99).float()
    heat = heat * mask
    soft = torch.softmax(torch.where(d > 0.99, torch.full_like(weight, -1e8),
                                     weight), 1)
    dist = kernel - heat * kernel
    t_off = torch.sum((soft * dist * mask)[..., None] * unit, 1)
    return t_off + torch.einsum('bmj,bmc->bjc', soft, coords)


def joint_heatmap(joint_uv, std: float, s: int, sigma: float):
    px = torch.arange(s, dtype=torch.float32, device=joint_uv.device) + 0.5
    jx = (joint_uv[..., 0] + 1.0) / 2.0 * s
    jy = (joint_uv[..., 1] + 1.0) / 2.0 * s
    dx = (px[None, None, :, None] - jx[:, None, None, :]) / std
    dy = (px[None, :, None, None] - jy[:, None, None, :]) / std
    return torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma ** 2))


def pcl_joint_offset(joint, pcl, kernel: float):
    """[B,N,4J]: unit offsets point -> joint (joint-major) and closeness."""
    b, j, _ = joint.shape
    n = pcl.shape[1]
    off = joint[:, :, None] - pcl[:, None]
    dis = torch.sqrt(torch.sum(off ** 2, -1))
    unit = off / (dis[..., None] + 1e-8)
    close = (kernel - dis) / kernel
    mask = (close >= 0).float() * (pcl[:, None, :, 2] < 0.99).float()
    unit = (unit * mask[..., None]).permute(0, 2, 1, 3).reshape(b, n, 3 * j)
    return torch.cat([unit, (close * mask).permute(0, 2, 1)], -1)


def anchor_closeness(joint_uvd, depth, fr: Frame, gamma: float = 10.0):
    """[B,H,W,J]: 1/(gamma d2 + 1) of every pixel to each joint, both in
    normalized xyz (the joints taken as uvd, as the reference does)."""
    b, h, w, _ = depth.shape
    jx = uvd_nl_to_xyz_nl(joint_uvd, fr)
    px = uvd_nl_to_xyz_nl(pixel_uvd(depth), fr)
    close = 1.0 / (gamma * sqdist(jx, px) + 1.0)
    return close.reshape(b, -1, h, w).permute(0, 2, 3, 1)
