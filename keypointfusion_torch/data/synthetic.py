"""Geometrically consistent synthetic RGB-D batches (numpy only).

The port's copy of keypointfusion_tpu/data/synthetic.py, kept so that the
port imports nothing from the JAX package. Used by chip_smoke.py and the
tests so the full model runs with realistic structure (joints, depth
blobs, point cloud, crop transforms all mutually consistent) without any
dataset on disk.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

FX, FY, FU, FV = 600.0, 600.0, 320.0, 240.0


def synthetic_batch(batch_size: int = 8, joint_num: int = 21,
                    img_size: int = 128, point_num: int = 1024,
                    cube_mm: float = 250.0, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """Returns the training batch dict (all float32 numpy, NHWC images):
    rgb, depth, pcl, xyz_gt, uvd_gt, center, M, cube, cam_para."""
    rng = np.random.RandomState(seed)
    b, j, s = batch_size, joint_num, img_size

    center = np.stack([rng.uniform(-30, 30, b), rng.uniform(-30, 30, b),
                       rng.uniform(550, 750, b)], -1).astype(np.float32)
    cube = np.full((b, 3), cube_mm, np.float32)
    cam_para = np.tile(np.array([[FX, FY, FU, FV]], np.float32), (b, 1))

    # crop transform M: center the com, scale the cube extent to img_size px
    # (structure of reference loader.py:303-338 comToTransform)
    center_u = center[:, 0] * FX / center[:, 2] + FU
    center_v = center[:, 1] * FY / center[:, 2] + FV
    scale = img_size / (cube_mm * FX / center[:, 2])
    M = np.zeros((b, 3, 3), np.float32)
    M[:, 0, 0] = scale
    M[:, 1, 1] = scale
    M[:, 2, 2] = 1.0
    M[:, 0, 2] = s / 2.0 - scale * center_u
    M[:, 1, 2] = s / 2.0 - scale * center_v

    # joints: random hand-ish cluster inside the cube (normalized xyz)
    xyz_gt = rng.uniform(-0.55, 0.55, (b, j, 3)).astype(np.float32)

    # project to normalized uvd through the exact crop transform
    xyz_mm = xyz_gt * cube[:, None] / 2.0 + center[:, None]
    u = xyz_mm[..., 0] * FX / xyz_mm[..., 2] + FU
    v = xyz_mm[..., 1] * FY / xyz_mm[..., 2] + FV
    uc = M[:, 0, 0, None] * u + M[:, 0, 2, None]
    vc = M[:, 1, 1, None] * v + M[:, 1, 2, None]
    uvd_gt = np.stack(
        [uc / (s / 2.0) - 1.0, vc / (s / 2.0) - 1.0,
         (xyz_mm[..., 2] - center[:, None, 2]) / (cube_mm / 2.0)],
        -1).astype(np.float32)

    # depth: background 1.0, square patches of joint depth at projections
    depth = np.ones((b, s, s, 1), np.float32)
    half = 6
    for bi in range(b):
        order = np.argsort(-uvd_gt[bi, :, 2])   # far joints first
        for ji in order:
            cx = int((uvd_gt[bi, ji, 0] + 1) / 2 * s)
            cy = int((uvd_gt[bi, ji, 1] + 1) / 2 * s)
            x0, x1 = max(cx - half, 0), min(cx + half, s)
            y0, y1 = max(cy - half, 0), min(cy + half, s)
            if x0 < x1 and y0 < y1:
                depth[bi, y0:y1, x0:x1, 0] = uvd_gt[bi, ji, 2]

    rgb = np.broadcast_to((1.0 - depth) * 0.5, (b, s, s, 3)).copy()
    rgb += rng.uniform(0, 0.05, rgb.shape).astype(np.float32)

    # point cloud from the rendered depth (host-side mirror of getpcl)
    pcl = np.zeros((b, point_num, 3), np.float32)
    ys, xs = np.mgrid[0:s, 0:s]
    for bi in range(b):
        mask = depth[bi, :, :, 0] < 0.99
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            continue
        pick = rng.choice(idx, point_num, replace=idx.size < point_num)
        pu = xs.ravel()[pick] + 0.5
        pv = ys.ravel()[pick] + 0.5
        d_mm = depth[bi].ravel()[pick] * cube_mm / 2.0 + center[bi, 2]
        Minv = np.linalg.inv(M[bi])
        uo = Minv[0, 0] * pu + Minv[0, 2]
        vo = Minv[1, 1] * pv + Minv[1, 2]
        x = (uo - FU) / FX * d_mm
        y = (vo - FV) / FY * d_mm
        xyz = np.stack([x, y, d_mm], -1)
        pcl[bi] = (xyz - center[bi]) / (cube_mm / 2.0)

    return {
        'rgb': rgb.astype(np.float32), 'depth': depth, 'pcl': pcl,
        'xyz_gt': xyz_gt, 'uvd_gt': uvd_gt, 'center': center, 'M': M,
        'cube': cube, 'cam_para': cam_para,
    }


def synthetic_dataset(n: int, point_num: int = 1024, seed: int = 0,
                      joint_num: int = 21) -> List[Dict[str, np.ndarray]]:
    """An in-memory dataset for the trainer: n samples (synthetic_batch's
    arrays without the batch axis), sample i drawn with seed `seed + i`,
    as the JAX package's trainer tests draw theirs."""
    return [{k: v[0] for k, v in synthetic_batch(
        batch_size=1, joint_num=joint_num, point_num=point_num,
        seed=seed + i).items()} for i in range(n)]


def synthetic_frames(batch_size: int, height: int = 480, width: int = 640,
                     rng: np.random.RandomState = None
                     ) -> Dict[str, np.ndarray]:
    """Full RGB-D frames as bench.py makes them for the streaming engine:
    a block of 500-700 mm depth over the middle third of the rows and the
    middle quarter of the columns (zero elsewhere), uniform uint8 RGB, the
    crop centre at the image centre 600 mm away, a 250 mm cube, and a
    focal length of 600 px at 640 px width (scaled with the width).
    Returns the engine's batch dict: depth uint16 [B,H,W], rgb uint8
    [B,H,W,3], centers/cube [B,3] and cam [B,4] float32."""
    rng = np.random.RandomState(0) if rng is None else rng
    b, h, w = batch_size, height, width
    depth = np.zeros((b, h, w), np.uint16)
    depth[:, h // 3:2 * h // 3, 3 * w // 8:5 * w // 8] = rng.randint(
        500, 700, (b, h // 3, w // 4)).astype(np.uint16)
    f = 600.0 * w / 640.0
    return {'depth': depth,
            'rgb': rng.randint(0, 255, (b, h, w, 3)).astype(np.uint8),
            'centers': np.tile(np.array([[w / 2, h / 2, 600]], np.float32),
                               (b, 1)),
            'cube': np.full((b, 3), 250, np.float32),
            'cam': np.tile(np.array([[f, f, w / 2, h / 2]], np.float32),
                           (b, 1))}
