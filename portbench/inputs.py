"""Seeded synthetic inputs, made on the device in bulk.

`frames`: full RGB-D camera frames for the streaming engine, laid out as
the repository's synthetic frames (data/synthetic.py:synthetic_frames of
the port): a block of 500-700 mm depth over the middle third of the rows
and the middle quarter of the columns (zero elsewhere), uniform uint8 RGB,
the crop centre at the image centre 600 mm away, a 250 mm cube, a focal
length of 600 px at 640 px width. Made on the card and copied to host
memory, where a camera's frames arrive.

`crops`: the train and eval batch (synthetic_batch's layout): crops of
128x128 with a hand of 12x12 px squares of joint depth (the nearest joint
on top), RGB from depth plus noise, and a cloud of pixels drawn from the
hand without replacement (with replacement, cycling, when the hand holds
fewer pixels than the cloud), all consistent with each sample's camera,
centre and crop transform. Made and kept on the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

FX, FY, FU, FV = 600.0, 600.0, 320.0, 240.0


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one purpose (`stream`) of a run."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003 + stream) % 2 ** 63)
    return g


def frames(seed: int, count: int, batch: int, height: int, width: int,
           device) -> List[Dict[str, np.ndarray]]:
    """`count` distinct batches of full frames (numpy, host memory):
    depth uint16 [B,H,W], rgb uint8 [B,H,W,3], centers/cube [B,3] and cam
    [B,4] float32."""
    g = generator(seed, device, 1)
    b, h, w = batch, height, width
    f = 600.0 * w / 640.0
    out = []
    for _ in range(count):
        y0, y1, x0, x1 = h // 3, 2 * h // 3, 3 * w // 8, 5 * w // 8
        depth = torch.zeros((b, h, w), dtype=torch.int16, device=device)
        depth[:, y0:y1, x0:x1] = torch.randint(
            500, 700, (b, y1 - y0, x1 - x0), generator=g, device=device,
            dtype=torch.int16)
        rgb = torch.randint(0, 255, (b, h, w, 3), generator=g, device=device,
                            dtype=torch.uint8)
        out.append({
            'depth': depth.cpu().numpy().view(np.uint16),
            'rgb': rgb.cpu().numpy(),
            'centers': np.tile(np.array([[w / 2, h / 2, 600]], np.float32),
                               (b, 1)),
            'cube': np.full((b, 3), 250, np.float32),
            'cam': np.tile(np.array([[f, f, w / 2, h / 2]], np.float32),
                           (b, 1))})
    return out


def crops(seed: int, count: int, batch: int, point_num: int, device,
          joint_num: int = 21, size: int = 128, cube_mm: float = 250.0
          ) -> List[Dict[str, torch.Tensor]]:
    """`count` distinct train/eval batches on `device`: rgb [B,S,S,3],
    depth [B,S,S,1], pcl [B,N,3], xyz_gt, uvd_gt [B,J,3], center, cube
    [B,3], M [B,3,3], cam_para [B,4], float32."""
    g = generator(seed, device, 2)
    b, j, s = batch, joint_num, size
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        shape, generator=g, device=device)
    out = []
    for _ in range(count):
        center = torch.stack([u(-30, 30, b), u(-30, 30, b),
                              u(550, 750, b)], -1)
        cube = torch.full((b, 3), cube_mm, device=device)
        cam = torch.tensor([[FX, FY, FU, FV]], device=device).expand(b, 4)
        cu = center[:, 0] * FX / center[:, 2] + FU
        cv = center[:, 1] * FY / center[:, 2] + FV
        scale = s / (cube_mm * FX / center[:, 2])
        M = torch.zeros((b, 3, 3), device=device)
        M[:, 0, 0] = scale
        M[:, 1, 1] = scale
        M[:, 2, 2] = 1.0
        M[:, 0, 2] = s / 2.0 - scale * cu
        M[:, 1, 2] = s / 2.0 - scale * cv
        xyz = u(-0.55, 0.55, b, j, 3)
        mm = xyz * cube[:, None] / 2.0 + center[:, None]
        pu = mm[..., 0] * FX / mm[..., 2] + FU
        pv = mm[..., 1] * FY / mm[..., 2] + FV
        uc = M[:, 0, 0, None] * pu + M[:, 0, 2, None]
        vc = M[:, 1, 1, None] * pv + M[:, 1, 2, None]
        uvd = torch.stack([uc / (s / 2.0) - 1.0, vc / (s / 2.0) - 1.0,
                           (mm[..., 2] - center[:, None, 2]) / (cube_mm / 2)],
                          -1)
        # squares of 12 px at each joint's pixel, the nearest joint on top
        cx = torch.trunc((uvd[..., 0] + 1) / 2 * s)
        cy = torch.trunc((uvd[..., 1] + 1) / 2 * s)
        px = torch.arange(s, device=device, dtype=torch.float32)
        in_x = (px >= cx[..., None] - 6) & (px < cx[..., None] + 6)
        in_y = (px >= cy[..., None] - 6) & (px < cy[..., None] + 6)
        cover = in_y[..., :, None] & in_x[..., None, :]        # [B,J,S,S]
        z = torch.where(cover, uvd[..., 2, None, None],
                        torch.full_like(cover, 1.0, dtype=torch.float32))
        depth = z.amin(1)[..., None]                           # [B,S,S,1]
        rgb = (1.0 - depth) * 0.5 + u(0, 0.05, b, s, s, 3)
        # the cloud: hand pixels in a random order
        flat = depth.reshape(b, s * s)
        hand = flat < 0.99
        key = torch.where(hand, u(0, 1, b, s * s), torch.full_like(flat, 2.0))
        order = torch.argsort(key, -1)
        n_hand = hand.sum(-1, keepdim=True).clamp_min(1)
        slot = torch.arange(point_num, device=device)[None] % n_hand
        pick = torch.gather(order, 1, slot)
        d_mm = torch.gather(flat, 1, pick) * cube_mm / 2.0 \
            + center[:, 2:3]
        ppu = (pick % s).float() + 0.5
        ppv = torch.div(pick, s, rounding_mode='floor').float() + 0.5
        uo = (ppu - M[:, 0, 2, None]) / M[:, 0, 0, None]
        vo = (ppv - M[:, 1, 2, None]) / M[:, 1, 1, None]
        pts = torch.stack([(uo - FU) / FX * d_mm, (vo - FV) / FY * d_mm,
                           d_mm], -1)
        pcl = (pts - center[:, None]) / (cube_mm / 2.0)
        out.append({'rgb': rgb, 'depth': depth, 'pcl': pcl, 'xyz_gt': xyz,
                    'uvd_gt': uvd, 'center': center, 'M': M, 'cube': cube,
                    'cam_para': cam.contiguous()})
    return out
