"""Patch-warp utilities for bbox-based crops (port of
keypointfusion_tpu/data/patch_warp.py; the reference's
dataloader/preprocess.py:453-536, off the DexYCB main path). Host-side
numpy: cv2's getAffineTransform and bilinear warpAffine are
data/cv_ops.py's, bit for bit with cv2 5.0, and the draws of
patch_augmentation come from Python's random in the JAX module's order.
"""

from __future__ import annotations

import random as _random
from typing import Tuple

import numpy as np

from keypointfusion_torch.data import cv_ops


def rotate_2d(pt, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs],
                    np.float32)


def gen_trans_from_patch(c_x, c_y, src_w, src_h, dst_w, dst_h, scale, rot,
                         transl=(0.0, 0.0), inv=False) -> np.ndarray:
    """2x3 float32 affine mapping an augmented source patch to the
    destination (the reference's preprocess.py:498-536)."""
    sw, sh = src_w * scale, src_h * scale
    src_center = np.array([c_x + transl[0], c_y + transl[1]], np.float32)
    rot_rad = np.pi * rot / 180
    src_down = rotate_2d(np.array([0, sh * 0.5], np.float32), rot_rad)
    src_right = rotate_2d(np.array([sw * 0.5, 0], np.float32), rot_rad)
    dst_center = np.array([dst_w * 0.5, dst_h * 0.5], np.float32)
    dst_down = np.array([0, dst_h * 0.5], np.float32)
    dst_right = np.array([dst_w * 0.5, 0], np.float32)
    src = np.stack([src_center, src_center + src_down,
                    src_center + src_right]).astype(np.float32)
    dst = np.stack([dst_center, dst_center + dst_down,
                    dst_center + dst_right]).astype(np.float32)
    if inv:
        return cv_ops.get_affine_transform(dst, src).astype(np.float32)
    return cv_ops.get_affine_transform(src, dst).astype(np.float32)


def generate_patch_image(img, bbox, scale, rot, transl, do_flip, out_shape
                         ) -> Tuple[np.ndarray, ...]:
    """Warp a bbox patch to out_shape with scale/rot/translation/flip
    augmentation (the reference's preprocess.py:464-486). Returns
    (patch float32, trans, inv_trans, trans_joint, inv_trans_joint)."""
    img = img.copy()
    h, w = img.shape[:2]
    c_x = float(bbox[0] + 0.5 * bbox[2])
    c_y = float(bbox[1] + 0.5 * bbox[3])
    bw, bh = float(bbox[2]), float(bbox[3])
    if do_flip:
        img = img[:, ::-1]
        c_x = w - c_x - 1
    args = (c_x, c_y, bw, bh, out_shape[1], out_shape[0])
    trans = gen_trans_from_patch(*args, scale, rot, transl)
    patch = cv_ops.warp_affine(img, trans, (int(out_shape[1]),
                                            int(out_shape[0])),
                               interpolation='linear').astype(np.float32)
    inv_trans = gen_trans_from_patch(*args, scale, rot, transl, inv=True)
    trans_joint = gen_trans_from_patch(*args, 1.0, 0.0, transl)
    inv_trans_joint = gen_trans_from_patch(*args, 1.0, 0.0, transl,
                                           inv=True)
    return patch, trans, inv_trans, trans_joint, inv_trans_joint


def patch_augmentation(img, bbox, train: bool, out_shape=(256, 256),
                       rng: _random.Random = None, exclude_flip=False):
    """bbox-crop augmentation (the reference's preprocess.py:429-461):
    scale in [0.9, 1.1], rotation +-180 deg, translation +-10 px, colour
    scale +-20%, 50% flip, drawn from `rng` (Python's random module when
    None) in this order. Returns (patch, trans, inv_trans, rot, do_flip,
    inv_trans_joint); patch is float64 [H, W, C] in [0, 255]."""
    rng = rng or _random
    if train:
        scale = rng.random() * (1.1 - 0.9) + 0.9
        rot = (rng.random() * 2 - 1) * 180
        transl = ((rng.random() * 2 - 1) * 10, (rng.random() * 2 - 1) * 10)
        color = np.array([rng.uniform(0.8, 1.2) for _ in range(3)])
        do_flip = (not exclude_flip) and rng.random() <= 0.5
    else:
        scale, rot, transl = 1.0, 0.0, (0.0, 0.0)
        color = np.ones(3)
        do_flip = False
    patch, trans, inv_trans, _, inv_tj = generate_patch_image(
        img, bbox, scale, rot, transl, do_flip, out_shape)
    patch = np.clip(patch * color[None, None, :], 0, 255)
    return patch, trans, inv_trans, rot, do_flip, inv_tj
