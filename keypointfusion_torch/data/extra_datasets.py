"""FreiHAND / RHD loading helpers and the small crop/heatmap utilities of
the reference's preprocess module (port of
keypointfusion_tpu/data/extra_datasets.py; the reference's
dataloader/preprocess.py:51-265, 305-352, 364-428), off the main path.
Host-side numpy, as the JAX module; what it asks of OpenCV is
data/cv_ops.py's copy_make_border and flip and data/image_io.py's
imread, bit for bit with cv2 5.0.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import List, Optional, Tuple

import numpy as np

from keypointfusion_torch.data import cv_ops
from keypointfusion_torch.data.image_io import imread

# FreiHAND appearance versions, in release order (preprocess.py:134-155)
FREIHAND_VERSIONS = ('gs', 'hom', 'sample', 'auto')

FREIHAND_DB_SIZE = {'training': 32560, 'evaluation': 3960}

# RHD stores left-hand joints first; this maps RHD order → MANO-ish order
# used by the reference (preprocess.py:201-211)
RHD_KP_MAP = np.array([0, 20, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10,
                       9, 8, 7, 6, 5, 4, 3, 2, 1])


def project_points(xyz, K) -> np.ndarray:
    """Perspective projection (preprocess.py:62-67)."""
    uv = np.asarray(xyz) @ np.asarray(K).T
    return uv[:, :2] / uv[:, -1:]


def freihand_db_size(set_name: str) -> int:
    if set_name not in FREIHAND_DB_SIZE:
        raise ValueError(f'invalid FreiHAND split {set_name!r}')
    return FREIHAND_DB_SIZE[set_name]


def freihand_map_id(idx: int, version: str = 'gs') -> int:
    """Sample id for an appearance version (preprocess.py:151-155)."""
    if version not in FREIHAND_VERSIONS:
        raise ValueError(f'invalid version {version!r} '
                         f'(one of {FREIHAND_VERSIONS})')
    return idx + FREIHAND_DB_SIZE['training'] * \
        FREIHAND_VERSIONS.index(version)


def load_freihand_annotations(base_path: str,
                              set_name: str = 'training') -> List[Tuple]:
    """FreiHAND index: zipped (K, verts, xyz, scale) per sample
    (preprocess.py:80-106)."""
    def _load(name):
        path = osp.join(base_path, f'{set_name}_{name}.json')
        with open(path) as f:
            return json.load(f)
    k, verts, xyz, scale = (_load(n) for n in
                            ('K', 'verts', 'xyz', 'scale'))
    if not (len(k) == len(verts) == len(xyz) == len(scale)):
        raise ValueError('FreiHAND annotation size mismatch')
    return list(zip(k, verts, xyz, scale))


def read_freihand_img(idx: int, base_path: str, set_name: str,
                      version: Optional[str] = None) -> np.ndarray:
    """Read one FreiHAND rgb frame (preprocess.py:158-168)."""
    version = version or 'gs'
    if set_name == 'evaluation' and version != 'gs':
        raise ValueError("evaluation split only has the 'gs' version")
    path = osp.join(base_path, set_name, 'rgb',
                    '%08d.jpg' % freihand_map_id(idx, version))
    img = imread(path)
    if img is None:
        raise IOError(f'Fail to read {path}')
    return img


def pad_img_to_fit_bbox(img, x1, x2, y1, y2,
                        border_value=(127, 127, 127)):
    """Grow the image with constant borders so [x1:x2, y1:y2] is valid
    (preprocess.py:190-199)."""
    img = cv_ops.copy_make_border(img, -min(0, y1),
                                  max(y2 - img.shape[0], 0), -min(0, x1),
                                  max(x2 - img.shape[1], 0), border_value)
    y2 += -min(0, y1)
    y1 += -min(0, y1)
    x2 += -min(0, x1)
    x1 += -min(0, x1)
    return img, x1, x2, y1, y2


def imcrop(img, center, crop_size):
    """Square crop around `center`, padding when out of bounds; returns
    (crop, 3x3 translation) (preprocess.py:170-188)."""
    x1 = int(np.round(center[0] - crop_size))
    y1 = int(np.round(center[1] - crop_size))
    x2 = int(np.round(center[0] + crop_size))
    y2 = int(np.round(center[1] + crop_size))
    if x1 < 0 or y1 < 0 or x2 > img.shape[1] or y2 > img.shape[0]:
        img, x1, x2, y1, y2 = pad_img_to_fit_bbox(img, x1, x2, y1, y2)
    crop = img[y1:y2, x1:x2] if img.ndim < 3 else img[y1:y2, x1:x2, :]
    trans = np.eye(3)
    trans[0, 2] = -x1
    trans[1, 2] = -y1
    return crop, trans


def convert_kp(keypoints: np.ndarray) -> np.ndarray:
    """RHD keypoint reorder (preprocess.py:201-211)."""
    return np.asarray(keypoints)[RHD_KP_MAP]


def preprocess_rhd(image, mask, kp_coord_uv, kp_coord_xyz):
    """RHD frame → dominant-hand crop spec: picks the hand with more mask
    pixels, mirrors right hands to left, and derives the crop
    center/size from the hand mask (preprocess.py:213-265).

    Returns (image, mask, xyz, crop_center, crop_size, hand_side_onehot).
    """
    temp_mask = mask.copy()
    mask1 = mask[:, :, 0]
    image_size = image.shape[1]
    cond_l = np.logical_and(mask1 > 1, mask1 < 18)
    cond_r = mask1 > 17
    left = int(np.sum(cond_l)) > int(np.sum(cond_r))
    kp_coord_xyz = np.asarray(kp_coord_xyz)
    kp_coord_uv = np.asarray(kp_coord_uv)
    if left:
        xyz = kp_coord_xyz[:21].copy()
        uv = kp_coord_uv[:21].copy()
    else:
        xyz = kp_coord_xyz[-21:].copy()
        uv = kp_coord_uv[-21:].copy()
        image = cv_ops.flip(image, 1)
        temp_mask = cv_ops.flip(temp_mask, 1)
        mask1 = cv_ops.flip(mask1, 1)
        xyz[:, 0] = -xyz[:, 0]
        uv[:, 0] = image_size - uv[:, 0]

    y, x = np.where(cond_l if left else (mask1 > 17))
    ratio = 1 / 0.8
    crop_center = ((x.max() + x.min()) / 2, (y.max() + y.min()) / 2)
    crop_size = max(x.max() - x.min(), y.max() - y.min()) * ratio // 2
    hand_side = np.array([1.0, 0.0]) if left else np.array([0.0, 1.0])
    return image, temp_mask, xyz, crop_center, crop_size, hand_side


def unify_mask(cropped_mask, hand_side):
    """Normalize the RHD per-finger mask labels to [0 bg, 1..16 hand]
    (preprocess.py:328-351)."""
    m = np.asarray(cropped_mask)
    if hand_side[0]:
        m = np.where(np.logical_and(m == 1, m >= 18), 0, m)
        m = np.where(m >= 1, m - 1, m)
    else:
        m = np.where(np.logical_and(m >= 1, m < 18), 0, m)
        m = np.where(m >= 1, m - 17, m)
    return np.where(m >= 17, 0, m)


def create_heatmap(joint_uv, ht_size: int = 64,
                   std: float = float(np.sqrt(2.5))) -> np.ndarray:
    """Per-joint gaussian heatmaps from absolute uv (preprocess.py:305-327).
    joint_uv [J,2] → [J,ht,ht]; all-zero joints yield zero maps."""
    joint_uv = np.asarray(joint_uv, np.float32)
    j = joint_uv.shape[0]
    if (joint_uv == 0).all():
        return np.zeros((j, ht_size, ht_size))
    xx, yy = np.meshgrid(np.arange(ht_size, dtype=np.float32),
                         np.arange(ht_size, dtype=np.float32))
    dx = (xx[None] - joint_uv[:, 0, None, None]) / std
    dy = (yy[None] - joint_uv[:, 1, None, None]) / std
    return np.exp(-(dx ** 2 + dy ** 2))


def make_gaussian_heatmap(joint_coord_img, hm_hw: Tuple[int, int],
                          sigma: float = 2.5) -> np.ndarray:
    """Batched gaussian heatmaps, torch-free (preprocess.py:417-428):
    joint_coord_img [B,J,2] → [B,J,H,W]."""
    h, w = hm_hw
    joint = np.asarray(joint_coord_img, np.float32)
    xx = np.arange(w, dtype=np.float32)[None, None, None, :]
    yy = np.arange(h, dtype=np.float32)[None, None, :, None]
    x = joint[:, :, 0, None, None]
    y = joint[:, :, 1, None, None]
    return np.exp(-(((xx - x) / sigma) ** 2) / 2
                  - (((yy - y) / sigma) ** 2) / 2)
