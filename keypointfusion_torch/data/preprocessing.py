"""Host-side geometric preprocessing of the data loaders (port of
keypointfusion_tpu/data/preprocessing.py): camera math, the deep-prior
crop, CoM / rotation / scale augmentation, depth normalization and
depth → point cloud, as free numpy functions.

The arithmetic is the JAX package's, line for line, so that every number
that no cv2 call touches comes out bit for bit. Its cv2 calls
(INTER_NEAREST resize, warpPerspective and warpAffine, and
getRotationMatrix2D) are data/cv_ops.py's numpy versions, which give
cv2's pixels. The reference's quirks stay: rotate_hand leaves the crop
matrix M as it was.
"""

from __future__ import annotations

import random as _random
from typing import Optional, Tuple

import numpy as np

from keypointfusion_torch.data import cv_ops

AUG_MODES = ['rot', 'com', 'sc', 'none']


# ---------------------------------------------------------------- camera ---

def joint_img_to_3d(uvd: np.ndarray, paras, flip: float = 1.0) -> np.ndarray:
    """uvd → camera xyz, any leading shape (loader.py:219-240)."""
    fx, fy, fu, fv = paras
    uvd = np.asarray(uvd, np.float32)
    ret = np.empty_like(uvd)
    ret[..., 0] = (uvd[..., 0] - fu) * uvd[..., 2] / fx
    ret[..., 1] = flip * (uvd[..., 1] - fv) * uvd[..., 2] / fy
    ret[..., 2] = uvd[..., 2]
    return ret


def joint_3d_to_img(xyz: np.ndarray, paras, flip: float = 1.0) -> np.ndarray:
    """camera xyz → uvd (loader.py:242-262)."""
    fx, fy, fu, fv = paras
    xyz = np.asarray(xyz, np.float32)
    ret = np.empty_like(xyz)
    ret[..., 0] = xyz[..., 0] * fx / xyz[..., 2] + fu
    ret[..., 1] = flip * xyz[..., 1] * fy / xyz[..., 2] + fv
    ret[..., 2] = xyz[..., 2]
    return ret


def transform_points_2d(pts: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Affine-transform the uv part of [N,>=2] points (loader.py:147-157),
    vectorized (the reference loops per point)."""
    out = np.asarray(pts, np.float32).copy()
    uv1 = np.concatenate([out[:, :2], np.ones((len(out), 1), np.float32)], 1)
    t = uv1 @ np.asarray(M, np.float32).T
    out[:, :2] = t[:, :2] / t[:, 2:3]
    return out


# ----------------------------------------------------------------- crops ---

def com_to_bounds(com, size, paras) -> Tuple[int, int, int, int, float, float]:
    """Pixel/z bounds of the metric crop cube (loader.py:291-301)."""
    fx, fy, _, _ = paras
    zstart = com[2] - size[2] / 2.
    zend = com[2] + size[2] / 2.
    xstart = int(np.floor((com[0] * com[2] / fx - size[0] / 2.) / com[2] * fx + 0.5))
    xend = int(np.floor((com[0] * com[2] / fx + size[0] / 2.) / com[2] * fx + 0.5))
    ystart = int(np.floor((com[1] * com[2] / fy - size[1] / 2.) / com[2] * fy + 0.5))
    yend = int(np.floor((com[1] * com[2] / fy + size[1] / 2.) / com[2] * fy + 0.5))
    return xstart, xend, ystart, yend, zstart, zend


def com_to_transform(com, size, dsize, paras) -> np.ndarray:
    """3x3 affine original-image → crop pixels (loader.py:303-338,
    including its square-centering quirk)."""
    xstart, xend, ystart, yend, _, _ = com_to_bounds(com, size, paras)
    trans = np.eye(3)
    trans[0, 2] = -xstart
    trans[1, 2] = -ystart
    wb, hb = xend - xstart, yend - ystart
    if wb > hb:
        scale = np.eye(3) * dsize[0] / float(wb)
        sz = (dsize[0], hb * dsize[0] / wb)
    else:
        scale = np.eye(3) * dsize[1] / float(hb)
        sz = (wb * dsize[1] / hb, dsize[1])
    scale[2, 2] = 1
    off = np.eye(3)
    off[0, 2] = int(np.floor(dsize[0] / 2. - sz[0] / 2.))
    off[1, 2] = int(np.floor(dsize[1] / 2. - sz[1] / 2.))
    return np.dot(off, np.dot(scale, trans))


def get_crop(img, xstart, xend, ystart, yend, zstart, zend,
             thresh_z=True, background=0) -> np.ndarray:
    """Crop with out-of-image padding and optional z-thresholding
    (loader.py:712-750)."""
    h, w = img.shape[:2]
    cropped = img[max(ystart, 0):min(yend, h),
                  max(xstart, 0):min(xend, w)].copy()
    pad = ((abs(ystart) - max(ystart, 0), abs(yend) - min(yend, h)),
           (abs(xstart) - max(xstart, 0), abs(xend) - min(xend, w)))
    if img.ndim == 3:
        pad = pad + ((0, 0),)
    cropped = np.pad(cropped, pad, mode='constant',
                     constant_values=background)
    if thresh_z:
        msk1 = np.logical_and(cropped < zstart, cropped != 0)
        msk2 = np.logical_and(cropped > zend, cropped != 0)
        cropped[msk1] = zstart
        cropped[msk2] = 0.
    return cropped


def _resize_and_center(rz, dsize, channels: int = 0):
    if channels:
        ret = np.zeros((dsize[1], dsize[0], channels), np.float32)
    else:
        ret = np.zeros(dsize, np.float32)
    xstart = int(np.floor(dsize[0] / 2. - rz.shape[1] / 2.))
    ystart = int(np.floor(dsize[1] / 2. - rz.shape[0] / 2.))
    ret[ystart:ystart + rz.shape[0], xstart:xstart + rz.shape[1]] = rz
    off = np.eye(3)
    off[0, 2] = xstart
    off[1, 2] = ystart
    return ret, off


def crop_area_3d(depth, com, size, dsize, paras,
                 thresh_z: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Deep-prior crop: cube around the CoM, nearest-resize, center-pad.
    Returns (crop [dsize], M). Mirrors Crop_Image_deep_pp
    (loader.py:659-710) and its RGB variant (:604-656, thresh_z=False,
    3-channel)."""
    xstart, xend, ystart, yend, zstart, zend = com_to_bounds(com, size, paras)
    cropped = get_crop(depth, xstart, xend, ystart, yend, zstart, zend,
                       thresh_z=thresh_z)
    wb, hb = xend - xstart, yend - ystart
    if wb > hb:
        sz = (dsize[0], int(hb * dsize[0] / wb))
    else:
        sz = (int(wb * dsize[1] / hb), dsize[1])
    trans = np.eye(3)
    trans[0, 2] = -xstart
    trans[1, 2] = -ystart
    if cropped.shape[0] > cropped.shape[1]:
        scale = np.eye(3) * sz[1] / float(cropped.shape[0])
    else:
        scale = np.eye(3) * sz[0] / float(cropped.shape[1])
    scale[2, 2] = 1
    rz = cv_ops.resize(cropped, sz)
    channels = depth.shape[2] if depth.ndim == 3 else 0
    ret, off = _resize_and_center(rz, dsize, channels)
    return ret, np.dot(off, np.dot(scale, trans))


def normalize_img(premax, imgD, com, cube) -> np.ndarray:
    """Depth crop → [-1, 1] around com z, background → +1
    (loader.py:595-602, in-place like the reference)."""
    imgD = imgD.copy()
    zmax = com[2] + cube[2] / 2.
    zmin = com[2] - cube[2] / 2.
    imgD[imgD == premax] = zmax
    imgD[imgD == 0] = zmax
    imgD[imgD >= zmax] = zmax
    imgD[imgD <= zmin] = zmin
    imgD -= com[2]
    imgD /= (cube[2] / 2.)
    return imgD


# ---------------------------------------------------------- augmentation ---

def recrop_hand(crop, M, Mnew, target_size, paras, background_value=0.,
                nv_val=0., thresh_z=True, com=None, size=(250, 250, 250)):
    """Re-warp an already-cropped image under a new crop transform
    (loader.py:340-361)."""
    warped = cv_ops.warp_perspective(crop, np.dot(M, Mnew), target_size[:2],
                                     float(background_value))
    if thresh_z:
        warped[warped < nv_val] = background_value
        assert com is not None
        _, _, _, _, zstart, zend = com_to_bounds(com, size, paras)
        msk1 = np.logical_and(warped < zstart, warped != 0)
        msk2 = np.logical_and(warped > zend, warped != 0)
        warped[msk1] = zstart
        warped[msk2] = 0.
    return warped


def move_com(dpt, cube, com, off, joints3D, M, paras, pad_value=0,
             thresh_z=True, flip: float = 1.0):
    """Simulate a shifted center-of-mass crop (loader.py:363-402)."""
    if np.allclose(off, 0.):
        return dpt, joints3D, com, M
    new_com = joint_3d_to_img(joint_img_to_3d(com, paras, flip) + off,
                              paras, flip)
    if np.allclose(com[2], 0.) or np.allclose(new_com[2], 0.):
        return dpt, joints3D, com, M
    Mnew = com_to_transform(new_com, cube, dpt.shape[:2], paras)
    nv = (np.min(dpt[dpt > 0]) - 1) if (dpt > 0).any() else -1
    new_dpt = recrop_hand(dpt.astype('float32'), Mnew, np.linalg.inv(M),
                          dpt.shape, paras, background_value=pad_value,
                          nv_val=nv, thresh_z=thresh_z, com=new_com,
                          size=cube)
    new_joints3D = joints3D + joint_img_to_3d(com, paras, flip) \
        - joint_img_to_3d(new_com, paras, flip)
    return new_dpt, new_joints3D, new_com, Mnew


def rotate_hand(dpt, cube, com, rot, joints3D, paras, pad_value=0,
                thresh_z=True, flip: float = 1.0):
    """In-plane rotation augment (loader.py:404-437). Note the crop matrix M
    is NOT updated by the reference — replicated here."""
    if np.allclose(rot, 0.):
        return dpt, joints3D, rot
    rot = np.mod(rot, 360)
    M2 = cv_ops.get_rotation_matrix_2d(
        (dpt.shape[1] // 2, dpt.shape[0] // 2), -rot, 1)
    new_dpt = cv_ops.warp_affine(dpt.astype('float32'), M2,
                                 (dpt.shape[1], dpt.shape[0]), pad_value)
    if thresh_z and (dpt > 0).any():
        new_dpt[new_dpt < (np.min(dpt[dpt > 0]) - 1)] = 0
    com3D = joint_img_to_3d(com, paras, flip)
    joint_2d = joint_3d_to_img(joints3D + com3D, paras, flip)
    # vectorized rotatePoints2D (loader.py:102-133)
    alpha = rot * np.pi / 180.
    rel = joint_2d[:, :2] - com[:2]
    ca, sa = np.cos(alpha), np.sin(alpha)
    rotated = np.stack([rel[:, 0] * ca - rel[:, 1] * sa,
                        rel[:, 0] * sa + rel[:, 1] * ca], -1) + com[:2]
    data_2d = np.concatenate([rotated, joint_2d[:, 2:]], -1)
    new_joints3D = joint_img_to_3d(data_2d, paras, flip) - com3D
    return new_dpt, new_joints3D, rot


def scale_hand(dpt, cube, com, sc, joints3D, M, paras, pad_value=0,
               thresh_z=True):
    """Cube-scale augment (loader.py:439-473)."""
    if np.allclose(sc, 1.):
        return dpt, joints3D, cube, M
    new_cube = [s * sc for s in cube]
    if np.allclose(com[2], 0.):
        return dpt, joints3D, cube, M
    Mnew = com_to_transform(com, new_cube, dpt.shape[:2], paras)
    nv = (np.min(dpt[dpt > 0]) - 1) if (dpt > 0).any() else -1
    new_dpt = recrop_hand(dpt.astype('float32'), Mnew, np.linalg.inv(M),
                          dpt.shape, paras, background_value=pad_value,
                          nv_val=nv, thresh_z=thresh_z, com=com, size=cube)
    return new_dpt, joints3D, new_cube, Mnew


def rand_augment(rng: _random.Random, sigma_com=35., sigma_sc=0.05,
                 rot_range=180., modes=AUG_MODES):
    """Draw one augmentation (loader.py:475-499 — python `random` draws,
    matching the reference's sampler)."""
    mode = rng.randint(0, len(modes) - 1)
    off = np.array([rng.uniform(-1, 1) for _ in range(3)]) * sigma_com
    rot = rng.uniform(-rot_range, rot_range)
    sc = abs(1. + rng.uniform(-1, 1) * sigma_sc)
    return mode, off, rot, sc


def augment_crop(img, gt3Dcrop, com, cube, M, mode, off, rot, sc, paras,
                 flip: float = 1.0, rgb: bool = False,
                 modes=AUG_MODES):
    """Apply one augmentation to a cropped depth (or RGB) image
    (loader.py:501-593). Depth images are normalized afterwards by the
    caller via normalize_img (for depth the reference normalizes inside;
    we keep that behavior)."""
    thresh_z = not rgb
    premax = img.max() if not rgb else None
    if (not rgb) and np.max(img) == 0:
        out, new_joints = img, gt3Dcrop
    elif modes[mode] == 'com':
        rot, sc = 0., 1.
        out, new_joints, com, M = move_com(img.astype('float32'), cube, com,
                                           off, gt3Dcrop, M, paras,
                                           pad_value=0, thresh_z=thresh_z,
                                           flip=flip)
    elif modes[mode] == 'rot':
        off, sc = np.zeros(3), 1.
        out, new_joints, rot = rotate_hand(img.astype('float32'), cube, com,
                                           rot, gt3Dcrop, paras, pad_value=0,
                                           thresh_z=thresh_z, flip=flip)
    elif modes[mode] == 'sc':
        off, rot = np.zeros(3), 0.
        out, new_joints, cube, M = scale_hand(img.astype('float32'), cube,
                                              com, sc, gt3Dcrop, M, paras,
                                              pad_value=0, thresh_z=thresh_z)
    elif modes[mode] == 'none':
        out, new_joints = img, gt3Dcrop
    else:
        raise NotImplementedError(modes[mode])
    if not rgb:
        out = normalize_img(premax, out, com, cube)
    return out, new_joints, np.asarray(cube), com, M, rot


# ------------------------------------------------------------------ pcl ---

def depth_to_pcl(dpt, M, paras, flip: float = 1.0,
                 background_val=0.) -> np.ndarray:
    """Valid pixels of an (un-normalized) crop depth → camera xyz
    (loader.py:874-893)."""
    fx, fy, fu, fv = paras
    vs, us = np.where(~np.isclose(dpt, background_val))
    uv1 = np.stack([us + 0.5, vs + 0.5, np.ones(len(us))], -1)
    pts = uv1 @ np.linalg.inv(np.asarray(M)).T
    pts = pts[:, :2] / pts[:, 2:3]
    depth = dpt[vs, us]
    row = (pts[:, 0] - fu) / fx * depth
    col = flip * (pts[:, 1] - fv) / fy * depth
    return np.column_stack((row, col, depth)).astype(np.float32)


def get_pcl(imgD, com3D, cube, M, paras, flip: float = 1.0) -> np.ndarray:
    """Normalized crop depth → normalized point cloud (loader.py:843-853)."""
    mask = np.isclose(imgD, 1)
    dpt_ori = imgD * cube[2] / 2.0 + com3D[2]
    dpt_ori[mask] = 0
    pcl = depth_to_pcl(dpt_ori, M, paras, flip) - com3D
    return (pcl / (np.asarray(cube) / 2.0)).astype(np.float32)


def sample_pcl(pcl: np.ndarray, num: int,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Fixed-size resample with the reference's repeat-then-choice logic
    (loader.py:1173-1186)."""
    rng = rng or np.random
    n = pcl.shape[0]
    if n == 0:
        return np.zeros([num, 3], np.float32)
    idx = np.arange(n)
    if n < num:
        idx = np.append(idx.repeat(num // n),
                        rng.choice(np.arange(n), size=num % n,
                                   replace=False))
    select = rng.choice(idx, num, replace=False)
    return pcl[select].astype(np.float32)
