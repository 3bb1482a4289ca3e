"""Rotation-representation conversions and batched camera helpers (port
of keypointfusion_tpu/utils/rotations.py): axis-angle, quaternion
(w, x, y, z), rotation matrix, XYZ-intrinsic Euler angles and the 6D
representation, on tensors [..., k], from the MANO modules' functions.
"""

from __future__ import annotations

import torch

from keypointfusion_torch.geometry.camera import (
    points_3d_to_img, points_img_to_3d,
)
from keypointfusion_torch.mano.mano_head import (
    mat_to_aa, mat_to_quat, quat_to_aa, rot6d_to_mat,
)
from keypointfusion_torch.mano.manolayer import batch_rodrigues, quat_to_rotmat

__all__ = [
    'axis_angle_to_matrix', 'matrix_to_axis_angle', 'quaternion_to_matrix',
    'matrix_to_quaternion', 'quaternion_to_axis_angle',
    'axis_angle_to_quaternion', 'rot6d_to_matrix', 'matrix_to_rot6d',
    'euler_to_matrix', 'matrix_to_euler', 'batch_xyz_to_uvd',
    'batch_uvd_to_xyz',
]

axis_angle_to_matrix = batch_rodrigues
matrix_to_axis_angle = mat_to_aa
quaternion_to_matrix = quat_to_rotmat
matrix_to_quaternion = mat_to_quat
quaternion_to_axis_angle = quat_to_aa
rot6d_to_matrix = rot6d_to_mat


def axis_angle_to_quaternion(aa):
    """[..., 3] -> [..., 4], with batch_rodrigues's +1e-8 in the norm."""
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def matrix_to_rot6d(m):
    """The first two columns, flattened (the inverse of rot6d_to_mat,
    which stacks b1, b2, b3 as columns)."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def _stack33(*entries):
    return torch.stack(entries, -1).reshape(entries[0].shape + (3, 3))


def euler_to_matrix(euler):
    """XYZ-intrinsic Euler angles [..., 3] -> Rz @ Ry @ Rx."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one, zero = torch.ones_like(cx), 0 * cx
    rx = _stack33(one, zero, zero, zero, cx, -sx, zero, sx, cx)
    ry = _stack33(cy, zero, sy, zero, one, zero, -sy, zero, cy)
    rz = _stack33(cz, -sz, zero, sz, cz, zero, zero, zero, one)
    return rz @ ry @ rx


def matrix_to_euler(m):
    """The inverse of euler_to_matrix, sin(y) clamped to [-1, 1]."""
    y = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
    x = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    z = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


def batch_xyz_to_uvd(xyz, cam_para, flip: float = 1.0):
    """Camera-space mm [B,N,3] -> pixel uvd, cam_para [B,4] (fx, fy, fu,
    fv)."""
    return points_3d_to_img(xyz, cam_para[:, 0], cam_para[:, 1],
                            cam_para[:, 2], cam_para[:, 3], flip)


def batch_uvd_to_xyz(uvd, cam_para, flip: float = 1.0):
    """Pixel uvd [B,N,3] -> camera-space mm, cam_para [B,4]."""
    return points_img_to_3d(uvd, cam_para[:, 0], cam_para[:, 1],
                            cam_para[:, 2], cam_para[:, 3], flip)


class Compose:
    """Transforms applied in sequence."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x
