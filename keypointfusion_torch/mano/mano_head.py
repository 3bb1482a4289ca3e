"""The MANO regression head and rotation conversions (port of
keypointfusion_tpu/mano/mano_head.py).

`ManoRegHead` maps a feature vector to 16 rotations (6D) and 10 shape
coefficients, and the rotation matrices go straight into
mano_forward(pose_rotmats=...), as in the JAX module: no round trip
through axis-angles in the gradient's path (the axis-angle pose is still
returned). The reference defines this head but never wires it into
KPFusion; so does the port.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keypointfusion_torch.mano.assets import ManoModel
from keypointfusion_torch.mano.manolayer import (  # noqa: F401
    OBMAN2MANO, ManoLayer, mano_forward,   # OBMAN2MANO: the head's order
)
from keypointfusion_torch.utils.device import resolve_device

# the head's fingertip vertices (not manolayer's tips)
FINGERTIP_VERTEX_IDX = [728, 353, 442, 576, 694]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


def rot6d_to_mat(x: torch.Tensor) -> torch.Tensor:
    """6D rotations [..., 6] -> matrices [..., 3, 3] by Gram-Schmidt; the
    two 3-vectors become the first two columns."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = _unit(a1)
    b2 = _unit(a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> quaternions (w, x, y, z) without
    branches: of the four candidates, each the quaternion scaled by 4 q_k
    for one component k, the one whose k is dominant (argmax over
    [trace, m00, m11, m22], the first among equals) is normalized."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    q1 = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], -1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22,
                      m12 + m21], -1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1 - m00 - m11 + m22], -1)
    cand = torch.stack([q0, q1, q2, q3], -2)                  # [..., 4, 4]
    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    return _unit(q)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) [..., 4] -> axis-angles [..., 3]."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], w)
    return xyz / torch.clamp_min(norm, 1e-8) * angle[..., None]


def mat_to_aa(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angles [..., 3]."""
    return quat_to_aa(mat_to_quat(m))


def extended_joint_regressor(model: ManoModel) -> np.ndarray:
    """The asset's J_regressor [16,778] and one-hot rows of the five
    fingertip vertices -> [21,778]."""
    onehots = np.zeros((5, model.J_regressor.shape[1]), np.float32)
    for i, v in enumerate(FINGERTIP_VERTEX_IDX):
        onehots[i, v] = 1.0
    return np.concatenate([model.J_regressor, onehots], 0)


def _flax_dense(fan_in: int, fan_out: int) -> nn.Linear:
    """nn.Linear drawn as flax's Dense is: lecun_normal weights (a normal
    truncated at 2 sigma, its std corrected to 1/sqrt(fan_in)), zero
    bias."""
    layer = nn.Linear(fan_in, fan_out)
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


class ManoRegHead(nn.Module):
    """features [B, feature_size] -> MANO pose (16 x 6D) and shape, then
    the mesh and joints. Parameters: base_0, base_1 (one per entry of
    `neurons`, leaky ReLU 0.01 after each), pose_reg and shape_reg, the
    flax module's names. `model` is a ManoModel (put on the device here)
    or a ManoLayer; on the CUDA card unless `device` names another."""

    def __init__(self, model, feature_size: int = 1024,
                 neurons: Sequence[int] = (1024, 512), device=None):
        super().__init__()
        device = resolve_device(device)
        self.mano = model if isinstance(model, ManoLayer) \
            else ManoLayer(model, device)
        widths = (feature_size, *neurons)
        for i in range(len(neurons)):
            setattr(self, f'base_{i}', _flax_dense(widths[i], widths[i + 1]))
        self.num_base = len(neurons)
        self.pose_reg = _flax_dense(widths[-1], 16 * 6)
        self.shape_reg = _flax_dense(widths[-1], 10)
        self.to(device)

    def forward(self, features: torch.Tensor) -> dict:
        x = features
        for i in range(self.num_base):
            x = F.leaky_relu(getattr(self, f'base_{i}')(x), 0.01)
        pose6d = self.pose_reg(x)
        shape = self.shape_reg(x)
        rotmats = rot6d_to_mat(pose6d.reshape(-1, 16, 6))     # [B,16,3,3]
        pose_aa = mat_to_aa(rotmats).reshape(-1, 48)
        verts, joints = mano_forward(self.mano, None, betas=shape,
                                     pose_rotmats=rotmats)
        return {
            'verts3d': verts,
            'joints3d': joints[:, self.mano.obman2mano],
            'mano_shape': shape,
            'mano_pose': rotmats,
            'mano_pose_aa': pose_aa,
        }


def gt_mesh_from_mano_params(layer: ManoLayer, gt_mano_params, center,
                             cube):
    """Ground-truth mesh from a dataset's MANO parameters [B,61]
    (axis-angle pose 48, shape 10, translation 3): through the camera flip
    diag(1, -1, -1), then normalized by center [B,3] and cube [B,3] as the
    crops are."""
    pose = gt_mano_params[:, :48]
    shape = gt_mano_params[:, 48:58]
    trans = gt_mano_params[:, 58:61]
    verts, joints = mano_forward(layer, pose, betas=shape, trans=trans,
                                 use_pca=False, ncomps=45)
    flip = torch.ones(3, dtype=verts.dtype, device=verts.device)
    flip[1:] = -1.0
    joints = joints * flip
    verts = verts * flip
    joints = (joints - center[:, None]) / cube[:, None] * 2
    verts = (verts - center[:, None]) / cube[:, None] * 2
    return {'verts3d': verts, 'joints3d': joints[:, layer.obman2mano],
            'mano_shape': shape}
