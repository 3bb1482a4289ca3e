"""The differentiable MANO hand layer (port of
keypointfusion_tpu/mano/manolayer.py).

`ManoLayer` puts a MANO asset's arrays on the device once, as buffers
(not in its state_dict), with the index tables of the kinematic chain, so
that `mano_forward` copies nothing from the host: shape blend, pose blend,
the 3-level kinematic chain of the five fingers batched as [B,5,4,4], and
linear blend skinning. The products are float32 einsums; JAX pins them to
Precision.HIGHEST, so run them with TF32 off (PyTorch's default for
matmuls, torch.backends.cuda.matmul.allow_tf32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keypointfusion_torch.mano.assets import ManoModel
from keypointfusion_torch.utils.device import resolve_device

# finger chain levels: the first, second and third joint of each finger
_LEV1 = np.array([1, 4, 7, 10, 13])
_LEV2 = np.array([2, 5, 8, 11, 14])
_LEV3 = np.array([3, 6, 9, 12, 15])
# transforms reordered after concatenating [root, lev1, lev2, lev3]
_REORDER = np.array([0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15])
# MANO joints + 5 tips -> the visualization order
_JOINT_ORDER = np.array([0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
                         10, 11, 12, 19, 7, 8, 9, 20])
# the visualization order -> the order of the MANO head's outputs
OBMAN2MANO = [0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3,
              8, 12, 20, 16, 4]


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z), normalized first -> [..., 3, 3]."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] through quaternions, with the
    reference's +1e-8 inside the angle's norm (a zero rotation stays
    finite)."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def _with_zeros(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] + [..., 3] -> [..., 4, 4] homogeneous transforms."""
    top = torch.cat([rot, trans[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=rot.dtype,
                         device=rot.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


class ManoLayer(nn.Module):
    """A MANO asset on the device: its arrays (float32) and index tables
    as buffers outside the state_dict, made once. On the CUDA card unless
    `device` names another."""

    def __init__(self, model: ManoModel, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_verts = model.v_template.shape[0]
        arrays = {
            'v_template': model.v_template, 'shapedirs': model.shapedirs,
            'posedirs': model.posedirs, 'J_regressor': model.J_regressor,
            'weights': model.weights,
            'hands_components': model.hands_components,
            'hands_mean': model.hands_mean,
            'tips': np.asarray(model.tip_vertex_ids), 'lev1': _LEV1,
            'lev2': _LEV2, 'lev3': _LEV3, 'reorder': _REORDER,
            'joint_order': _JOINT_ORDER, 'obman2mano': OBMAN2MANO}
        for name, a in arrays.items():
            a = np.asarray(a)
            t = torch.from_numpy(a.astype(np.float32) if a.dtype.kind == 'f'
                                 else a.astype(np.int64))
            self.register_buffer(name, t.to(device), persistent=False)

    def forward(self, *args, **kwargs):
        return mano_forward(self, *args, **kwargs)


def mano_forward(layer: ManoLayer,
                 pose_coeffs: Optional[torch.Tensor],
                 betas: Optional[torch.Tensor] = None,
                 trans: Optional[torch.Tensor] = None,
                 ncomps: int = 45,
                 use_pca: bool = True,
                 flat_hand_mean: bool = True,
                 center_idx: Optional[int] = None,
                 pose_rotmats: Optional[torch.Tensor] = None):
    """MANO linear blend skinning on `layer`'s device.

    pose_coeffs [B, 3 + ncomps]: the global axis-angle (3), then PCA
    coefficients (use_pca) or the 15 joints' axis-angles (ncomps=45,
    use_pca=False); ignored when pose_rotmats [B,16,3,3] is given (the
    rotation-matrix mode of mano_head.ManoRegHead). betas [B,10] (None:
    the template shape); trans [B,3] in metres (None: centred on joint
    `center_idx` when that is given). flat_hand_mean=False adds the
    asset's mean pose.

    Returns (verts [B,778,3], joints [B,21,3]) in millimetres."""
    if pose_rotmats is not None:
        batch = pose_rotmats.shape[0]
        root_rot = pose_rotmats[:, 0]
        rot_map = pose_rotmats[:, 1:]                         # [B,15,3,3]
    else:
        batch = pose_coeffs.shape[0]
        hand_coeffs = pose_coeffs[:, 3:3 + ncomps]
        if use_pca:
            full_hand_pose = hand_coeffs @ layer.hands_components[:ncomps]
        else:
            full_hand_pose = hand_coeffs
        if not flat_hand_mean:
            full_hand_pose = full_hand_pose + layer.hands_mean
        all_aa = torch.cat([pose_coeffs[:, :3], full_hand_pose],
                           dim=1).reshape(batch, 16, 3)
        rots = batch_rodrigues(all_aa)                        # [B,16,3,3]
        root_rot = rots[:, 0]
        rot_map = rots[:, 1:]
    v = layer.num_verts
    eye = torch.eye(3, dtype=rot_map.dtype, device=rot_map.device)
    pose_map = (rot_map - eye).reshape(batch, 135)

    # shape blend and joint regression
    if betas is None:
        v_shaped = layer.v_template.expand(batch, v, 3)
    else:
        v_shaped = torch.einsum('vct,bt->bvc', layer.shapedirs, betas) \
            + layer.v_template
    th_j = torch.einsum('jv,bvc->bjc', layer.J_regressor, v_shaped)

    # pose blend
    v_posed = v_shaped + torch.einsum('vcp,bp->bvc', layer.posedirs,
                                      pose_map)

    # the kinematic chain, a level of the five fingers at a time
    root_j = th_j[:, 0]
    root_t = _with_zeros(root_rot, root_j)                    # [B,4,4]
    j1, j2, j3 = (th_j[:, lev] for lev in (layer.lev1, layer.lev2,
                                           layer.lev3))
    lev1_rel = _with_zeros(rot_map[:, layer.lev1 - 1], j1 - root_j[:, None])
    lev2_rel = _with_zeros(rot_map[:, layer.lev2 - 1], j2 - j1)
    lev3_rel = _with_zeros(rot_map[:, layer.lev3 - 1], j3 - j2)
    lev1_t = torch.einsum('bij,bfjk->bfik', root_t, lev1_rel)
    lev2_t = torch.einsum('bfij,bfjk->bfik', lev1_t, lev2_rel)
    lev3_t = torch.einsum('bfij,bfjk->bfik', lev2_t, lev3_rel)
    transforms = torch.cat([root_t[:, None], lev1_t, lev2_t, lev3_t],
                           dim=1)[:, layer.reorder]

    # transforms relative to the rest joints
    j_h = F.pad(th_j, (0, 1))
    shifted = torch.einsum('bjik,bjk->bji', transforms, j_h)  # [B,16,4]
    rel = transforms - F.pad(shifted[..., None], (3, 0))

    # skinning
    T = torch.einsum('bjik,vj->bvik', rel, layer.weights)     # [B,V,4,4]
    v_h = F.pad(v_posed, (0, 1), value=1.0)
    verts = torch.einsum('bvik,bvk->bvi', T, v_h)[..., :3]

    joints = transforms[:, :, :3, 3]                          # [B,16,3]
    tips = verts[:, layer.tips]
    joints = torch.cat([joints, tips], dim=1)[:, layer.joint_order]

    if trans is not None:
        verts = verts + trans[:, None]
        joints = joints + trans[:, None]
    elif center_idx is not None:
        center = joints[:, center_idx:center_idx + 1]
        verts = verts - center
        joints = joints - center

    return verts * 1000.0, joints * 1000.0
