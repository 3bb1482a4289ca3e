"""Evaluation metrics (port of keypointfusion_tpu/training/metrics.py): the
joint error in millimetres, the Procrustes-aligned error through one
batched SVD on the batch's device, and the AUC of the PCK curve (numpy,
on the host).
"""

from __future__ import annotations

import numpy as np
import torch

# the NYU protocol's 14 of its 23 joints
NYU_SUBSET = (0, 2, 4, 6, 8, 10, 12, 14, 16, 17, 18, 21, 22, 20)

# np.trapezoid is numpy >= 2's name of np.trapz
_trapezoid = getattr(np, 'trapezoid', None) or np.trapz


def xyz_to_error_mm(pred_xyz, gt_xyz, center, cube,
                    nyu_subset: bool = False) -> torch.Tensor:
    """Per-joint L2 error in mm after the crop's denormalization.
    pred/gt [..., B, J, 3] normalized xyz, center/cube [B, 3]. Returns
    [..., B, J] ([..., B, 14] for the NYU subset of 23 joints)."""
    center = center[:, None, :]
    half_cube = cube[:, None, :] / 2.0
    pred_mm = pred_xyz * half_cube + center
    gt_mm = gt_xyz * half_cube + center
    err = torch.sum((pred_mm - gt_mm) ** 2, dim=-1)
    if nyu_subset and pred_xyz.shape[-2] == 23:
        err = err[..., list(NYU_SUBSET)]
    return torch.sqrt(err)


def rigid_align(A, B) -> torch.Tensor:
    """Similarity Procrustes, batched: A [..., N, 3] aligned to B (scale,
    rotation, translation), the reflection fixed by the sign of
    det(V U^T). One torch.linalg.svd on the inputs' device."""
    n = A.shape[-2]
    cA = A.mean(-2, keepdim=True)
    cB = B.mean(-2, keepdim=True)
    H = (A - cA).transpose(-1, -2) @ (B - cB) / n
    U, s, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    sign = torch.where(torch.linalg.det(V @ U.transpose(-1, -2)) < 0,
                       -1.0, 1.0)
    flip = torch.ones_like(s)
    flip[..., -1] = sign
    s = s * flip
    R = (V * flip[..., None, :]) @ U.transpose(-1, -2)
    var_a = A.var(-2, unbiased=False).sum(-1)
    c = s.sum(-1) / var_a
    t = cB[..., 0, :] - c[..., None] * (R @ cA[..., 0, :, None])[..., 0]
    return c[..., None, None] * (A @ R.transpose(-1, -2)) + t[..., None, :]


def pa_error_mm(pred_xyz, gt_xyz, center, cube) -> torch.Tensor:
    """The Procrustes-aligned per-joint error in mm: the alignment on the
    normalized coordinates, as the reference does it."""
    return xyz_to_error_mm(rigid_align(pred_xyz, gt_xyz), gt_xyz, center,
                           cube)


def pck_curve(errors_mm: np.ndarray, val_min=0.0, val_max=50.0, steps=20):
    """errors_mm [samples, J] -> (auc, curve [steps], thresholds): the
    trapezoid AUC of each keypoint's PCK curve, averaged over keypoints;
    thresholds in mm."""
    thresholds = np.linspace(val_min, val_max, steps)
    norm = _trapezoid(np.ones_like(thresholds), thresholds)
    pck = (errors_mm[None, :, :] <= thresholds[:, None, None]).mean(1)
    auc_per_kp = _trapezoid(pck, thresholds, axis=0) / norm
    return float(auc_per_kp.mean()), pck.mean(-1), thresholds


def auc_subset(curve: np.ndarray, thresholds: np.ndarray,
               min_mm: float = 20.0) -> float:
    """The AUC of the curve's tail from min_mm (20-50 mm), its start
    found on the threshold grid."""
    start = int(np.searchsorted(thresholds, min_mm))
    x, y = thresholds[start:], curve[start:]
    return float(_trapezoid(y, x) / _trapezoid(np.ones_like(y), x))
