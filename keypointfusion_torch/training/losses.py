"""Per-stage loss assembly (port of keypointfusion_tpu/training/losses.py).

stage_type semantics (Config.stage_type):
  1 -- dense pixel stage: the loss on the dense map's first channels
       against the GT encoding (deconv_weight) plus the loss on the decoded
       joints against the uvd GT (coord_weight);
  2/3 -- KFAM joint stages: the loss on the xyz joints against the xyz GT
       (coord_weight);
  0 -- no loss, as in the reference's train loop.
Spatial-weight maps are supervised with gaussians over their global max,
sigma 3 for block 1 and 2 for block 2, gated by epoch <= spatial_epoch.
The max is the batch's: under global-batch statistics (a process group
passed as `group`) the whole global batch's, as the JAX mesh step's
GSPMD reduction takes it; per-shard, each rank's own.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from keypointfusion_torch.config import Config
from keypointfusion_torch.geometry.camera import CropFrame, uvd_nl_to_xyz_nl
from keypointfusion_torch.ops.codecs import joint_to_heatmap
from keypointfusion_torch.ops.codecs_extra import (
    feature_to_joint, joint_to_feature,
)
from keypointfusion_torch.ops.loss import smooth_l1_loss
from keypointfusion_torch.parallel.mesh import all_max


def elementwise_loss(cfg: Config):
    """loss_type: 'L1Loss' is smooth_l1_loss, 'Mse' the mean squared
    error (the reference binds smooth-L1 whatever it is set to; the JAX
    package honours 'Mse', and so does the port)."""
    if cfg.loss_type == 'L1Loss':
        return smooth_l1_loss
    if cfg.loss_type == 'Mse':
        return lambda pred, gt: torch.mean((pred - gt) ** 2)
    raise NotImplementedError(
        f'loss_type={cfg.loss_type!r} (the reference defines no GHM loss)')


def _stage_error_mm(pred_xyz, xyz_gt, frame: CropFrame) -> torch.Tensor:
    """The mean euclidean joint error in mm after the cube/2
    denormalization (telemetry: no gradient)."""
    d = (pred_xyz - xyz_gt).detach() * (frame.cube[:, None, :] / 2.0)
    return torch.mean(torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12))


def compute_losses(results: Sequence[torch.Tensor],
                   spatial_weights: Sequence[torch.Tensor],
                   depth: torch.Tensor, uvd_gt: torch.Tensor,
                   xyz_gt: torch.Tensor, frame: CropFrame, cfg: Config,
                   epoch, group=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of KPFusion's results [img_offset,
    img_offset_rgb, b1_3d, b1_2d, b2_3d, b2_2d] and spatial weights, as
    the JAX function assembles them. epoch: an int or a 0-dim tensor.
    group: the process group whose ranks' rows make the batch (None:
    this process's rows)."""
    kernel = cfg.feature_para[0]
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    feature_size = results[0].shape[1]
    loss_fn = elementwise_loss(cfg)

    pixel_gt = None
    for index, stage in enumerate(cfg.stage_type):
        if stage == 1:
            pixel_pd = results[index]                       # [B,fs,fs,5J]
            if pixel_gt is None:
                pixel_gt = joint_to_feature(uvd_gt, depth, cfg.feature_para,
                                            feature_size, cfg.feature_type)
            joint_uvd = feature_to_joint(depth, pixel_pd, cfg.feature_type,
                                         cfg.feature_para,
                                         joint_num=uvd_gt.shape[1])
            # the prediction sliced to the GT's channels, as the reference
            loss_pixel = loss_fn(pixel_pd[..., :pixel_gt.shape[-1]],
                                 pixel_gt) * cfg.deconv_weight
            loss_coord = loss_fn(joint_uvd, uvd_gt) * cfg.coord_weight
            total = total + loss_pixel + loss_coord
            metrics[f'loss_pixel_{index}'] = loss_pixel
            metrics[f'loss_coord_{index}'] = loss_coord
            metrics[f'error_{index}'] = _stage_error_mm(
                uvd_nl_to_xyz_nl(joint_uvd, frame), xyz_gt, frame)
        elif stage in (2, 3):
            joint_xyz = results[index]
            loss_coord = loss_fn(joint_xyz, xyz_gt) * cfg.coord_weight
            total = total + loss_coord
            metrics[f'loss_coord_{index}'] = loss_coord
            metrics[f'error_{index}'] = _stage_error_mm(joint_xyz, xyz_gt,
                                                        frame)

    for index, sw in enumerate(spatial_weights):
        sigma = 3.0 if index == 0 else 2.0
        hm_gt = joint_to_heatmap(uvd_gt[..., :2], kernel, feature_size,
                                 sigma=sigma)
        sw_gt = hm_gt / all_max(torch.max(hm_gt), group)    # global max
        on = epoch <= cfg.spatial_epoch[index]
        gate = on.float() if torch.is_tensor(on) else float(on)
        loss_sw = loss_fn(sw, sw_gt) * cfg.spatial_weight[index] * gate
        total = total + loss_sw
        metrics[f'loss_spatial_{index}'] = loss_sw

    metrics['loss'] = total
    return total, metrics
