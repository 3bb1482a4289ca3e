"""KPFusion: the dual-backbone RGB-D keypoint fusion model, eval path
(port of keypointfusion_tpu/models/kpfusion.py).

Outputs follow the reference's `result` list,
[img_offset, img_offset_rgb, b1_3d, b1_2d, b2_3d, b2_2d], aligned with the
reference config's stage_type = (1,1,2,3,2,3), plus one spatial-weight map
per block.

Precision policy (the JAX module's): `dtype` is the fusion head's compute
dtype and `backbone_dtype` (None: `dtype`) the backbones'; parameters and
BatchNorm statistics stay float32 (models/layers.py). A float32 head runs
K1 and K2 in their exact 'highest' modes, any other dtype in their
'default' serving modes (bfloat16 features and sampled maps).

`use_kernels` is the meaning of the JAX flags use_pallas_sampler and
use_pallas_desa together: True sends the point->pixel sampling through
kernels/pixel_sampler.py (K2, once per forward) and each block's DESA
through kernels/desa_dense.py (K1, once per block). On CUDA tensors those
launch the CUDA kernels; on CPU tensors they run their plain versions.
False runs the kernels' plain versions on any device; that is how
chip_smoke.py compares the two on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from keypointfusion_torch.config import Config
from keypointfusion_torch.geometry.camera import CropFrame, uvd_nl_to_xyz_nl
from keypointfusion_torch.geometry.grid import img_uvd_points
from keypointfusion_torch.kernels.pixel_sampler import (
    sample_pixel_features_fused, sample_pixel_features_plain,
)
from keypointfusion_torch.models.fusion_block import FusionBlock
from keypointfusion_torch.models.layers import set_compute_dtype
from keypointfusion_torch.models.unet import ResNetUNet
from keypointfusion_torch.ops.codecs import offset_to_joint_weight
from keypointfusion_torch.ops.resize import resize_nearest_torch
from keypointfusion_torch.utils.device import resolve_device


class KPFusion(nn.Module):
    def __init__(self, net: str = 'KPFusion-resnet-18', joint_num: int = 21,
                 num_stages: int = 2, dim: int = 128,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32,
                 backbone_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if 'resnet' not in net:
            raise NotImplementedError(f'{net}: only ResNet backbones are '
                                      'ported so far')
        depth = int(net.split('-')[-1])
        j = joint_num
        self.joint_num = j
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.backbone_dtype = backbone_dtype or dtype
        out_dims = (3 * j, j, j)
        self.backbone_d = ResNetUNet(1, depth, dim, out_dims)
        self.backbone_rgb = ResNetUNet(3, depth, dim, out_dims)
        set_compute_dtype(self.backbone_d, self.backbone_dtype)
        set_compute_dtype(self.backbone_rgb, self.backbone_dtype)
        self.num_stages = num_stages
        for i in range(num_stages):
            setattr(self, f'block{i + 1}',
                    set_compute_dtype(FusionBlock(j, dim), dtype))

    def forward(self, rgb, depth, pcl, frame: CropFrame,
                kernel: float = 0.8):
        """rgb [B,S,S,3], depth [B,S,S,1] (normalized crop, background 1),
        pcl [B,N,3] normalized xyz. Returns (results, spatial_weights)."""
        if self.training:
            raise NotImplementedError('KPFusion train mode is not ported; '
                                      'call .eval()')
        j = self.joint_num
        dt, bb = self.dtype, self.backbone_dtype
        img_offset, img_feat = (
            t.to(dt) for t in self.backbone_d(depth.to(bb)))
        img_offset_rgb, img_feat_rgb = (
            t.to(dt) for t in self.backbone_rgb(rgb.to(bb)))
        b, h = img_feat.shape[0], img_feat.shape[1]

        joint_uvd = offset_to_joint_weight(img_offset, depth, kernel)
        weight_map = img_offset[..., 4 * j:5 * j]
        img_down = resize_nearest_torch(depth, h)
        joint_xyz = uvd_nl_to_xyz_nl(joint_uvd, frame)

        # one sampling pass serves both blocks (the maps do not change
        # between stages)
        maps = torch.cat([img_feat, img_feat_rgb, weight_map], dim=-1)
        flat = maps.reshape(b, h * h, -1)
        img_xyz = uvd_nl_to_xyz_nl(img_uvd_points(img_down), frame)
        sampler = sample_pixel_features_fused if self.use_kernels \
            else sample_pixel_features_plain
        sampled = sampler(pcl.contiguous(), img_xyz, flat, k=4,
                          mode='highest' if dt == torch.float32
                          else 'default')

        results = [img_offset, img_offset_rgb]
        spatial_weights = []
        updated: Optional[torch.Tensor] = None
        for i in range(self.num_stages):
            refined_3d, refined_2d, updated, sw = getattr(
                self, f'block{i + 1}')(
                img_feat, img_feat_rgb, pcl, joint_xyz, sampled, updated,
                frame, img_down, kernel, self.use_kernels)
            results += [refined_3d, refined_2d]
            spatial_weights.append(sw)
            joint_xyz = refined_2d
        return tuple(results), tuple(spatial_weights)


def build_kpfusion(cfg: Config = Config(), device=None, seed: int = 0,
                   use_kernels: bool = True,
                   dtype: Optional[torch.dtype] = None) -> KPFusion:
    """The model factory: a KPFusion in eval mode with weights drawn from
    `seed` (the process's global RNG is left as it was), on the CUDA card
    unless `device` names another. `dtype` sets the whole model's compute
    dtype; None takes cfg.compute_dtype."""
    device = resolve_device(device)
    if dtype is None:
        dtype = getattr(torch, cfg.compute_dtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = KPFusion(cfg.net, cfg.joint_num, use_kernels=use_kernels,
                         dtype=dtype)
    return model.eval().to(device)
