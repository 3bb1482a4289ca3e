"""KFAM fusion block: one stage of cross-modal keypoint refinement
(port of keypointfusion_tpu/models/fusion_block.py).

The spatial gate is strictly positive, so relu(gate * feat) ==
gate * relu(feat) and the per-joint spatial pooling
    img_feat_j[b,j,c] = FC_hw(relu(gate[b,j,hw] * feat[b,hw,c]))
is one product (gate * w_fc) @ relu(feat), with no [B,J,C,H,W] tensor.

In a bfloat16 block the values change dtype where the JAX block's do: the
sampled features and every Dense are in the compute dtype, the gate is
float32 (its float32 parameters promote it), so the pooled img_feat_j is
float32 and the cross decoder's query with it.

No gradient flows into the point-joint encoding, the sampled weight
channels or the joint estimate the block starts from (the JAX block's
stop_gradients); it does flow through the block's own refined_3d into
the heatmap and the geometry map.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from keypointfusion_torch.geometry.camera import CropFrame
from keypointfusion_torch.geometry.pcl import img_to_anchor_dis
from keypointfusion_torch.models.desa import DESA
from keypointfusion_torch.models.layers import cast_param, linear
from keypointfusion_torch.models.norm import TorchBatchNorm
from keypointfusion_torch.models.resnet import init_conv
from keypointfusion_torch.models.transformer import (
    CrossDecoder, KPInteraction,
)
from keypointfusion_torch.ops.codecs import (
    joint_to_heatmap, pcl_joint_to_offset,
)


class EmbedBN(nn.Sequential):
    """The reference's Conv1d(k=1) + BatchNorm1d, on channels-last tokens
    [B,N,Cin] -> [B,N,dim] (BN over batch x tokens)."""
    compute_dtype = torch.float32

    def __init__(self, in_dim: int, dim: int):
        conv = nn.Conv1d(in_dim, dim, 1)
        nn.init.normal_(conv.weight, std=0.001)
        nn.init.zeros_(conv.bias)
        super().__init__(conv, TorchBatchNorm(dim))

    def forward(self, x):
        conv, bn = self[0], self[1]
        dt = self.compute_dtype
        weight = cast_param(self, 'weight', conv.weight[..., 0], dt)
        return bn(linear(x, weight, cast_param(self, 'bias', conv.bias, dt),
                         dt))


class FusionBlock(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, joint_num: int = 21, dim: int = 128,
                 feature_size: int = 32, dropout: float = 0.1):
        super().__init__()
        j = joint_num
        self.pcl_feat_emb = EmbedBN(dim, dim)
        self.pcl_xyz_emb = EmbedBN(3, dim)
        self.pcl_pose_emb = EmbedBN(5 * j, dim)
        self.pcl_feat_emb_RGB = EmbedBN(dim, dim)
        self.joint_feat_emb = EmbedBN(dim, dim)
        self.joint_xyz_emb = EmbedBN(3, dim)
        self.FA = DESA(dim, (128, 128), (64, 64, 64), (0.1, 0.2, 0.4))
        self.init_TR = KPInteraction(hidden=dim, img_dim=dim,
                                     dropout=dropout)
        self.atten_spatial = nn.Conv2d(dim + j, j, 1)
        init_conv(self.atten_spatial)
        self.weight_dis = nn.Parameter(torch.zeros(1))
        self.fc_spatial2joint_feature = nn.Linear(feature_size ** 2, 1)
        nn.init.normal_(self.fc_spatial2joint_feature.weight, std=0.001)
        nn.init.zeros_(self.fc_spatial2joint_feature.bias)
        self.crossTR = CrossDecoder(hidden=dim, joint_num=j,
                                    dropout=dropout)
        self.final_TR = KPInteraction(hidden=dim, img_dim=dim + 3,
                                      dropout=dropout)

    def forward(self, img_feat, img_feat_rgb, pcl, joint_xyz, sampled,
                updated_2d_feature: Optional[torch.Tensor],
                frame: CropFrame, img_down, kernel: float = 0.8,
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None):
        """img_feat / img_feat_rgb [B,H,W,C]; pcl [B,N,3]; joint_xyz
        [B,J,3]; sampled [B,N,2C+J] = [img_feat | img_feat_rgb | weight
        map] at each cloud point (sampled once per forward in KPFusion);
        updated_2d_feature [B,J,C] or None; img_down [B,H,W,1];
        generator: the transformers' dropout masks in train mode.

        Returns (refined_3d [B,J,3], refined_2d [B,J,3], img_feat_j
        [B,J,C], spatial_weight [B,H,W,J])."""
        b, h, w, c = img_feat.shape
        dt = self.compute_dtype
        joint_xyz = joint_xyz.detach()
        pcl_offset_xyz = pcl_joint_to_offset(joint_xyz, pcl, kernel).detach()
        pcl_feat = sampled[..., :c].to(dt)
        pcl_feat_rgb = sampled[..., c:2 * c].to(dt)
        pcl_weight = sampled[..., 2 * c:].to(dt).detach()

        pose = torch.cat([pcl_weight, pcl_offset_xyz], dim=-1)
        pcl_feat = torch.relu(self.pcl_feat_emb(pcl_feat)
                              + self.pcl_xyz_emb(pcl)
                              + self.pcl_pose_emb(pose))
        pcl_feat = torch.relu(pcl_feat + self.pcl_feat_emb_RGB(pcl_feat_rgb))

        attention = torch.softmax(pcl_weight.transpose(1, 2), dim=-1)
        joint_feat = attention @ pcl_feat
        joint_feat = torch.relu(self.joint_feat_emb(joint_feat)
                                + self.joint_xyz_emb(joint_xyz))
        joint_feat = self.FA(pcl_feat, joint_feat, pcl, joint_xyz,
                             use_kernel=use_kernels)

        init_seq, refined_3d = self.init_TR(joint_feat, generator)

        hm = joint_to_heatmap(refined_3d[..., :2], kernel, h, sigma=1.0)
        gam = img_to_anchor_dis(refined_3d, img_down, frame)  # [B,H,W,J]
        att = self.atten_spatial
        spatial_weight = torch.sigmoid(linear(
            torch.cat([img_feat_rgb, hm], dim=-1),
            cast_param(self, 'att_weight', att.weight[:, :, 0, 0], dt),
            cast_param(self, 'att_bias', att.bias, dt), dt))
        weight_dis = torch.sigmoid(self.weight_dis)
        gate = weight_dis * gam + (1.0 - weight_dis) * spatial_weight
        fc = self.fc_spatial2joint_feature
        gated_w = (gate.reshape(b, h * w, -1)
                   * fc.weight.t()).transpose(1, 2)           # [B,J,HW]
        relu_feat = torch.relu(img_feat_rgb).reshape(b, h * w, c).to(
            gated_w.dtype)
        img_feat_j = gated_w @ relu_feat + fc.bias
        if updated_2d_feature is not None:
            img_feat_j = torch.relu((img_feat_j + updated_2d_feature) / 2.0)

        cross = self.crossTR(img_feat_j, init_seq, generator)
        _, refined_2d = self.final_TR(torch.cat([refined_3d, cross], dim=-1),
                                      generator)
        return refined_3d, refined_2d, img_feat_j, spatial_weight
