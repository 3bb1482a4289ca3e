"""The single-backbone RGB-D encoder family, off the flagship path (port
of keypointfusion_tpu/models/rgbd_fusion.py; the reference's
model/fusion_layer.py, model/resnet.py:256-502 and
model/resnetUnet.py:659-751): channel-filter fusion layers, a dual-path
ResNet that merges its RGB and depth streams after every stage, and a
UNet head over the merges.

The reference's quirk is kept: a dual-path block's ONE downsample
projection (conv and BatchNorm) serves both streams, so in train mode
its running statistics move twice a call, RGB first. RGBDResNet and
RGBDResNetUNet take NHWC images and return NHWC maps as the JAX modules
do; the blocks and fusion layers work in NCHW. The UNet head's
Residuals and final convs are the port's (models/unet.py), with their
torch names; the other parameters are named after the JAX module tree
(`backbone.layer1.0.depth_conv1`, `backbone.rgbd_fusion_0.gate_rgb`,
...): the reference's names could not be read, so a reference .pth of
this family will need a key map.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from keypointfusion_torch.models.layers import Conv2d, Linear
from keypointfusion_torch.models.norm import BatchNorm2d
from keypointfusion_torch.models.resnet import STAGES, init_conv
from keypointfusion_torch.models.unet import Residual, final_convs
from keypointfusion_torch.ops.resize import upsample_bilinear_x2


class FilterLayer(nn.Module):
    """SE-style global channel filter (fusion_layer.py:6-22): [B,C,H,W]
    -> sigmoid weights [B,out_planes,1,1]."""

    def __init__(self, in_planes: int, out_planes: int,
                 reduction: int = 16):
        super().__init__()
        self.fc1 = Linear(in_planes, out_planes // reduction)
        self.fc2 = Linear(out_planes // reduction, out_planes)

    def forward(self, x):
        y = self.fc2(torch.relu(self.fc1(x.mean((2, 3)))))
        return torch.sigmoid(y)[:, :, None, None]


class FSP(nn.Module):
    """Feature Separation Part (fusion_layer.py:28-37): main + w * guide,
    w from both paths' channels."""

    def __init__(self, in_planes: int, out_planes: int,
                 reduction: int = 16):
        super().__init__()
        self.filter = FilterLayer(in_planes, out_planes, reduction)

    def forward(self, guide_path, main_path):
        w = self.filter(torch.cat([guide_path, main_path], dim=1))
        return main_path + w * guide_path


class RGBDFusion(nn.Module):
    """Softmax-gated two-stream merge (fusion_layer.py:40-83). Returns
    ((rgb_out, depth_out), merge)."""

    def __init__(self, planes: int):
        super().__init__()
        self.gate_rgb = Conv2d(2 * planes, 1, 1)
        self.gate_depth = Conv2d(2 * planes, 1, 1)

    def forward(self, rgb, depth):
        cat = torch.cat([rgb, depth], dim=1)
        att = torch.softmax(torch.cat([self.gate_rgb(cat),
                                       self.gate_depth(cat)], dim=1), dim=1)
        merge = rgb * att[:, 0:1] + depth * att[:, 1:2]
        return (torch.relu((rgb + merge) / 2),
                torch.relu((depth + merge) / 2)), merge


class ACFusion(nn.Module):
    """Sigmoid channel-attention merge (fusion_layer.py:87-116). Returns
    ((rgb_out, depth_out), merge)."""

    def __init__(self, planes: int):
        super().__init__()
        self.cam_rgb = Conv2d(planes, planes, 1)
        self.cam_depth = Conv2d(planes, planes, 1)

    def forward(self, rgb, depth):
        w_rgb = torch.sigmoid(self.cam_rgb(rgb.mean((2, 3), keepdim=True)))
        w_d = torch.sigmoid(self.cam_depth(depth.mean((2, 3),
                                                      keepdim=True)))
        merge = w_rgb * rgb + w_d * depth
        return (torch.relu((rgb + merge) / 2),
                torch.relu((depth + merge) / 2)), merge


def _conv(in_planes, planes, kernel, stride=1, padding=0):
    conv = Conv2d(in_planes, planes, kernel, stride, padding, bias=False)
    init_conv(conv)
    return conv


class RGBDBasicBlock(nn.Module):
    """Dual-path basic block (model/resnet.py:256-318) with one shared
    downsample projection, where the stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        for tag in ('', 'depth_'):
            setattr(self, f'{tag}conv1', _conv(inplanes, planes, 3, stride, 1))
            setattr(self, f'{tag}bn1', BatchNorm2d(planes))
            setattr(self, f'{tag}conv2', _conv(planes, planes, 3, 1, 1))
            setattr(self, f'{tag}bn2', BatchNorm2d(planes))
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or inplanes != planes:
            self.downsample_conv = _conv(inplanes, planes, 1, stride)
            self.downsample_bn = BatchNorm2d(planes)

    def forward(self, streams):
        outs = []
        for tag, x in zip(('', 'depth_'), streams):
            m = lambda name: getattr(self, f'{tag}{name}')
            y = torch.relu(m('bn1')(m('conv1')(x)))
            y = m('bn2')(m('conv2')(y))
            residual = x if self.downsample_conv is None else \
                self.downsample_bn(self.downsample_conv(x))
            outs.append(torch.relu(y + residual))
        return tuple(outs)


class RGBDResNet(nn.Module):
    """Dual-path ResNet with an RGBDFusion after every stage: basic blocks in
    STAGES[depth]'s counts, whatever the depth, as in JAX
    (model/resnet.py:405-502). forward(rgb NHWC, depth NHWC) -> (blocks,
    merges): per stage the fused streams and the merge, NCHW."""

    def __init__(self, depth: int = 18, rgb_channels: int = 3,
                 depth_channels: int = 1):
        super().__init__()
        _, sizes = STAGES[depth]       # basic blocks at every depth, as in JAX
        for tag, cin in (('', rgb_channels), ('depth_', depth_channels)):
            setattr(self, f'{tag}conv1', _conv(cin, 64, 7, 2, 3))
            setattr(self, f'{tag}bn1', BatchNorm2d(64))
        inplanes = 64
        for stage, (planes, nblocks) in enumerate(
                zip((64, 128, 256, 512), sizes)):
            blocks = []
            for i in range(nblocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(RGBDBasicBlock(inplanes, planes, stride))
                inplanes = planes
            setattr(self, f'layer{stage + 1}', nn.Sequential(*blocks))
            setattr(self, f'rgbd_fusion_{stage}', RGBDFusion(planes))

    def forward(self, rgb, depth_img):
        streams = []
        for tag, x in (('', rgb), ('depth_', depth_img)):
            y = getattr(self, f'{tag}conv1')(x.permute(0, 3, 1, 2))
            y = torch.relu(getattr(self, f'{tag}bn1')(y))
            streams.append(F.max_pool2d(y, 3, 2, 1))
        streams = tuple(streams)
        blocks, merges = [], []
        for stage in range(4):
            streams = getattr(self, f'layer{stage + 1}')(streams)
            streams, merge = getattr(self, f'rgbd_fusion_{stage}')(*streams)
            blocks.append(streams)
            merges.append(merge)
        return blocks, merges


class RGBDResNetUNet(nn.Module):
    """OfficialResNetUnet_RGBD (resnetUnet.py:659-751): the dual-path
    encoder and a UNet decoder over its per-stage merges. rgb
    [B,S,S,3], depth [B,S,S,1] -> (img_result [B,S/4,S/4,sum(out_dims)],
    img_feature [B,S/4,S/4,deconv_dim]), NHWC."""

    def __init__(self, depth: int = 18, joint_num: int = 21,
                 deconv_dim: int = 128,
                 out_dims: Sequence[int] = (63, 21, 21)):
        super().__init__()
        self.backbone = RGBDResNet(depth)
        self.up4 = Residual(512, 512)
        self.skip_layer4 = Residual(256, 256)
        self.fusion_layer4 = Residual(768, 256)
        self.up3 = Residual(256, 256)
        self.skip_layer3 = Residual(128, 128)
        self.fusion_layer3 = Residual(384, 128)
        self.up2 = Residual(128, 128)
        self.skip_layer2 = Residual(64, 64)
        self.fusion_layer2 = Residual(192, deconv_dim)
        self.finals = final_convs(deconv_dim, out_dims)

    def forward(self, rgb, depth_img):
        _, (m1, m2, m3, m4) = self.backbone(rgb, depth_img)
        c4_up = upsample_bilinear_x2(self.up4(m4))
        c3 = self.fusion_layer4(torch.cat([c4_up, self.skip_layer4(m3)], 1))
        c3_up = upsample_bilinear_x2(self.up3(c3))
        c2 = self.fusion_layer3(torch.cat([c3_up, self.skip_layer3(m2)], 1))
        c2_up = upsample_bilinear_x2(self.up2(c2))
        feat = self.fusion_layer2(torch.cat([c2_up, self.skip_layer2(m1)],
                                            1))
        result = torch.cat([f(feat) for f in self.finals], dim=1)
        return (result.permute(0, 2, 3, 1).contiguous(),
                feat.permute(0, 2, 3, 1).contiguous())
