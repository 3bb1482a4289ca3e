"""Legacy model components of the reference, off the flagship path (port
of keypointfusion_tpu/models/legacy.py; the reference's
model/hourglass.py:122-236, model/cbam.py:26-95 and
model/centerNet.py:101-199): the stacked-hourglass PoseNet (the AWR
backbone), CBAM attention and the CenterNet-style direct regressor.

The families (PoseNet, CBAM, CenterNetRegressor) take and return NHWC
as the JAX modules do; their blocks (ConvBNRelu, Hourglass, ChannelGate,
SpatialGate) work in NCHW inside, as the port's Residual
(models/unet.py) and ResNet (models/resnet.py) do, whose torch names are
kept. The other parameters are named after the JAX module tree
(`pre_conv.conv`, `hg_0.low2.low2.up1`, `channel_gate.fc1`, ...): the
reference's names could not be read, so a reference .pth of this family
will need a key map. BatchNorms follow torch's momentum convention: 0.1
(flax's 0.9), and 0.01 in SpatialGate (flax's 0.99).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from keypointfusion_torch.models.layers import Conv2d, Linear
from keypointfusion_torch.models.norm import BatchNorm2d
from keypointfusion_torch.models.resnet import ResNet, init_conv
from keypointfusion_torch.models.unet import Residual


def _upsample_nearest_x2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class ConvBNRelu(nn.Module):
    """conv (bias, 'same' padding) -> optional BatchNorm -> optional
    ReLU, NCHW."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int = 3,
                 stride: int = 1, bn: bool = False, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = Conv2d(in_dim, out_dim, kernel, stride,
                           (kernel - 1) // 2, bias=True)
        init_conv(self.conv)
        self.bn = BatchNorm2d(out_dim) if bn else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.relu else x


class Hourglass(nn.Module):
    """Recursive hourglass of depth n (hourglass.py:122-146), NCHW, on an
    input of `features` channels. As in JAX, the recursion gets no
    `increase`."""

    def __init__(self, n: int, features: int, increase: int = 0):
        super().__init__()
        f, nf = features, features + increase
        self.up1 = Residual(f, f)
        self.low1 = Residual(f, nf)
        self.low2 = Hourglass(n - 1, nf) if n > 1 else Residual(nf, nf)
        self.low3 = Residual(nf, f)

    def forward(self, x):
        up1 = self.up1(x)
        low = self.low1(F.max_pool2d(x, 2, 2))
        low = self.low3(self.low2(low))
        return up1 + _upsample_nearest_x2(low)


class PoseNet(nn.Module):
    """Stacked-hourglass AWR backbone (hourglass.py:163-236): img
    [B,S,S,in_channels] -> (preds [B,S/4,S/4,5J], feature
    [B,S/4,S/4,inp_dim]), NHWC, the same contract as ResNetUNet."""

    def __init__(self, nstack: int = 2, joint_num: int = 21,
                 inp_dim: int = 256, increase: int = 0,
                 in_channels: int = 1):
        super().__init__()
        self.nstack = nstack
        self.pre_conv = ConvBNRelu(in_channels, 64, 7, 2, bn=True)
        self.pre_res1 = Residual(64, 128)
        self.pre_res2 = Residual(128, inp_dim)
        self.pre_res3 = Residual(inp_dim, inp_dim)
        for i in range(nstack):
            setattr(self, f'hg_{i}', Hourglass(4, inp_dim, increase))
            setattr(self, f'feat_res_{i}', Residual(inp_dim, inp_dim))
            setattr(self, f'feat_conv_{i}',
                    ConvBNRelu(inp_dim, inp_dim, 1, bn=True))
            setattr(self, f'out1_{i}', Conv2d(inp_dim, joint_num * 3, 1))
            setattr(self, f'out2_{i}', Conv2d(inp_dim, joint_num, 1))
            setattr(self, f'out3_{i}', Conv2d(inp_dim, joint_num, 1))
            if i < nstack - 1:
                setattr(self, f'merge_preds_{i}',
                        Conv2d(joint_num * 5, inp_dim, 1))
                setattr(self, f'merge_feats_{i}', Conv2d(inp_dim, inp_dim, 1))

    def forward(self, img):
        x = self.pre_res1(self.pre_conv(img.permute(0, 3, 1, 2)))
        x = self.pre_res3(self.pre_res2(F.max_pool2d(x, 2, 2)))
        preds = feature = None
        for i in range(self.nstack):
            m = lambda name: getattr(self, f'{name}_{i}')
            feature = m('feat_conv')(m('feat_res')(m('hg')(x)))
            preds = torch.cat([m('out1')(feature), m('out2')(feature),
                               m('out3')(feature)], dim=1)
            if i < self.nstack - 1:
                x = x + m('merge_preds')(preds) + m('merge_feats')(feature)
        return (preds.permute(0, 2, 3, 1).contiguous(),
                feature.permute(0, 2, 3, 1).contiguous())


class ChannelGate(nn.Module):
    """CBAM channel gate (cbam.py:26-60), NCHW: one MLP shared by the
    average and the max pool, their outputs summed, a sigmoid."""

    def __init__(self, gate_channels: int, reduction: int = 16,
                 pool_types=('avg', 'max')):
        super().__init__()
        self.pool_types = tuple(pool_types)
        for p in self.pool_types:
            if p not in ('avg', 'max'):
                raise NotImplementedError(p)
        self.fc1 = Linear(gate_channels, gate_channels // reduction)
        self.fc2 = Linear(gate_channels // reduction, gate_channels)

    def forward(self, x):
        att = 0.0
        for p in self.pool_types:
            pooled = x.mean((2, 3)) if p == 'avg' else x.amax((2, 3))
            att = att + self.fc2(torch.relu(self.fc1(pooled)))
        return x * torch.sigmoid(att)[:, :, None, None]


class SpatialGate(nn.Module):
    """CBAM spatial gate (cbam.py:69-81), NCHW: the channel max and mean,
    a 7x7 conv, BatchNorm (momentum 0.01), a sigmoid. Returns (kept,
    suppressed)."""

    def __init__(self):
        super().__init__()
        self.spatial_conv = Conv2d(2, 1, 7, 1, 3, bias=False)
        self.spatial_bn = BatchNorm2d(1, momentum=0.01)

    def forward(self, x):
        pooled = torch.cat([x.amax(1, keepdim=True),
                            x.mean(1, keepdim=True)], dim=1)
        scale = torch.sigmoid(self.spatial_bn(self.spatial_conv(pooled)))
        return x * scale, x * (1 - scale)


class CBAM(nn.Module):
    """Channel then spatial attention (cbam.py:84-95), NHWC in and out."""

    def __init__(self, gate_channels: int, reduction: int = 16,
                 no_spatial: bool = False):
        super().__init__()
        self.channel_gate = ChannelGate(gate_channels, reduction)
        self.spatial_gate = None if no_spatial else SpatialGate()

    def forward(self, x):
        x = self.channel_gate(x.permute(0, 3, 1, 2))
        if self.spatial_gate is not None:
            x, _ = self.spatial_gate(x)
        return x.permute(0, 2, 3, 1).contiguous()


class CenterNetRegressor(nn.Module):
    """Plain ResNet -> global average pool -> FC -> [B,J,3] direct joint
    regressor (centerNet.py:101-199); img NHWC [B,S,S,in_channels]."""

    def __init__(self, joint_num: int = 21, depth: int = 18,
                 in_channels: int = 1):
        super().__init__()
        self.joint_num = joint_num
        self.backbone = ResNet(depth, in_channels)
        self.fc = Linear(512 * self.backbone.expansion, joint_num * 3)

    def forward(self, img):
        *_, c4 = self.backbone(img.permute(0, 3, 1, 2))
        return self.fc(c4.mean((2, 3))).reshape(-1, self.joint_num, 3)
