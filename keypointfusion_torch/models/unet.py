"""UNet decoder with pre-activation Residual blocks over a ResNet encoder.

Port of keypointfusion_tpu/models/unet.py. NCHW inside; the public
`ResNetUNet.forward` takes and returns NHWC like the JAX module. Module
names are the reference's (hourglass Residual with its `Conv` wrapper, so
`conv1.conv.weight`; the `up4.0` Sequential), so its state_dict loads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from keypointfusion_torch.models.layers import Conv2d
from keypointfusion_torch.models.norm import BatchNorm2d
from keypointfusion_torch.models.resnet import ResNet, init_conv
from keypointfusion_torch.ops.resize import upsample_bilinear_x2


class _Conv(nn.Module):
    """The reference's Conv wrapper: holds the conv as `.conv`."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int):
        super().__init__()
        self.conv = Conv2d(in_dim, out_dim, kernel, 1, (kernel - 1) // 2,
                              bias=True)
        init_conv(self.conv)

    def forward(self, x):
        return self.conv(x)


class Residual(nn.Module):
    """BN-ReLU-1x1(half) -> BN-ReLU-3x3(half) -> BN-ReLU-1x1(out), plus a
    1x1 skip on the raw input when the widths differ."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        half = out_dim // 2
        self.bn1 = BatchNorm2d(in_dim)
        self.conv1 = _Conv(in_dim, half, 1)
        self.bn2 = BatchNorm2d(half)
        self.conv2 = _Conv(half, half, 3)
        self.bn3 = BatchNorm2d(half)
        self.conv3 = _Conv(half, out_dim, 1)
        self.skip_layer = _Conv(in_dim, out_dim, 1) \
            if in_dim != out_dim else None

    def forward(self, x):
        y = self.conv1(torch.relu(self.bn1(x)))
        y = self.conv2(torch.relu(self.bn2(y)))
        y = self.conv3(torch.relu(self.bn3(y)))
        return y + (x if self.skip_layer is None else self.skip_layer(x))


def final_convs(deconv_dim: int, out_dims: Sequence[int]) -> nn.ModuleList:
    """The dense heads: 1x1 convs drawn from normal(0, 0.001), zero bias
    (the JAX package's final_init)."""
    finals = nn.ModuleList(Conv2d(deconv_dim, od, 1) for od in out_dims)
    for conv in finals:
        nn.init.normal_(conv.weight, std=0.001)
        nn.init.zeros_(conv.bias)
    return finals


class ResNetUNet(nn.Module):
    """For a 128x128 crop: img_result [B,32,32,sum(out_dims)] and
    img_feature [B,32,32,deconv_dim], NHWC. in_channels 1 is the depth
    stem, 3 the RGB stem. The skip inputs are the encoder's widths, 4x
    ResNet-18's for the Bottleneck depths."""

    def __init__(self, in_channels: int, depth: int = 18,
                 deconv_dim: int = 128,
                 out_dims: Sequence[int] = (63, 21, 21)):
        super().__init__()
        self.backbone = ResNet(depth, in_channels)
        exp = self.backbone.expansion
        self.up4 = nn.Sequential(Residual(512 * exp, 512))
        self.skip_layer4 = Residual(256 * exp, 256)
        self.fusion_layer4 = Residual(768, 256)
        self.up3 = nn.Sequential(Residual(256, 256))
        self.skip_layer3 = Residual(128 * exp, 128)
        self.fusion_layer3 = Residual(384, 128)
        self.up2 = nn.Sequential(Residual(128, 128))
        self.skip_layer2 = Residual(64 * exp, 64)
        self.fusion_layer2 = Residual(192, deconv_dim)
        self.finals = final_convs(deconv_dim, out_dims)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x [B,S,S,Cin] -> (img_result, img_feature), NHWC. `generator` is
        unused: it is ConvNeXtUNet's DropPath generator, taken so both
        backbone families have one call."""
        _, c1, c2, c3, c4 = self.backbone(x.permute(0, 3, 1, 2))
        c4_up = upsample_bilinear_x2(self.up4(c4))
        c3_fusion = self.fusion_layer4(
            torch.cat([c4_up, self.skip_layer4(c3)], dim=1))
        c3_up = upsample_bilinear_x2(self.up3(c3_fusion))
        c2_fusion = self.fusion_layer3(
            torch.cat([c3_up, self.skip_layer3(c2)], dim=1))
        c2_up = upsample_bilinear_x2(self.up2(c2_fusion))
        img_feature = self.fusion_layer2(
            torch.cat([c2_up, self.skip_layer2(c1)], dim=1))
        img_result = torch.cat([f(img_feature) for f in self.finals], dim=1)
        return (img_result.permute(0, 2, 3, 1).contiguous(),
                img_feature.permute(0, 2, 3, 1).contiguous())
