"""ResNet encoder emitting all five stage maps (c0..c4), NCHW.

Port of keypointfusion_tpu/models/resnet.py: BasicBlock for resnet-18,
Bottleneck (expansion 4) for resnet-50/101/152. The module and parameter
names are torchvision's, as the reference's. Convs and BatchNorms follow
the compute dtype (models/layers.py).
"""

from __future__ import annotations

from torch import nn

from keypointfusion_torch.models.layers import Conv2d
from keypointfusion_torch.models.norm import BatchNorm2d

STAGES = {
    18: ('basic', (2, 2, 2, 2)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


def init_conv(conv: nn.Conv2d) -> None:
    """normal(0, sqrt(2/fan_out)), as the reference and the JAX package."""
    nn.init.kaiming_normal_(conv.weight, mode='fan_out', nonlinearity='relu')
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm2d(out_planes)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or inplanes != out_planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out_planes, 1, stride, bias=False),
                BatchNorm2d(out_planes))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """5-output ResNet encoder, depth in STAGES."""

    def __init__(self, depth: int = 18, in_channels: int = 3):
        super().__init__()
        kind, sizes = STAGES[depth]
        block = BasicBlock if kind == 'basic' else Bottleneck
        self.expansion = block.expansion
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (planes, nblocks) in enumerate(
                zip((64, 128, 256, 512), sizes)):
            blocks = []
            for i in range(nblocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(inplanes, planes, stride))
                inplanes = planes * block.expansion
            setattr(self, f'layer{stage + 1}', nn.Sequential(*blocks))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv(m)

    def forward(self, x):
        c0 = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        c1 = self.layer1(c0)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        c4 = self.layer4(c3)
        return c0, c1, c2, c3, c4
