"""ConvNeXt encoder + UNet decoder backbone family (T/S/B/L).

Port of keypointfusion_tpu/models/convnext.py, itself the reference's
convNeXT/convnext.py (stock ConvNeXt with its two LayerNorm layouts and
DropPath) and convNeXT/resnetUnet.py:60-253 (the 4x4/s4 stem matching the
input's channels, the residual-skip decoder). NCHW inside, as the
reference; the public `ConvNeXtUNet.forward` takes and returns NHWC like
ResNetUNet. Parameter names are the reference checkpoint's
(`backbone.downsample_layers.{i}.{0,1}`, `backbone.stages.{i}.{j}.
{dwconv,norm,pwconv1,pwconv2,gamma}`, `up4.0`, ..., `result_emb`,
`finals.{i}`), which keypointfusion_tpu/utils/torch_convert.py:
convert_convnext_unet reads. The decoder's dead `feat_emb` is left out:
the reference applies `result_emb` to both outputs
(convNeXT/resnetUnet.py:145-152), so the feature map and the dense heads'
input are one tensor.

Precision follows the JAX module's rounding points (models/layers.py):
convolutions, LayerNorms and Linears return the compute dtype, but the
layer scale `gamma` is a float32 parameter, so `gamma * y` and the
residual stream after each block are float32 (flax promotes bfloat16 x
float32), and the next block's depthwise conv rounds its input again.
GELU is exact (erf). LayerNorm keeps models/layers.py's two-pass
variance; flax takes E[x^2] - E[x]^2, which loses accuracy where |mean| >>
std (tests/test_torch_port_backbones.py measures both against float64).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from keypointfusion_torch.models.layers import Conv2d, LayerNorm, Linear
from keypointfusion_torch.models.unet import Residual, final_convs
from keypointfusion_torch.ops.resize import upsample_bilinear_x2

MODEL_LIST = {
    'tiny': ((3, 3, 9, 3), (96, 192, 384, 768)),
    'small': ((3, 3, 27, 3), (96, 192, 384, 768)),
    'base': ((3, 3, 27, 3), (128, 256, 512, 1024)),
    'large': ((3, 3, 27, 3), (192, 384, 768, 1536)),
}
_ALIASES = {'T': 'tiny', 'S': 'small', 'B': 'base', 'L': 'large'}


def resolve_size(name: str) -> str:
    return _ALIASES.get(name, name)


def trunc_init(module: nn.Module) -> None:
    """flax's truncated_normal(0.02) (cut at 2 std) and a zero bias."""
    nn.init.trunc_normal_(module.weight, std=0.02, a=-0.04, b=0.04)
    nn.init.zeros_(module.bias)


class LayerNorm2d(LayerNorm):
    """The reference's channels_first LayerNorm: over C of NCHW."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class DropPath(nn.Module):
    """Stochastic depth: in train mode each sample's branch is dropped with
    probability `rate` and the kept ones scaled by 1/(1 - rate), the mask
    drawn from `generator` (on x's device); the identity otherwise."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ConvNeXtBlock(nn.Module):
    """7x7 depthwise conv -> LN -> Linear(4x) -> GELU -> Linear -> layer
    scale -> drop-path residual (reference convnext.py:16-52)."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.drop_path = DropPath(drop_path)
        for m in (self.dwconv, self.pwconv1, self.pwconv2):
            trunc_init(m)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        y = self.drop_path(self.gamma * y, generator)
        return x + y.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """4-stage ConvNeXt encoder emitting every stage's map (reference
    convnext.py:55-117), with the 4x4/s4 conv + LN stem over
    `in_channels` (convNeXT/resnetUnet.py:105-109)."""

    def __init__(self, in_channels: int, depths: Sequence[int],
                 dims: Sequence[int], drop_path_rate: float = 0.0):
        super().__init__()
        stem = Conv2d(in_channels, dims[0], 4, 4)
        trunc_init(stem)
        layers = [nn.Sequential(stem, LayerNorm2d(dims[0], eps=1e-6))]
        for i in range(1, 4):
            conv = Conv2d(dims[i - 1], dims[i], 2, 2)
            trunc_init(conv)
            layers.append(nn.Sequential(LayerNorm2d(dims[i - 1], eps=1e-6),
                                        conv))
        self.downsample_layers = nn.ModuleList(layers)
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(dims[i], rates[sum(depths[:i]) + j])
                          for j in range(depths[i]))
            for i in range(4))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        feats = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x)
            for block in stage:
                x = block(x, generator)
            feats.append(x)
        return tuple(feats)


class ConvNeXtUNet(nn.Module):
    """ConvNeXt encoder + residual-skip UNet decoder with the extra
    result_emb stage. For a 128x128 crop: img_result [B,32,32,
    sum(out_dims)] and img_feature [B,32,32,deconv_dim], NHWC."""

    def __init__(self, in_channels: int, size: str = 'tiny',
                 deconv_dim: int = 128,
                 out_dims: Sequence[int] = (63, 21, 21),
                 drop_path_rate: float = 0.0):
        super().__init__()
        depths, d = MODEL_LIST[resolve_size(size)]
        self.backbone = ConvNeXt(in_channels, depths, d, drop_path_rate)
        self.up4 = nn.Sequential(Residual(d[3], d[3]))
        self.skip_layer4 = Residual(d[2], d[2])
        self.fusion_layer4 = Residual(d[3] + d[2], d[2])
        self.up3 = nn.Sequential(Residual(d[2], d[2]))
        self.skip_layer3 = Residual(d[1], d[1])
        self.fusion_layer3 = Residual(d[2] + d[1], d[1])
        self.up2 = nn.Sequential(Residual(d[1], d[1]))
        self.skip_layer2 = Residual(d[0], d[0])
        self.fusion_layer2 = Residual(d[1] + d[0], deconv_dim)
        self.result_emb = Residual(deconv_dim, deconv_dim)
        self.finals = final_convs(deconv_dim, out_dims)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x [B,S,S,Cin] -> (img_result, img_feature), NHWC; `generator`
        draws DropPath's masks in train mode."""
        c1, c2, c3, c4 = self.backbone(x.permute(0, 3, 1, 2), generator)
        c4_up = upsample_bilinear_x2(self.up4(c4))
        c3_fusion = self.fusion_layer4(
            torch.cat([c4_up, self.skip_layer4(c3)], dim=1))
        c3_up = upsample_bilinear_x2(self.up3(c3_fusion))
        c2_fusion = self.fusion_layer3(
            torch.cat([c3_up, self.skip_layer3(c2)], dim=1))
        c2_up = upsample_bilinear_x2(self.up2(c2_fusion))
        img_feature = self.fusion_layer2(
            torch.cat([c2_up, self.skip_layer2(c1)], dim=1))
        result = self.result_emb(img_feature)
        img_result = torch.cat([f(result) for f in self.finals], dim=1)
        return (img_result.permute(0, 2, 3, 1).contiguous(),
                result.permute(0, 2, 3, 1).contiguous())
