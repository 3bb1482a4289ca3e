"""KPFusion: the dual-backbone RGB-D keypoint fusion model (port of
keypointfusion_tpu/models/kpfusion.py).

The backbones are the net name's (`backbone`): ResNet UNets of depth
18/50/101/152 or ConvNeXt UNets T/S/B/L. Outputs follow the reference's
`result` list, [img_offset, img_offset_rgb, b1_3d, b1_2d, b2_3d, b2_2d],
aligned with the reference config's stage_type = (1,1,2,3,2,3), plus one
spatial-weight map per block.

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

`fast_topk` is the JAX module's flag, which picks lax.approx_min_k for
the sampler's pixel selection. Off the TPU approx_min_k is exact: on the
CPU it gives top_k's distances, and its pixels but where two pixels lie
exactly as far at the k-th place, where it may take the other one. The
port takes top_k's selection (the lower index first) whatever the flag;
the flag is kept so that a JAX config carries over.

Train mode (`.train()`) runs the JAX module's train path: BatchNorm with
batch statistics, the transformers' dropout at `dropout` with masks from
the `generator` passed to forward, DESA's gather form, and no kernel (K1
and K2 have no backward, as the Pallas kernels have none). The decoded
joints and the dense map's weight channels are detached, as JAX stops
their gradients. The sampling is the plain gather-sum
(geometry/pcl.py:img_to_pcl_index then sample_pixel_features) on float32
maps: its backward is the gather's own scatter-add into the maps, and the
closeness is detached, so no gradient reaches it or the index. With
bfloat16 backbones ('mixed'), JAX samples its maps with one bfloat16
pass of the densified weights (precision 'default'), which rounds the
closeness to bfloat16; the port keeps the float32 closeness. Both 'mixed'
runs lie about as far from the float32 model (b1_3d 0.289 for the port,
0.163 for JAX; b2_3d 0.475 and 0.562 on the test batch of
tests/test_torch_port_train_forward.py): train-mode BatchNorm amplifies
the backbones' bfloat16 roundings far past this one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from keypointfusion_torch.config import Config
from keypointfusion_torch.geometry.camera import CropFrame, uvd_nl_to_xyz_nl
from keypointfusion_torch.geometry.grid import img_uvd_points
from keypointfusion_torch.geometry.pcl import (
    img_to_pcl_index, sample_pixel_features,
)
from keypointfusion_torch.kernels.pixel_sampler import (
    sample_pixel_features_fused, sample_pixel_features_plain,
)
from keypointfusion_torch.models.convnext import ConvNeXtUNet
from keypointfusion_torch.models.fusion_block import FusionBlock
from keypointfusion_torch.models.layers import set_compute_dtype
from keypointfusion_torch.models.unet import ResNetUNet
from keypointfusion_torch.ops.codecs import offset_to_joint_weight
from keypointfusion_torch.ops.resize import resize_nearest_torch
from keypointfusion_torch.utils.device import resolve_device
from keypointfusion_torch.utils.profiling import span


def backbone(net: str, in_channels: int, dim: int, out_dims):
    """The UNet backbone the net's name picks, as the JAX module's
    `_backbone`: 'KPFusion-convnext-T' (T/S/B/L or tiny/small/base/large)
    or 'KPFusion-resnet-18' (18/50/101/152)."""
    size = net.split('-')[-1]
    if 'convnext' in net:
        return ConvNeXtUNet(in_channels, size, dim, out_dims)
    return ResNetUNet(in_channels, int(size), dim, out_dims)


class KPFusion(nn.Module):
    def __init__(self, net: str = 'KPFusion-resnet-18', joint_num: int = 21,
                 num_stages: int = 2, dim: int = 128,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32,
                 backbone_dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.1, fast_topk: bool = False):
        super().__init__()
        j = joint_num
        self.joint_num = j
        self.fast_topk = fast_topk
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.backbone_dtype = backbone_dtype or dtype
        out_dims = (3 * j, j, j)
        self.backbone_d = backbone(net, 1, dim, out_dims)
        self.backbone_rgb = backbone(net, 3, dim, out_dims)
        set_compute_dtype(self.backbone_d, self.backbone_dtype)
        set_compute_dtype(self.backbone_rgb, self.backbone_dtype)
        self.num_stages = num_stages
        for i in range(num_stages):
            setattr(self, f'block{i + 1}',
                    set_compute_dtype(FusionBlock(j, dim, dropout=dropout),
                                      dtype))

    def forward(self, rgb, depth, pcl, frame: CropFrame,
                kernel: float = 0.8,
                generator: Optional[torch.Generator] = None):
        """rgb [B,S,S,3], depth [B,S,S,1] (normalized crop, background 1),
        pcl [B,N,3] normalized xyz; generator (on the inputs' device)
        draws the dropout masks in train mode. Returns (results,
        spatial_weights). Spans: `kpf.model`, the whole forward;
        `kpf.model.backbones`, the two backbones inside it."""
        with span('kpf.model'):
            train = self.training
            j = self.joint_num
            dt, bb = self.dtype, self.backbone_dtype
            with span('kpf.model.backbones'):
                img_offset, img_feat = (
                    t.to(dt) for t in self.backbone_d(depth.to(bb), generator))
                img_offset_rgb, img_feat_rgb = (
                    t.to(dt) for t in self.backbone_rgb(rgb.to(bb), generator))
            b, h = img_feat.shape[0], img_feat.shape[1]

            joint_uvd = offset_to_joint_weight(img_offset, depth,
                                               kernel).detach()
            weight_map = img_offset[..., 4 * j:5 * j].detach()
            img_down = resize_nearest_torch(depth, h)
            joint_xyz = uvd_nl_to_xyz_nl(joint_uvd, frame)

            # one sampling pass serves both blocks (the maps do not change
            # between stages)
            maps = torch.cat([img_feat, img_feat_rgb, weight_map], dim=-1)
            flat = maps.reshape(b, h * h, -1)
            if train:
                closeness, index = img_to_pcl_index(pcl, img_down, frame,
                                                    select_num=4)
                sampled = sample_pixel_features(flat, closeness.detach(),
                                                index)
            else:
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
                    frame, img_down, kernel, self.use_kernels, generator)
                results += [refined_3d, refined_2d]
                spatial_weights.append(sw)
                joint_xyz = refined_2d
            return tuple(results), tuple(spatial_weights)


def model_dtypes(compute_dtype: str):
    """Config.compute_dtype -> (head dtype, backbone dtype): 'mixed' is
    bfloat16 backbones under a float32 head, as in the JAX train step."""
    if compute_dtype == 'mixed':
        return torch.float32, torch.bfloat16
    dtype = getattr(torch, compute_dtype)
    return dtype, dtype


def build_kpfusion(cfg: Config = Config(), device=None, seed: int = 0,
                   use_kernels: bool = True,
                   dtype: Optional[torch.dtype] = None,
                   dropout: float = 0.1) -> KPFusion:
    """The model factory: a KPFusion in eval mode with weights drawn from
    `seed` (the process's global RNG is left as it was), on the CUDA card
    unless `device` names another. `dtype` sets the whole model's compute
    dtype; None takes cfg.compute_dtype."""
    device = resolve_device(device)
    if dtype is None:
        dtype, backbone_dtype = model_dtypes(cfg.compute_dtype)
    else:
        backbone_dtype = dtype
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = KPFusion(cfg.net, cfg.joint_num, use_kernels=use_kernels,
                         dtype=dtype, backbone_dtype=backbone_dtype,
                         dropout=dropout, fast_topk=cfg.fast_topk)
    return model.eval().to(device)
