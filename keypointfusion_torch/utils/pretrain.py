"""ImageNet warm start of the backbones (port of
keypointfusion_tpu/utils/pretrain.py).

The reference builds its backbones from ImageNet weights and downloads
them; here the checkpoint must already be on disk, at
`Config.pretrain_dir` (a file or a directory) or in the torch hub cache
(~/.cache/torch/hub/checkpoints). The port's encoders carry the release
checkpoints' names under `backbone_d.backbone.` and
`backbone_rgb.backbone.`, so no conversion is needed:
  * ResNet-18/50/101/152, torchvision's weights, loaded with strict=False
    and then the depth backbone given a fresh one-channel stem (reference
    model/resnetUnet.py:278-289): utils/weights.py:merge_partial's shape
    gate keeps that rule, the RGB `conv1` [64,3,7,7] merges and the depth
    `conv1` [64,1,7,7] keeps its fresh weights.
  * ConvNeXt T/S/B/L, the release checkpoint `{'model': sd}`: both
    backbones replace the stem (`downsample_layers.0`) with a fresh one
    (convNeXT/resnetUnet.py:105-109) and use no classifier, so the stem
    and the classifier's `norm` and `head` are dropped, as the JAX
    package's convert_convnext_imagenet drops them.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import List, Optional

import torch

from keypointfusion_torch.config import Config
from keypointfusion_torch.utils.weights import StateDict, strip_module_prefix

TORCH_HUB_CACHE = osp.expanduser('~/.cache/torch/hub/checkpoints')

_CONVNEXT_LONG = {'T': 'tiny', 'S': 'small', 'B': 'base', 'L': 'large'}


def _patterns(cfg: Config) -> List[str]:
    """Filename globs of the net's released ImageNet checkpoints."""
    if 'convnext' in cfg.net:
        size = cfg.net.split('-')[-1]
        long = _CONVNEXT_LONG.get(size, size.lower())
        tag = '22k' if cfg.pretrain == '22k' else '1k'
        return [f'convnext_{long}_{tag}*.pth', f'convnext_{long}*.pth']
    depth = cfg.net.split('-')[-1]
    return [f'resnet{depth}-*.pth', f'resnet{depth}.pth']


def find_imagenet_checkpoint(cfg: Config) -> Optional[str]:
    """The on-disk ImageNet checkpoint for cfg.net and cfg.pretrain: None
    when none is configured and the hub cache holds none; raises
    FileNotFoundError when `pretrain_dir` is set but holds none."""
    pats = _patterns(cfg)
    if cfg.pretrain_dir:
        if osp.isfile(cfg.pretrain_dir):
            return cfg.pretrain_dir
        if osp.isdir(cfg.pretrain_dir):
            for pat in pats:
                hits = sorted(glob.glob(osp.join(cfg.pretrain_dir, pat)))
                if hits:
                    return hits[0]
        raise FileNotFoundError(
            f'Config.pretrain_dir={cfg.pretrain_dir!r} has no checkpoint '
            f'matching {pats} for net={cfg.net!r} pretrain='
            f'{cfg.pretrain!r}')
    if osp.isdir(TORCH_HUB_CACHE):
        for pat in pats:
            hits = sorted(glob.glob(osp.join(TORCH_HUB_CACHE, pat)))
            if hits:
                return hits[0]
    return None


def imagenet_backbone_state_dict(cfg: Config) -> Optional[StateDict]:
    """The ImageNet checkpoint's encoder tensors under both backbones'
    encoder names, for merge_partial over a fresh KPFusion; None when no
    checkpoint is found (and none was configured)."""
    path = find_imagenet_checkpoint(cfg)
    if path is None:
        return None
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = strip_module_prefix(ckpt.get('state_dict', ckpt.get('model', ckpt)))
    if 'convnext' in cfg.net:
        sd = {k: v for k, v in sd.items()
              if k.startswith(('downsample_layers.', 'stages.'))
              and not k.startswith('downsample_layers.0.')}
    return {f'{backbone}.backbone.{k}': v
            for backbone in ('backbone_d', 'backbone_rgb')
            for k, v in sd.items()}
