"""Configuration for the PyTorch port of KeypointFusion.

The fields the serving path, the train step, the trainer and the data
loaders read, with the names and defaults of the JAX package's `Config`
(keypointfusion_tpu/config.py), which mirror the reference config
singleton. The port keeps its own copy so that it imports nothing from the
JAX package. `flatten_opt` is left out: it only picks optax's moment
layout (one raveled vector or one per leaf), and torch's optimizers keep
their moments per tensor. So is `mesh_axis`, the name of the JAX mesh's
batch axis: the port runs one process per card under torch.distributed
(parallel/mesh.py), and a torch process group has no axis names.
`sync_batchnorm` is kept, with the JAX default.
"""

import dataclasses
import os.path as osp
from typing import List, Tuple

JOINT = {
    'STB': 21,
    'nyu': 14,
    'dexycb': 21,
    'ho3d': 21,
}

STEP = {
    'STB': 20,
    'nyu': 25,
    'dexycb': 10,
    'ho3d': 19,
}

EPOCH = {
    'STB': 30,
    'nyu': 30,
    'dexycb': 15,
    'ho3d': 24,
}

CUBE = {
    'STB': [200, 200, 200],
    'nyu': [250, 250, 250],
    'dexycb': [250, 250, 250],
    'ho3d': [280, 280, 280],
}


@dataclasses.dataclass(frozen=True)
class Config:
    phase: str = 'train'              # ['train', 'test', 'eval']
    root_dir: str = './data'

    net: str = 'KPFusion-resnet-18'   # or resnet-50/101/152, convnext-T/S/B/L
    dataset: str = 'dexycb'           # ['nyu', 'STB', 'dexycb', 'ho3d']
    ho3d_version: str = 'v2'
    model_save: str = ''
    save_dir: str = './'
    dexycb_setup: str = 's0'
    pretrain: str = '1k'
    # on-disk ImageNet checkpoint (file or directory) behind `pretrain`;
    # when empty the torch hub cache is searched and a miss keeps the
    # random init. A path with no matching checkpoint is an error.
    pretrain_dir: str = ''
    point_num: int = 1024

    load_model: str = ''              # a .pth, or a checkpoint's name
    finetune_dir: str = ''
    resume: bool = False              # full resume from 'latest'

    batch_size: int = 64
    input_size: int = 128
    center_type: str = 'refine'
    loss_type: str = 'L1Loss'         # ['L1Loss', 'Mse']
    # the train split's augmentation: sigma of the CoM shift (mm), of the
    # cube scale, and the rotation range (degrees); colour jitter factor
    augment_para: Tuple[float, float, float] = (10., 0.2, 180.)
    color_factor: float = 0.2

    lr: float = 8e-4
    opt: str = 'adamw'                # ['sgd', 'adam', 'adamw']
    scheduler: str = 'step'           # ['auto', 'step', 'constant']
    step_gamma: float = 0.1
    coord_weight: float = 100.
    deconv_weight: float = 1.
    spatial_weight: Tuple[float, ...] = (10., 10., 10.)
    spatial_epoch: Tuple[int, ...] = (24, 24, 24)
    # accepted for config-surface compatibility; dead in the reference too
    # (defined in its config but never read)
    downsample: int = 2               # [1, 2, 4, 8]
    awr: bool = True

    feature_type: Tuple[str, ...] = ('weight_offset',)
    feature_para: Tuple[float, ...] = (0.8,)

    # per-output supervision targets: 1 = dense pixel stage (backbones),
    # 2/3 = 3D / 2D-refined KFAM joint stages
    stage_type: Tuple[int, ...] = (1, 1, 2, 3, 2, 3)
    # directory of MANO_RIGHT.pkl / MANO_LEFT.pkl (mano/assets.py)
    mano_path: str = osp.join('.', 'assets', 'mano')

    # the model's compute dtype, build_kpfusion's default: 'float32' |
    # 'bfloat16' | 'mixed' (training: bfloat16 backbones, float32 head).
    # StreamingEngine takes its own (bfloat16), as JAX's does.
    compute_dtype: str = 'float32'
    seed: int = 23455
    # JAX's approx_min_k pixel selection for the sampler (faster on a TPU);
    # off the TPU approx_min_k is exact, and the port takes the exact
    # selection whatever the flag (models/kpfusion.py)
    fast_topk: bool = False
    # recompute the forward in the train step's backward
    # (torch.utils.checkpoint): activation memory for compute
    remat: bool = False
    # train steps per call of the trainer's step: G > 1 stacks G loader
    # batches and runs them through make_train_step_scan
    steps_per_dispatch: int = 1
    # under a process group: True takes every BatchNorm's train statistics
    # over the global batch (the JAX mesh step's GSPMD reductions); False
    # over each rank's slice, the running statistics then averaged (the
    # JAX per-shard step, the reference's DataParallel)
    sync_batchnorm: bool = True

    @property
    def joint_num(self) -> int:
        return JOINT[self.dataset]

    @property
    def cube_size(self) -> List[int]:
        return CUBE[self.dataset]

    @property
    def max_epoch(self) -> int:
        return EPOCH[self.dataset]

    @property
    def step_size(self) -> int:
        return STEP[self.dataset]
