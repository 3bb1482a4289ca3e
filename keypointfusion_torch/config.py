"""Configuration for the PyTorch port of KeypointFusion.

The fields the serving path reads, with the names and defaults of the JAX
package's `Config` (keypointfusion_tpu/config.py), which mirror the
reference config singleton. The port keeps its own copy so that it imports
nothing from the JAX package.
"""

import dataclasses
from typing import List, Tuple

JOINT = {
    'STB': 21,
    'nyu': 14,
    'dexycb': 21,
    'ho3d': 21,
}

CUBE = {
    'STB': [200, 200, 200],
    'nyu': [250, 250, 250],
    'dexycb': [250, 250, 250],
    'ho3d': [280, 280, 280],
}


@dataclasses.dataclass(frozen=True)
class Config:
    net: str = 'KPFusion-resnet-18'   # only resnet-18 is ported so far
    dataset: str = 'dexycb'           # ['nyu', 'STB', 'dexycb', 'ho3d']
    point_num: int = 1024
    input_size: int = 128
    feature_para: Tuple[float, ...] = (0.8,)
    # the model's compute dtype, build_kpfusion's default: 'float32' |
    # 'bfloat16'. StreamingEngine takes its own (bfloat16), as JAX's does.
    compute_dtype: str = 'float32'
    seed: int = 23455

    @property
    def joint_num(self) -> int:
        return JOINT[self.dataset]

    @property
    def cube_size(self) -> List[int]:
        return CUBE[self.dataset]
