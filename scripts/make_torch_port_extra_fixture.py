"""Write tests/fixtures/torch_port_extra/extra.npz: the inputs of
tests/torch_port_extra_cases.py and the JAX package's outputs on them
(data/patch_warp.py's patch_augmentation with train and eval draws,
data/extra_datasets.py's imcrop, pad_img_to_fit_bbox, preprocess_rhd,
unify_mask, create_heatmap and make_gaussian_heatmap, through cv2 5.0),
which the PyTorch port is held to bit for bit where there is no cv2 and
no JAX (chip_smoke.py's [extra_data] phase) and on the CPU
(tests/test_torch_port_extra_data.py, which also regenerates the file
and compares).

    JAX_PLATFORMS=cpu python scripts/make_torch_port_extra_fixture.py

Keys: 'in_<name>' for each input, the outputs under their names in
case_outputs.
"""

import os
import os.path as osp
import sys

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def fixture_arrays() -> dict:
    """The fixture's arrays, computed by the JAX package."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from keypointfusion_tpu.data import extra_datasets, patch_warp
    from tests.torch_port_extra_cases import case_inputs, case_outputs
    inp = case_inputs()
    arrays = {f'in_{k}': v for k, v in inp.items()}
    arrays.update(case_outputs(patch_warp, extra_datasets, inp))
    return arrays


def main() -> int:
    from tests.torch_port_extra_cases import FIXTURE
    arrays = fixture_arrays()
    path = osp.join(REPO, FIXTURE)
    os.makedirs(osp.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f'{path}: {len(arrays)} arrays, {osp.getsize(path)} bytes')
    return 0


if __name__ == '__main__':
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    sys.exit(main())
