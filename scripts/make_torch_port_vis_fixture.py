"""Write tests/fixtures/torch_port_vis/vis_debug.npz: the inputs of
tests/torch_port_vis_cases.py and the SHA-256 digests of the JAX
package's outputs on them (keypointfusion_tpu/utils/vis.py's debug
renderers through cv2 5.0: the returned arrays, and each written PNG as
cv2.imread reads it back and each .obj's bytes), which the PyTorch port
is held to bit for bit where there is no cv2 and no JAX (chip_smoke.py's
[vis_debug] phase, tests/test_torch_port_cuda.py) and on the CPU
(tests/test_torch_port_vis_debug.py, which also regenerates the digests
and compares).

    JAX_PLATFORMS=cpu python scripts/make_torch_port_vis_fixture.py

Keys: 'in:<name>' for each input, 'out:<key>' for each output's digest
(a string) under its key in case_outputs.
"""

import os
import os.path as osp
import sys
import tempfile

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def fixture_arrays() -> dict:
    """The fixture's arrays: the inputs and the JAX package's digests."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import cv2
    from keypointfusion_tpu.utils import vis as jvis
    from tests.torch_port_vis_cases import case_inputs, case_outputs, digest
    inp = case_inputs()
    arrays = {f'in:{k}': v for k, v in inp.items()}
    with tempfile.TemporaryDirectory() as workdir:
        out = case_outputs(jvis, cv2.imread, workdir, inp)
    arrays.update({f'out:{k}': np.array(digest(v)) for k, v in out.items()})
    return arrays


def main() -> int:
    from tests.torch_port_vis_cases import FIXTURE
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
