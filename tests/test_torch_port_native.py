"""The port's native eval core (keypointfusion_torch/data/native.py,
csrc/host/preprocess.cc) against the JAX package's
(keypointfusion_tpu/native), on the CPU.

Tolerance 0 throughout: the two cores are one C++ source built alike
(g++ -O3), so their outputs are the same bits:
  * crop_normalize and depth_to_pcl on tests/test_native.py's frames;
  * build_rgbd_sample's eval route (use_native) on a frame with labels;
  * the committed DexYCB fixture's test split through the port's default
    route against the JAX default route's samples stored beside it
    (native_samples.npz, scripts/make_torch_port_fixture.py), which
    chip_smoke.py's [native] phase also reads.
The four loaders' test splits are held to JAX's default route in
tests/test_torch_port_datasets.py:test_test_split_against_native_core.
"""

import os
import random

import numpy as np
import pytest

from keypointfusion_tpu import native as jnative
from keypointfusion_tpu.data import datasets as jds
from keypointfusion_tpu.data import preprocessing as jpp
from keypointfusion_torch.data import datasets as ds
from keypointfusion_torch.data import native
from keypointfusion_torch.kernels import build

from tests.test_native import CUBE, PARAS, _frame

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'torch_port_dexycb')
CAM = np.asarray(PARAS, np.float32)


@pytest.fixture(scope='module', autouse=True)
def jax_core():
    if not jnative.available():
        pytest.skip('the JAX package\'s native core did not build')


def test_crop_normalize_and_pcl_match_jax_core():
    rng = np.random.RandomState(0)
    for t in range(8):
        depth, center = _frame(t, rng)
        got, m = native.crop_normalize(depth, center, CUBE, CAM, 128)
        want, wm = jnative.crop_normalize(depth, center, CUBE, CAM, 128)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(m, wm)
        com3d = jpp.joint_img_to_3d(center, PARAS).astype(np.float32)
        for flip in (1.0, -1.0):
            pcl = native.depth_to_pcl(got, m, CAM, com3d, CUBE, flip)
            np.testing.assert_array_equal(
                pcl, jnative.depth_to_pcl(want, wm, CAM, com3d, CUBE, flip))
            assert pcl.shape[1] == 3 and 0 < len(pcl) < 128 * 128


def test_return_codes_raise():
    depth, center = _frame(0, np.random.RandomState(0))
    with pytest.raises(ValueError, match='zero depth'):
        native.crop_normalize(depth, center * [1, 1, 0], CUBE, CAM)
    with pytest.raises(ValueError, match='empty box'):
        native.crop_normalize(depth, center, CUBE * 0, CAM)
    crop, m = native.crop_normalize(depth, center, CUBE, CAM)
    with pytest.raises(ValueError, match='zero scale'):
        native.depth_to_pcl(crop, m * 0, CAM, center, CUBE)
    with pytest.raises(ValueError, match=r'\[H, W\]'):
        native.crop_normalize(depth[None], center, CUBE, CAM)


def test_without_gxx_it_raises(monkeypatch, tmp_path):
    """No g++ and no built library: an error, never a Python stand-in."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build.shutil, 'which', lambda name: None)
    core = build.HostLibrary('preprocess.cc', {'crop_normalize': []})
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        core.function('crop_normalize')


def test_eval_sample_matches_jax_default_route():
    """build_rgbd_sample(train=False) through each package's core, and
    the port's numpy route against JAX's."""
    rng = np.random.RandomState(2)
    depth, center = _frame(3, rng)
    rgb = rng.randint(0, 255, (480, 640, 3)).astype(np.uint8)
    com3d = jpp.joint_img_to_3d(center, PARAS)
    joints = (com3d[None] + rng.uniform(-60, 60, (21, 3))).astype(
        np.float32)
    kwargs = dict(depth=depth, rgb=rgb, joint_xyz_mm=joints,
                  center_xyz=com3d, cam_para=PARAS, cube_size=CUBE,
                  train=False, aug_para=(10, 0.2, 180), img_size=128,
                  sample_num=128)
    for use_native in (True, False):
        got = ds.build_rgbd_sample(
            py_rng=random.Random(0), np_rng=np.random.RandomState(5),
            use_native=use_native, clamp_pcl=use_native, **kwargs)
        want = jds.build_rgbd_sample(
            py_rng=random.Random(0), np_rng=np.random.RandomState(5),
            use_native=use_native, clamp_pcl=use_native, **kwargs)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fixture_test_split_matches_stored_native_samples():
    stored = np.load(os.path.join(FIXTURE, 'native_samples.npz'))
    port = ds.DexYCBDataset('s0', 'test', FIXTURE, sample_num=1024, seed=7)
    assert port.use_native
    indices = sorted({int(k.split('_')[1]) for k in stored.files})
    assert indices == [0, 1, 2, 3]
    for i in indices:
        for k, v in port[i].items():
            np.testing.assert_array_equal(v, stored[f'test_{i}_{k}'],
                                          err_msg=f'{i} {k}')
