"""The port's dataset loaders (keypointfusion_torch/data/datasets.py)
against the JAX package's (keypointfusion_tpu/data/datasets.py), on
fabricated on-disk trees in each dataset's layout, on the CPU.

The DexYCB tree is tests/test_datasets.py's `_write_fake_dexycb`; the
HO3D (v2 and v3), NYU and STB trees are written here the way
tests/test_datasets_more.py's fixtures write them, with 8 or more frames
and both splits. For each dataset the port's class and the JAX class are
built with the same seed and read index by index, in the train split
(augmentation on: both draw the same modes, offsets, rotations, scales,
colour factors and point samples) and in the test split.

Tolerances, per key:
  * rgb, depth (nearest-warped images), pcl, xyz_gt, uvd_gt, center, M,
    cube, cam_para: 0, bit for bit, against the JAX module's numpy route.
  * The test splits also against the JAX module's default eval route,
    its fused C++ core (keypointfusion_tpu/native) when it is built,
    which the port's default route takes too (data/native.py): bit for
    bit. (The core rounds the normalized depth, the point cloud and the
    2-D labels in float32 in another order than the numpy route: 4.2e-7
    apart, HO3D's fractional depths included.)
BatchLoader over the port's dataset gives the JAX BatchLoader's batches
over the JAX dataset, in the same order, bit for bit, with one worker
thread (with more, the order in which samples draw from the dataset's
RNG follows the threads' timing, in both packages).
"""

import json
import os

import cv2
import numpy as np
import pytest

from keypointfusion_tpu import native
from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data import datasets as jds
from keypointfusion_tpu.data import preprocessing as jpp
from keypointfusion_tpu.data.pipeline import BatchLoader as JBatchLoader
from keypointfusion_torch.config import Config
from keypointfusion_torch.data import datasets as ds
from keypointfusion_torch.data.pipeline import BatchLoader

from tests.test_datasets import _write_fake_dexycb

FX, FY, FU, FV = 600.0, 600.0, 320.0, 240.0
KEYS = ('rgb', 'depth', 'pcl', 'xyz_gt', 'uvd_gt', 'center', 'M', 'cube',
        'cam_para')


def _same_samples(port, jax_ds, indices):
    assert len(port) == len(jax_ds)
    for i in indices:
        got, want = port[i], jax_ds[i]
        assert set(got) == set(want) == set(KEYS)
        for k in KEYS:
            assert got[k].dtype == want[k].dtype == np.float32, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f'{k}, sample {i}')


@pytest.fixture
def numpy_route(monkeypatch):
    """The eval path without the native core, in both packages."""
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(ds._Base, 'use_native', False)


# ----------------------------------------------------------------- trees ---

@pytest.fixture(scope='module')
def dexycb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dexycb'))
    _write_fake_dexycb(root, n=10)
    return root


def _encode_ho3d_depth(depth_mm):
    scale = 0.00012498664727900177 * 1000
    raw = np.round(depth_mm / scale).astype(np.int32)
    img = np.zeros(depth_mm.shape + (3,), np.uint8)
    img[..., 2] = raw % 256
    img[..., 1] = raw // 256
    return img


def _write_ho3d(root, version, n=8):
    base = f'{root}/HO3D_{version}'
    os.makedirs(f'{base}/annotations', exist_ok=True)
    os.makedirs(f'{base}/imgs', exist_ok=True)
    rng = np.random.RandomState(0)
    images, annotations, centers = [], [], []
    for i in range(n):
        depth = np.zeros((480, 640), np.float32)
        cx, cy = 320 + 4 * i, 240 - 3 * i
        depth[cy - 40:cy + 40, cx - 40:cx + 40] = rng.uniform(
            560, 660, (80, 80))
        cv2.imwrite(f'{base}/imgs/depth_{i:04d}.png',
                    _encode_ho3d_depth(depth))
        rgb = rng.randint(0, 255, (480, 640, 3)).astype(np.uint8)
        ext = 'png' if version == 'v2' else 'jpg'
        cv2.imwrite(f'{base}/imgs/rgb_{i:04d}.{ext}', rgb)
        center = np.array([(cx - FU) * 600 / FX, (cy - FV) * 600 / FY,
                           600.], np.float32)
        joints = (center[None] + rng.uniform(-60, 60, (21, 3))) / 1000.0
        centers.append(center + rng.uniform(-5, 5, 3))
        images.append({'id': i, 'file_name': f'imgs/rgb_{i:04d}.png',
                       'height': 480, 'width': 640})
        annotations.append({
            'id': i, 'image_id': i, 'joints_coord_cam': joints.tolist(),
            'cam_param': {'focal': [FX, FY], 'princpt': [FU, FV]},
            'mano_param': {'pose': [0.0] * 48, 'shape': [0.0] * 10,
                           'trans': [0.0] * 3}})
    for split in ('train', 'test'):
        with open(f'{base}/annotations/HO3D_{split}_data.json', 'w') as f:
            json.dump({'images': images, 'annotations': annotations}, f)
        np.savetxt(f'{base}/annotations/{split}_refine_center_xyz.txt',
                   np.asarray(centers))


@pytest.fixture(scope='module')
def ho3d_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ho3d'))
    _write_ho3d(root, 'v2')
    _write_ho3d(root, 'v3')
    return root


NYU_PARAS = (588.03, 587.07, 320., 240.)


def _write_nyu(root, split, n):
    import scipy.io as sio
    os.makedirs(f'{root}/{split}', exist_ok=True)
    rng = np.random.RandomState(1)
    joint_uvd = np.zeros((1, n, 36, 3))
    joint_xyz = np.zeros((1, n, 36, 3))
    centers = []
    for i in range(n):
        depth = np.zeros((480, 640), np.float32)
        depth[200 - i:280 - i, 280 + 2 * i:360 + 2 * i] = rng.uniform(
            600, 700, (80, 80))
        img = np.zeros((480, 640, 3), np.uint8)
        raw = depth.astype(np.int32)
        img[..., 0] = raw % 256
        img[..., 1] = raw // 256
        cv2.imwrite(f'{root}/{split}/depth_1_{i + 1:07d}.png', img)
        if i % 4 != 3:        # some frames have no RGB: zeros, as in JAX
            cv2.imwrite(f'{root}/{split}/rgb_1_{i + 1:07d}.png',
                        rng.randint(0, 255, (480, 640, 3)).astype(np.uint8))
        center = np.array([(320 + 2 * i - NYU_PARAS[2]) * 650 / NYU_PARAS[0],
                           -(240 - i - NYU_PARAS[3]) * 650 / NYU_PARAS[1],
                           650.0])
        xyz = center[None] + rng.uniform(-60, 60, (36, 3))
        joint_xyz[0, i] = xyz
        joint_uvd[0, i] = jpp.joint_3d_to_img(xyz, NYU_PARAS, flip=-1)
        centers.append(center)
    sio.savemat(f'{root}/{split}/joint_data.mat',
                {'joint_uvd': joint_uvd, 'joint_xyz': joint_xyz})
    np.savetxt(f'{root}/{split}/center_{split}_refined.txt',
               np.asarray(centers))


@pytest.fixture(scope='module')
def nyu_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('nyu'))
    _write_nyu(root, 'train', 8)
    _write_nyu(root, 'test', 8)
    return root


STB_TRAIN = ['B2Counting', 'B2Random', 'B3Counting', 'B3Random',
             'B4Counting', 'B4Random', 'B5Counting', 'B5Random',
             'B6Counting', 'B6Random']


def _write_stb_sequence(root, seq, frames, seed):
    import scipy.io as sio
    os.makedirs(f'{root}/STB/{seq}', exist_ok=True)
    rng = np.random.RandomState(seed)
    fx, fy, tx, ty = ds.STBDataset.cam_para
    hand = np.zeros((3, 21, 1500))
    for i in range(frames):
        center = np.array([(320 - tx) * 600 / fx, (240 - ty) * 600 / fy,
                           600.0])
        hand[:, :, i] = (center[None] + rng.uniform(-50, 50, (21, 3))).T
        depth = np.zeros((480, 640), np.float32)
        depth[200:280, 280:360] = rng.uniform(560, 660, (80, 80))
        img = np.zeros((480, 640, 3), np.uint8)
        raw = depth.astype(np.int32)
        img[..., 2] = raw % 256
        img[..., 1] = raw // 256
        cv2.imwrite(f'{root}/STB/{seq}/SK_depth_{i}.png', img)
        cv2.imwrite(f'{root}/STB/{seq}/SK_color_{i}.png',
                    rng.randint(0, 255, (480, 640, 3)).astype(np.uint8))
    sio.savemat(f'{root}/STB/labels/{seq}_SK.mat', {'handPara': hand})


@pytest.fixture(scope='module')
def stb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('stb'))
    os.makedirs(f'{root}/STB/labels', exist_ok=True)
    _write_stb_sequence(root, 'B1Counting', 8, seed=2)
    for k, seq in enumerate(STB_TRAIN):
        _write_stb_sequence(root, seq, 8 if k == 0 else 0, seed=3 + k)
    return root


# ----------------------------------------------------------------- tests ---

@pytest.mark.parametrize('split', ['train', 'test'])
def test_dexycb_matches_jax(dexycb_root, split, numpy_route):
    """Left and right hands, 10 frames, every index and some again (the
    RNGs go on drawing)."""
    port = ds.DexYCBDataset('s0', split, dexycb_root, sample_num=256)
    want = jds.DexYCBDataset('s0', split, dexycb_root, sample_num=256)
    _same_samples(port, want, list(range(10)) + [3, 3, 7])


@pytest.mark.parametrize('name', ['dexycb', 'ho3d', 'nyu', 'STB'])
def test_test_split_against_native_core(name, request):
    """The JAX module's default eval route, its native core when built
    (the numpy route otherwise, which the port then takes too), against
    the port's default route, bit for bit."""
    root = request.getfixturevalue(f'{name.lower()}_root')
    cfg = Config(dataset=name, root_dir=root, point_num=128)
    jcfg = JConfig(dataset=name, root_dir=root, point_num=128)
    port = ds.make_dataset(cfg, 'test')
    port.use_native = native.available()
    _same_samples(port, jds.make_dataset(jcfg, 'test'), range(8))


@pytest.mark.parametrize('version', ['v2', 'v3'])
@pytest.mark.parametrize('split', ['train', 'test'])
@pytest.mark.parametrize('center_type', ['refine', 'joint_mean'])
def test_ho3d_matches_jax(ho3d_root, version, split, center_type,
                         numpy_route):
    """v2 colour in PNG, v3 in JPEG; RG-encoded depth; refined centres
    or the joints' mean; colour jitter in the train split."""
    port = ds.HO3D(split, ho3d_root, version=version, sample_num=128,
                   center_type=center_type)
    want = jds.HO3D(split, ho3d_root, version=version, sample_num=128,
                    center_type=center_type)
    _same_samples(port, want, list(range(8)) + [5])


@pytest.mark.parametrize('split', ['train', 'test'])
def test_nyu_matches_jax(nyu_root, split, numpy_route):
    """The .mat labels, the 23-joint selection, refined centres, missing
    RGB frames read as zeros."""
    port = ds.NYUDataset(nyu_root, split, sample_num=128)
    want = jds.NYUDataset(nyu_root, split, sample_num=128)
    _same_samples(port, want, list(range(8)) + [2])
    np.testing.assert_array_equal(port.joint_kernel, want.joint_kernel)


@pytest.mark.parametrize('split', ['train', 'test'])
def test_stb_matches_jax(stb_root, split, numpy_route):
    """The SK extrinsics (Rodrigues), the keypoint reorder, the wrist
    extrapolation and the ImageNet normalization on the 255 scale."""
    port = ds.STBDataset(split, stb_root, sample_num=128)
    want = jds.STBDataset(split, stb_root, sample_num=128)
    _same_samples(port, want, list(range(8)) + [0])


def test_make_dataset_and_batch_loader(dexycb_root, ho3d_root, nyu_root,
                                       stb_root, numpy_route):
    """make_dataset builds each dataset from the Config as the JAX
    factory does; BatchLoader over the port's DexYCB train split gives
    the JAX loader's batches, shuffled, in the same order."""
    for name, root in (('dexycb', dexycb_root), ('ho3d', ho3d_root),
                       ('nyu', nyu_root), ('STB', stb_root)):
        cfg = Config(dataset=name, root_dir=root, point_num=64)
        jcfg = JConfig(dataset=name, root_dir=root, point_num=64)
        port, want = ds.make_dataset(cfg, 'test'), jds.make_dataset(jcfg,
                                                                    'test')
        assert type(port).__name__ == type(want).__name__
        _same_samples(port, want, [0, 1])
    cfg = Config(root_dir=dexycb_root, point_num=64)
    jcfg = JConfig(root_dir=dexycb_root, point_num=64)
    loaders = [L(make(c, 'train'), batch_size=3, shuffle=True,
                 num_workers=1, seed=5)
               for L, make, c in ((BatchLoader, ds.make_dataset, cfg),
                                  (JBatchLoader, jds.make_dataset, jcfg))]
    for epoch in range(2):
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in KEYS:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_missing_image_raises(dexycb_root, tmp_path):
    """A frame that does not decode is an IOError, never a skipped
    sample."""
    import shutil
    root = str(tmp_path / 'copy')
    shutil.copytree(dexycb_root, root)
    os.remove(f'{root}/DexYCB/imgs/color_000002.jpg')
    port = ds.DexYCBDataset('s0', 'test', root, sample_num=64)
    with pytest.raises(IOError, match='color_000002'):
        port[2]
    with open(f'{root}/DexYCB/imgs/aligned_depth_to_color_000004.png',
              'r+b') as f:
        f.truncate(100)
    with pytest.raises(IOError, match='aligned_depth_to_color_000004'):
        port[4]


FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'torch_port_dexycb')


def test_committed_fixture():
    """tests/fixtures/torch_port_dexycb (scripts/make_torch_port_fixture.py):
    the port decodes its images to the stored cv2 decode and builds the
    stored JAX samples (the numpy route's), bit for bit, as
    chip_smoke.py's [data] phase checks where there is no cv2 and no
    JAX."""
    from keypointfusion_torch.data.image_io import imread
    decoded = np.load(os.path.join(FIXTURE, 'decoded.npz'))
    imgs = os.path.join(FIXTURE, 'DexYCB', 'imgs')
    assert len(decoded.files) == 8
    for name in decoded.files:
        colour = name.startswith('color_')
        path = os.path.join(imgs, name + ('.jpg' if colour else '.png'))
        np.testing.assert_array_equal(imread(path, anydepth=not colour),
                                      decoded[name])
        want = cv2.imread(path, cv2.IMREAD_COLOR if colour
                          else cv2.IMREAD_ANYDEPTH)
        np.testing.assert_array_equal(decoded[name], want)
    samples = np.load(os.path.join(FIXTURE, 'samples.npz'))
    for split, indices in (('train', (1, 2)), ('test', (0, 3))):
        port = ds.DexYCBDataset('s0', split, FIXTURE, sample_num=1024,
                                seed=7)
        port.use_native = False
        for i in indices:
            got = port[i]
            for k in KEYS:
                np.testing.assert_array_equal(got[k],
                                              samples[f'{split}_{i}_{k}'],
                                              err_msg=f'{split} {i} {k}')
        assert 900 < len(np.unique(got['pcl'], axis=0)) <= 1024
