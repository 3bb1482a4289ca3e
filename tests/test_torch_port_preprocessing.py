"""The port's host preprocessing on the CPU: data/cv_ops.py against the cv2
calls it replaces, and data/preprocessing.py against the JAX package's
keypointfusion_tpu/data/preprocessing.py, on inputs made from numpy
seeds.

Tolerance: 0 throughout. The cv_ops functions must give cv2's arrays
(nearest-neighbour pixels, and matrices in the same order of double
operations); every preprocessing function must give the JAX module's
arrays bit for bit, floats included, since the port keeps its numpy
arithmetic and its cv2 calls give cv2's pixels.
"""

import random

import cv2
import numpy as np
import pytest

from keypointfusion_tpu.data import preprocessing as jpp
from keypointfusion_torch.data import cv_ops
from keypointfusion_torch.data import preprocessing as pp

PARAS = (600.0, 600.0, 320.0, 240.0)
CUBE = [250., 250., 250.]


def _equal(got, want, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------- cv_ops ---

def _image(r, h, w, channels):
    shape = (h, w, channels) if channels else (h, w)
    return r.rand(*shape).astype(np.float32)


def test_resize_nearest():
    """Random sizes up and down, one and three channels, and the exact
    integer ratios where x * (1 / fx) and x * w_src / w differ."""
    r = np.random.RandomState(0)
    cases = [(int(r.randint(1, 300)), int(r.randint(1, 300)),
              int(r.randint(1, 200)), int(r.randint(1, 200)))
             for _ in range(120)]
    cases += [(250, 250, 128, 128), (100, 300, 128, 42), (3, 7, 21, 9),
              (128, 128, 128, 128), (49, 98, 128, 64)]
    for i, (sh, sw, w, h) in enumerate(cases):
        src = _image(r, sh, sw, 3 if i % 2 else 0)
        _equal(cv_ops.resize(src, (w, h)),
               cv2.resize(src, (w, h), interpolation=cv2.INTER_NEAREST),
               str((sh, sw, w, h)))


@pytest.mark.parametrize('channels', [0, 3])
def test_warp_affine_nearest(channels):
    """Rotations of 0/90/180/270 degrees and random angles about the
    centre, scales around 1, off-image shifts; sizes that leave a tail
    past cv2's 16-column vector step; the matrix of
    get_rotation_matrix_2d equal to cv2's."""
    r = np.random.RandomState(1 + channels)
    angles = [0, 90, 180, 270, -90, 360, 45]
    for i in range(160):
        n = 128 if i % 2 else int(r.randint(3, 150))
        src = _image(r, n, n, channels)
        angle = angles[i % 7] if i < 28 else r.uniform(-360, 360)
        scale = 1.0 if i < 14 else r.uniform(0.85, 1.15)
        center = (n // 2, n // 2)
        M = cv2.getRotationMatrix2D(center, -angle, scale)
        _equal(cv_ops.get_rotation_matrix_2d(center, -angle, scale), M)
        if i % 3 == 0:
            M[:, 2] += r.uniform(-2 * n, 2 * n, 2)     # partly off-image
        for border in (0.0, 2.5):
            want = cv2.warpAffine(src, M, (n, n), flags=cv2.INTER_NEAREST,
                                  borderMode=cv2.BORDER_CONSTANT,
                                  borderValue=border)
            _equal(cv_ops.warp_affine(src, M, (n, n), border), want,
                   f'case {i}, border {border}')
        _equal(cv_ops.invert_affine(M), cv2.invertAffineTransform(M))


@pytest.mark.parametrize('channels', [0, 3])
def test_warp_perspective_nearest(channels):
    """Crop-to-crop transforms as recrop_hand builds them (a scale and
    shift composed with another's inverse), some with a perspective row,
    some mapping mostly off the image; both border values; the inverse
    equal to cv2.invert's."""
    r = np.random.RandomState(3 + channels)
    for i in range(160):
        n = 128 if i % 2 else int(r.randint(3, 150))
        src = _image(r, n, n, channels)

        def crop():
            s = r.uniform(0.5, 2.0)
            return np.array([[s, 0, r.uniform(-n, n)],
                             [0, s, r.uniform(-n, n)], [0, 0, 1.]])
        M = np.dot(crop(), np.linalg.inv(crop()))
        if i % 5 == 0:
            M = M + r.uniform(-1e-3, 1e-3, (3, 3)) * [[1, 1, 1], [1, 1, 1],
                                                       [0.01, 0.01, 0]]
        _equal(cv_ops.invert_3x3(M), cv2.invert(M, flags=cv2.DECOMP_LU)[1])
        for border in (0.0, 3.5):
            want = cv2.warpPerspective(src, M, (n, n),
                                       flags=cv2.INTER_NEAREST,
                                       borderMode=cv2.BORDER_CONSTANT,
                                       borderValue=border)
            _equal(cv_ops.warp_perspective(src, M, (n, n), border), want,
                   f'case {i}, border {border}')


def test_rodrigues():
    r = np.random.RandomState(4)
    vectors = [np.array([0.00531, -0.01196, 0.00301]), np.zeros(3)]
    vectors += [r.uniform(-3, 3, 3) * s for s in (1, 1e-3, 1e-9)
                for _ in range(40)]
    for v in vectors:
        _equal(cv_ops.rodrigues(v), cv2.Rodrigues(v)[0], str(v))


# --------------------------------------------------------- preprocessing ---

@pytest.fixture(scope='module')
def scene():
    """A raw depth frame with a hand-sized blob at ~600 mm, an RGB frame,
    a CoM and joints in camera mm around the blob."""
    r = np.random.RandomState(0)
    depth = np.zeros((480, 640), np.float32)
    depth[190:290, 270:370] = r.uniform(560, 660, (100, 100))
    rgb = r.randint(0, 255, (480, 640, 3)).astype(np.float32)
    com_uvd = np.array([321.3, 238.7, 611.0])
    com_xyz = jpp.joint_img_to_3d(com_uvd, PARAS)
    joints = com_xyz[None] + r.uniform(-60, 60, (21, 3))
    return depth, rgb, com_uvd, com_xyz, joints


def test_camera_and_bounds(scene):
    depth, _, com_uvd, com_xyz, joints = scene
    for flip in (1.0, -1.0):
        _equal(pp.joint_3d_to_img(joints, PARAS, flip),
               jpp.joint_3d_to_img(joints, PARAS, flip))
        uvd = jpp.joint_3d_to_img(joints, PARAS, flip)
        _equal(pp.joint_img_to_3d(uvd, PARAS, flip),
               jpp.joint_img_to_3d(uvd, PARAS, flip))
    M = jpp.com_to_transform(com_uvd, CUBE, (128, 128), PARAS)
    _equal(pp.transform_points_2d(joints, M),
           jpp.transform_points_2d(joints, M))
    for cube in (CUBE, [200., 200., 200.], [280., 300., 250.]):
        assert pp.com_to_bounds(com_uvd, cube, PARAS) == \
            jpp.com_to_bounds(com_uvd, cube, PARAS)
        _equal(pp.com_to_transform(com_uvd, cube, (128, 128), PARAS),
               jpp.com_to_transform(com_uvd, cube, (128, 128), PARAS))
    bounds = jpp.com_to_bounds(com_uvd, CUBE, PARAS)
    for thresh in (True, False):
        _equal(pp.get_crop(depth, *bounds, thresh_z=thresh),
               jpp.get_crop(depth, *bounds, thresh_z=thresh))
    off_image = jpp.com_to_bounds(np.array([20., 15., 400.]), CUBE, PARAS)
    _equal(pp.get_crop(depth, *off_image), jpp.get_crop(depth, *off_image))


def test_crops_and_normalization(scene):
    depth, rgb, com_uvd, _, _ = scene
    coms = [com_uvd, np.array([30., 460., 700.]), np.array([600., 20., 450.])]
    for com in coms:
        for size in (128, 96):
            got = pp.crop_area_3d(depth, com, CUBE, (size, size), PARAS)
            want = jpp.crop_area_3d(depth, com, CUBE, (size, size), PARAS)
            _equal(got[0], want[0])
            _equal(got[1], want[1])
            got = pp.crop_area_3d(rgb, com, CUBE, (size, size), PARAS,
                                  thresh_z=False)
            want = jpp.crop_area_3d(rgb, com, CUBE, (size, size), PARAS,
                                    thresh_z=False)
            _equal(got[0], want[0])
            _equal(got[1], want[1])
        crop, _ = jpp.crop_area_3d(depth, com, CUBE, (128, 128), PARAS)
        _equal(pp.normalize_img(crop.max(), crop, com, CUBE),
               jpp.normalize_img(crop.max(), crop, com, CUBE))


def test_augmentations(scene):
    """rand_augment draws the same modes and parameters from the same
    random.Random; move_com, rotate_hand, scale_hand and recrop_hand,
    and augment_crop in each mode on depth and RGB crops, give the JAX
    module's arrays (rotate_hand leaves M as it was, in both)."""
    depth, rgb, com_uvd, com_xyz, joints = scene
    crop, M = jpp.crop_area_3d(depth, com_uvd, CUBE, (128, 128), PARAS)
    rgb_crop, M_rgb = jpp.crop_area_3d(rgb, com_uvd, CUBE, (128, 128),
                                       PARAS, thresh_z=False)
    gt = joints - com_xyz
    a, b = random.Random(7), random.Random(7)
    for _ in range(20):
        got = pp.rand_augment(a, 10., 0.2, 180.)
        want = jpp.rand_augment(b, 10., 0.2, 180.)
        assert got[0] == want[0] and got[2] == want[2] \
            and got[3] == want[3]
        _equal(got[1], want[1])

    for off in (np.array([12., -8., 5.]), np.zeros(3),
                np.array([-60., 40., -30.])):
        for g, w in zip(pp.move_com(crop, CUBE, com_uvd, off, gt, M, PARAS),
                        jpp.move_com(crop, CUBE, com_uvd, off, gt, M,
                                     PARAS)):
            _equal(g, w)
    for rot in (0., 90., -37.5, 180., 271.3):
        for g, w in zip(pp.rotate_hand(crop, CUBE, com_uvd, rot, gt, PARAS),
                        jpp.rotate_hand(crop, CUBE, com_uvd, rot, gt,
                                        PARAS)):
            _equal(g, w)
    for sc in (1.0, 0.83, 1.17):
        for g, w in zip(pp.scale_hand(crop, CUBE, com_uvd, sc, gt, M, PARAS),
                        jpp.scale_hand(crop, CUBE, com_uvd, sc, gt, M,
                                       PARAS)):
            _equal(np.asarray(g), np.asarray(w))
    Mnew = jpp.com_to_transform(com_uvd + [5., -3., 10.], CUBE,
                                (128, 128), PARAS)
    for thresh in (True, False):
        _equal(pp.recrop_hand(crop, M, np.linalg.inv(Mnew), crop.shape,
                              PARAS, nv_val=500., thresh_z=thresh,
                              com=com_uvd),
               jpp.recrop_hand(crop, M, np.linalg.inv(Mnew), crop.shape,
                               PARAS, nv_val=500., thresh_z=thresh,
                               com=com_uvd))

    r = random.Random(3)
    for mode in range(4):
        _, off, rot, sc = jpp.rand_augment(r, 35., 0.1, 180.)
        for img, m, rgb_mode in ((crop, M, False), (rgb_crop, M_rgb, True)):
            got = pp.augment_crop(img, gt, com_uvd, CUBE, m, mode, off, rot,
                                  sc, PARAS, rgb=rgb_mode)
            want = jpp.augment_crop(img, gt, com_uvd, CUBE, m, mode, off,
                                    rot, sc, PARAS, rgb=rgb_mode)
            for g, w in zip(got, want):
                _equal(np.asarray(g), np.asarray(w), f'mode {mode}')


def test_point_clouds(scene):
    depth, _, com_uvd, com_xyz, _ = scene
    crop, M = jpp.crop_area_3d(depth, com_uvd, CUBE, (128, 128), PARAS)
    norm = jpp.normalize_img(crop.max(), crop, com_xyz, CUBE)
    _equal(pp.depth_to_pcl(crop, M, PARAS), jpp.depth_to_pcl(crop, M, PARAS))
    pcl = jpp.get_pcl(norm.copy(), com_xyz, np.asarray(CUBE), M, PARAS)
    _equal(pp.get_pcl(norm.copy(), com_xyz, np.asarray(CUBE), M, PARAS),
           pcl)
    for num in (1024, 64, pcl.shape[0] + 7):
        _equal(pp.sample_pcl(pcl, num, np.random.RandomState(num)),
               jpp.sample_pcl(pcl, num, np.random.RandomState(num)))
    _equal(pp.sample_pcl(pcl[:0], 16, np.random.RandomState(0)),
           jpp.sample_pcl(pcl[:0], 16, np.random.RandomState(0)))
