"""The port's drawing (keypointfusion_torch/utils/raster.py, utils/vis.py)
and PNG writing (data/image_io.py:imwrite) against cv2 5.0 and the JAX
package's utils/vis.py, which draws with cv2: every comparison is bit for
bit, on inputs from numpy seeds.

  * raster: filled circles (radius 0-8) and LINE_8 lines of thickness 1,
    2, 3 and 5 against cv2.circle / cv2.line on grey, BGR and BGRA images,
    with end points inside, on the border of and far outside the image
    (clipped), coincident end points and all eight octants.
  * vis: every table and getter for every dataset name; every renderer
    on joints inside, on the edge of and outside the crop, and draw_pose's
    stop conditions (more joints than colours, bones past the joints).
  * imwrite: uint8 grey, BGR and BGRA and uint16 grey written by the port
    and read back by cv2.imread and by the port's imread.
"""

import cv2
import numpy as np
import pytest

from keypointfusion_tpu.utils import vis as jvis

from keypointfusion_torch.data.image_io import imread, imwrite
from keypointfusion_torch.utils import raster
from keypointfusion_torch.utils import vis

DATASETS = ('nyu', 'nyu_all', 'icvl', 'msra', 'itop', 'shrec', 'DHG14',
            'dexycb', 'ho3d', 'STB', 'hands17')


def _image(rng, shape):
    return rng.randint(0, 256, shape).astype(np.uint8)


# ---------------------------------------------------------------- raster --

def test_circle_matches_cv2():
    """Filled circles, radius 0-8, centres from -12 to 50 on 1-, 3- and
    4-channel images of up to 40 pixels a side."""
    rng = np.random.RandomState(0)
    for _ in range(400):
        h, w = rng.randint(1, 41, 2)
        shape = [(h, w), (h, w, 3), (h, w, 4)][rng.randint(3)]
        img = _image(rng, shape)
        centre = tuple(int(c) for c in rng.randint(-12, 51, 2))
        radius = int(rng.randint(0, 9))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.circle(img.copy(), centre, radius, color, -1)
        got = raster.circle(img.copy(), centre, radius, color)
        assert np.array_equal(got, want), (shape, centre, radius)


@pytest.mark.parametrize('thickness', [1, 2, 3, 5])
def test_line_matches_cv2(thickness):
    """LINE_8 lines between end points from -40 to 80 on images of up to
    40 pixels a side (most of them clipped), coincident end points, every
    octant from the centre of a 31x31 image, and the border rows and
    columns. Thicker lines are cv2 5.0's: ThickLine between end points
    clipped to the image grown by the thickness."""
    rng = np.random.RandomState(thickness)
    cases = []
    for _ in range(300):
        h, w = rng.randint(1, 41, 2)
        p0 = tuple(int(c) for c in rng.randint(-40, 81, 2))
        p1 = p0 if rng.rand() < 0.05 else tuple(
            int(c) for c in rng.randint(-40, 81, 2))
        cases.append(((h, w, 3), p0, p1))
    for dx, dy in ((13, 4), (4, 13), (-4, 13), (-13, 4), (-13, -4),
                   (-4, -13), (4, -13), (13, -4), (9, 9), (-9, 9), (0, 12),
                   (12, 0), (0, -12), (-12, 0)):
        cases.append(((31, 31, 3), (15, 15), (15 + dx, 15 + dy)))
    cases += [((20, 30), (0, 0), (29, 0)), ((20, 30), (29, 0), (29, 19)),
              ((20, 30), (0, 19), (29, 19)), ((20, 30), (-5, -5), (40, 30)),
              ((20, 30), (3, 3), (3, 3)), ((20, 30, 4), (-1, 5), (30, 5)),
              ((20, 30), (-300, 7), (500, 9))]
    for shape, p0, p1 in cases:
        img = _image(rng, shape)
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.line(img.copy(), p0, p1, color, thickness)
        got = raster.line(img.copy(), p0, p1, color, thickness)
        assert np.array_equal(got, want), (shape, p0, p1)


def test_bad_arguments_are_refused_and_grey_converts():
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError):
        raster.line(img, (1, 1), (9, 5), (255, 0, 0), 0)
    with pytest.raises(NotImplementedError):
        raster.circle(img, (1, 1), 2, (255, 0, 0), 1)
    with pytest.raises(TypeError):
        raster.circle(np.zeros((4, 4), np.float32), (1, 1), 1, (1,))
    assert not img.any()
    grey = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert np.array_equal(raster.gray_to_bgr(grey),
                          cv2.cvtColor(grey, cv2.COLOR_GRAY2BGR))
    assert np.array_equal(raster.gray_to_bgr(grey[..., None]),
                          cv2.cvtColor(grey, cv2.COLOR_GRAY2BGR))


# ------------------------------------------------------------------- vis --

def test_tables_match_jax():
    for name in ('COLORS', 'FINGER_COLORS', 'THUMB', 'INDEX', 'MIDDLE',
                 'RING', 'LITTLE', 'WRIST', 'HAND_SKELETON', 'NYU_SKELETON',
                 'NYU_ALL_SKELETON', 'ICVL_SKELETON', 'MSRA_SKELETON',
                 'ITOP_SKELETON', 'SHREC_SKELETON'):
        assert getattr(vis, name) == getattr(jvis, name), name
    for dataset in DATASETS:
        for fn in ('get_sketch_setting', 'get_skeleton', 'get_sketch_color',
                   'get_joint_color', 'get_hierarchy_mapping',
                   'get_hierarchy_sketch'):
            assert getattr(vis, fn)(dataset) == getattr(jvis, fn)(
                dataset), (fn, dataset)


def _joints(rng, n, size):
    """n joints in pixels: inside, near the border and outside a crop of
    `size`, and exactly on its edges."""
    pts = rng.uniform(-0.3 * size, 1.3 * size, (n, 3))
    edges = [0.0, size - 1.0, float(size), -1.0, size - 0.5, -0.5]
    for i in range(min(n, 6)):
        pts[i, i % 2] = edges[i]
    return pts


@pytest.mark.parametrize('dataset', DATASETS)
def test_renderers_match_jax(dataset):
    """draw_point, draw_pose at scale 1 and 2 (every joint; more joints
    than colours; too few joints, which ends the bones), draw_visible,
    draw_2d_pose, draw_2d_pose_only and draw_2d_pose_rgb, bit for bit."""
    rng = np.random.RandomState(sum(map(ord, dataset)))
    size = 64
    n = max(max(b) for b in vis.get_sketch_setting(dataset)) + 1
    n = max(n, len(vis.get_joint_color(dataset)))
    img = _image(rng, (size, size, 3))
    for count in (n, n + 3, n // 2):
        pose = _joints(rng, count, size)
        for fn in ('draw_point', 'draw_pose'):
            got = getattr(vis, fn)(dataset, img.copy(), pose)
            want = getattr(jvis, fn)(dataset, img.copy(), pose)
            assert np.array_equal(got, want), (fn, count)
        assert np.array_equal(
            vis.draw_pose(dataset, img.copy(), pose, scale=2),
            jvis.draw_pose(dataset, img.copy(), pose, scale=2)), count
    pose = _joints(rng, n, size)
    visible = rng.randint(0, 2, n)
    assert np.array_equal(
        vis.draw_visible(dataset, img.copy(), pose, visible),
        jvis.draw_visible(dataset, img.copy(), pose, visible))
    uvd_nl = rng.uniform(-1.4, 1.4, (n, 3))
    uvd_nl[:4, 0] = [-1.0, 1.0, 0.999, -0.999]
    depth = rng.uniform(-1, 1, (size, size, 1)).astype(np.float32)
    rgb = rng.rand(size, size, 3).astype(np.float32)
    for fn, args in (('draw_2d_pose', (depth, uvd_nl, dataset)),
                     ('draw_2d_pose_only', (uvd_nl, size, dataset)),
                     ('draw_2d_pose_rgb', (rgb, uvd_nl, dataset))):
        got, want = getattr(vis, fn)(*args), getattr(jvis, fn)(*args)
        assert got.dtype == np.uint8 and np.array_equal(got, want), fn


# --------------------------------------------------------------- imwrite --

@pytest.mark.parametrize('shape,dtype', [((7, 5), np.uint8),
                                         ((7, 5, 1), np.uint8),
                                         ((6, 9, 3), np.uint8),
                                         ((6, 9, 4), np.uint8),
                                         ((9, 4), np.uint16),
                                         ((1, 1, 3), np.uint8)])
def test_imwrite_round_trips(tmp_path, shape, dtype):
    """cv2.imread(IMREAD_UNCHANGED) gives the array back; the port's
    imread gives it (grey and 16-bit with anydepth; colour as BGR, alpha
    dropped, as cv2.imread without flags)."""
    rng = np.random.RandomState(len(shape) * 7 + shape[0])
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / 'x.png')
    imwrite(path, img)
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
    if want.ndim == 2:
        assert np.array_equal(imread(path, anydepth=True), want)
    else:
        assert np.array_equal(imread(path), want[..., :3])
        assert np.array_equal(cv2.imread(path), want[..., :3])


def test_imwrite_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError):
        imwrite(str(tmp_path / 'x.jpg'), np.zeros((2, 2, 3), np.uint8))
    for bad in (np.zeros((2, 2), np.float32), np.zeros((2, 2, 3), np.uint16),
                np.zeros((2, 2, 2), np.uint8), np.zeros((0, 3), np.uint8)):
        with pytest.raises(ValueError):
            imwrite(str(tmp_path / 'x.png'), bad)
