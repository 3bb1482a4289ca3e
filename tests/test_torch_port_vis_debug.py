"""The port's debug renderers (keypointfusion_torch/utils/vis.py's
draw_heatmap, draw_offset_field, draw_pcl*, debug_* writers,
draw_muti_pic, debug_mesh) and the cv2 counterparts they draw with
(data/cv_ops.py's resize_linear, add_weighted, apply_colormap_jet,
to_u8_saturate; utils/raster.py's arrowed_line) against cv2 5.0 and the
JAX package's utils/vis.py, on inputs from numpy seeds.

Tolerance 0 everywhere: returned arrays equal in dtype, shape and value;
written PNGs equal as cv2.imread and the port's imread read them back;
.obj files equal byte for byte. The one exception is draw_muti_pic's
caption (the port's 5x7 bitmap font where cv2 5.0 draws anti-aliased
TrueType): its pixels may differ inside the box cv2.getTextSize gives
for the caption (its height above the baseline at (15, 15), the baseline
below it, 2 px of margin around), and must equal cv2's outside it; a
control shows that the box does differ.

No JAX computation runs here: the JAX module is numpy and cv2.
"""

import os

import cv2
import numpy as np
import pytest

from keypointfusion_tpu.utils import vis as jvis

from keypointfusion_torch.data import cv_ops
from keypointfusion_torch.data.image_io import imread
from keypointfusion_torch.utils import raster
from keypointfusion_torch.utils import vis
from tests import torch_port_vis_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got, want))


# ---------------------------------------------------------------- cv_ops --

def test_resize_linear_matches_cv2():
    """Ratios 0.3-4.0 on sizes 2-139 (odd and prime ones among them),
    the heatmaps' 8-32 -> 128, the same size, values from 1e-4 to 1e3 of
    both signs; a source of one row or one column is refused."""
    rng = np.random.RandomState(0)
    shapes = [((s, s), (128, 128)) for s in (8, 16, 32, 17, 33, 100, 128)]
    shapes += [((2, 2), (7, 5)), ((3, 3), (200, 11)), ((64, 64), (32, 32)),
               ((29, 59), (27, 99)), ((22, 39), (66, 105))]
    for _ in range(250):
        sh, sw = rng.randint(2, 140, 2)
        r = rng.uniform(0.3, 4.0, 2)
        shapes.append(((sh, sw), (max(1, int(sh * r[0])),
                                  max(1, int(sw * r[1])))))
    for (sh, sw), (h, w) in shapes:
        src = (rng.randn(sh, sw) * rng.choice([1e-4, 1.0, 1e3])).astype(
            np.float32)
        assert _same(cv_ops.resize_linear(src, (w, h)),
                     cv2.resize(src, (w, h))), ((sh, sw), (h, w))
    for bad in (np.zeros((1, 8), np.float32), np.zeros((8, 1), np.float32),
                np.zeros((8, 8), np.float64), np.zeros((8, 8, 3), np.float32)):
        with pytest.raises(ValueError):
            cv_ops.resize_linear(bad, (16, 16))


def test_add_weighted_matches_cv2():
    """Random weights (negative and above 1 too) and offsets, the
    renderers' 0.5 / 0.5 (every sum a .5 case), grey and BGR images of
    sizes that leave a vector tail."""
    rng = np.random.RandomState(1)
    for t in range(200):
        shape = [(13, 17, 3), (64, 64, 3), (5, 7), (128, 128, 3),
                 (1, 37, 3)][t % 5]
        a = rng.randint(0, 256, shape).astype(np.uint8)
        b = rng.randint(0, 256, shape).astype(np.uint8)
        alpha = [0.5, 0.3, rng.rand(), rng.rand() * 2 - 0.5][t % 4]
        beta = [0.5, 1 - alpha, rng.rand(), 0.7][(t // 4) % 4]
        gamma = [0.0, rng.rand() * 20 - 10, 0.5][t % 3]
        assert _same(cv_ops.add_weighted(a, alpha, b, beta, gamma),
                     cv2.addWeighted(a, alpha, b, beta, gamma)), t
    with pytest.raises(ValueError):
        cv_ops.add_weighted(np.zeros((2, 2), np.uint8), 0.5,
                            np.zeros((2, 3), np.uint8), 0.5, 0)


def test_apply_colormap_jet_matches_cv2():
    """All 256 entries, on [H, W] and [H, W, 1] images."""
    u = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = cv2.applyColorMap(u, cv2.COLORMAP_JET)
    assert _same(cv_ops.apply_colormap_jet(u), want)
    assert _same(cv_ops.apply_colormap_jet(u[..., None]), want)
    with pytest.raises(ValueError):
        cv_ops.apply_colormap_jet(u.astype(np.float32))


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int32])
def test_to_u8_saturate_matches_cv2_imwrite(tmp_path, dtype):
    """What cv2.imwrite writes for an image of another depth than 8 or 16
    bits, read back: halves to even, saturation, and 0 for NaN, the
    infinities and values past the int32 range."""
    rng = np.random.RandomState(2)
    if dtype == np.int32:
        v = rng.randint(-70000, 70000, 300).astype(np.int32)
        v[:4] = (-1, 0, 255, 256)
    else:
        v = (rng.randn(300) * 300).astype(dtype)
        v[:19] = (0.5, 1.5, 2.5, 100.5, 254.5, 255.5, 300.7, -3, -0.5,
                  -0.6, 3e9, -3e9, 2.0 ** 31, 2.0 ** 31 - 128, np.inf,
                  -np.inf, np.nan, 1e20, 127.49999)
    img = np.stack([v.reshape(10, 30)] * 3, -1)
    path = str(tmp_path / 'x.png')
    assert cv2.imwrite(path, img)
    assert _same(cv_ops.to_u8_saturate(img), cv2.imread(path))


# ---------------------------------------------------------------- raster --

@pytest.mark.parametrize('thickness', [1, 2, 3])
def test_arrowed_line_matches_cv2(thickness):
    """Arrows in every octant from the centre of a 41 x 41 image, on its
    axes and diagonals, zero-length ones, tips past the border, and random
    end points from -30 to 80 on images of up to 49 pixels a side (most of
    them clipped), at tip lengths 0.1-1."""
    rng = np.random.RandomState(thickness)
    cases_ = []
    for dx, dy in ((13, 4), (4, 13), (-4, 13), (-13, 4), (-13, -4),
                   (-4, -13), (4, -13), (13, -4), (9, 9), (-9, 9), (0, 12),
                   (12, 0), (0, -12), (-12, 0), (0, 0), (1, 0), (20, 1)):
        cases_.append(((41, 41, 3), (20, 20), (20 + dx, 20 + dy), 0.3))
    cases_.append(((41, 41, 3), (2, 2), (0, 0), 1.0))
    for t in range(600):
        h, w = rng.randint(1, 50, 2)
        p0 = tuple(int(c) for c in rng.randint(-30, 81, 2))
        p1 = p0 if t % 40 == 0 else tuple(
            int(c) for c in rng.randint(-30, 81, 2))
        tip = [0.3, 0.1, 0.5, 1.0, float(rng.rand())][t % 5]
        cases_.append(((h, w, 3), p0, p1, tip))
    for shape, p0, p1, tip in cases_:
        img = rng.randint(0, 256, shape).astype(np.uint8)
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.arrowedLine(img.copy(), p0, p1, color, thickness,
                               tipLength=tip)
        got = raster.arrowed_line(img.copy(), p0, p1, color, thickness, tip)
        assert np.array_equal(got, want), (shape, p0, p1, tip)


# ------------------------------------------------------------ renderers --

@pytest.fixture(scope='module')
def both_outputs(tmp_path_factory):
    """tests/torch_port_vis_cases.py's every call, through the JAX module
    (files read back by cv2.imread) and through the port (by imread)."""
    inp = cases.case_inputs()
    want = cases.case_outputs(jvis, cv2.imread,
                              str(tmp_path_factory.mktemp('jax')), inp)
    got = cases.case_outputs(vis, imread,
                             str(tmp_path_factory.mktemp('port')), inp)
    return got, want


RENDERERS = ('draw_heatmap', 'draw_offset_field', 'draw_pcl',
             'draw_pcl_batch', 'debug_2d_img', 'debug_2d_pose',
             'debug_img_heatmap', 'debug_2d_heatmap', 'draw_muti_pic',
             'file:')


@pytest.mark.parametrize('prefix', RENDERERS)
def test_renderers_match_jax(both_outputs, prefix):
    """Each renderer's returned arrays, and every written file (prefix
    'file:': debug_2d_img, debug_2d_pose(_select), debug_img_heatmap,
    debug_2d_heatmap, debug_visible_joint, debug_pcl_pose, draw_muti_pic
    and debug_mesh, under the JAX package's names), bit for bit."""
    got, want = both_outputs
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got if k.startswith(prefix))
    differ = [k for k in keys if not _same(got[k], want[k])]
    assert not differ, differ


def test_writers_return_and_write_as_jax(both_outputs):
    """The writers' return values and files: debug_img_heatmap's float32
    squeezed stack, debug_2d_heatmap's 0 for an empty batch, and the file
    names, one per (sample, channel or joint), with the same count."""
    got, want = both_outputs
    assert got['debug_img_heatmap'].dtype == np.float32
    assert got['debug_img_heatmap'].shape == (4 * 21, 128, 128, 3)
    assert got['debug_2d_heatmap'].shape == (4 * 21, 64, 64, 3)
    assert _same(got['debug_2d_heatmap_empty'], np.asarray(0))
    names = sorted(k for k in got if k.startswith('file:'))
    assert names == sorted(k for k in want if k.startswith('file:'))
    assert sum(n.endswith('.png') for n in names) == \
        8 + 4 + 4 + 84 + 84 + 4 + 4 + 4
    assert 'file:9_worst.png' in names and 'file:3-pcl.png' in names
    assert 'file:heatmap_3_20.png' in names and 'file:raw_7_20.png' in names
    assert sum(n.endswith('_mesh.obj') for n in names) == 4


def test_fixture_matches_regenerated_and_port(both_outputs):
    """The committed fixture (scripts/make_torch_port_vis_fixture.py):
    its inputs are case_inputs() on this machine, its digests those of the
    JAX package's outputs here, and the port's outputs match them, as
    chip_smoke.py's [vis_debug] phase checks on the card's machine."""
    got, want = both_outputs
    stored = np.load(os.path.join(REPO, cases.FIXTURE))
    for k, v in cases.case_inputs().items():
        assert _same(stored[f'in:{k}'], v), k
    assert cases.differing(want, stored) == []
    assert cases.differing(got, stored) == []
    assert os.path.getsize(os.path.join(REPO, cases.FIXTURE)) < 1 << 20


@pytest.mark.parametrize('dataset', ['dexycb', 'nyu', 'msra'])
def test_debug_overlays_per_dataset_match_jax(tmp_path, dataset):
    """debug_2d_pose (scale 1 at 128, 2 at 256), debug_2d_pose_select,
    debug_visible_joint and debug_pcl_pose with each dataset's skeleton
    and colours, arrays and files."""
    rng = np.random.RandomState(len(dataset))
    n = max(max(b) for b in vis.get_sketch_setting(dataset)) + 1
    for size in (128, 256):
        img = rng.uniform(-1, 1, (2, size, size, 1)).astype(np.float32)
        joints = rng.uniform(-1.2, 1.2, (2, n, 3)).astype(np.float32)
        visible = rng.randint(0, 2, (2, n))
        pcl = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
        dirs = []
        for mod, reader in ((jvis, cv2.imread), (vis, imread)):
            d = tmp_path / f'{mod.__name__.split(".")[0]}_{size}'
            d.mkdir()
            dirs.append((str(d), reader))
            arr = mod.debug_2d_pose(img, joints, 3, dataset, str(d), 'p',
                                    save=True)
            np.save(str(d / 'returned.npy'), arr)
            mod.debug_2d_pose_select(img, joints, 1, dataset, str(d), 's',
                                     [5, 2], save=True)
            mod.debug_visible_joint(img, joints, visible, 0, dataset,
                                    str(d), 'v')
            mod.debug_pcl_pose(pcl, joints, 1, dataset, str(d), 'c')
        (jd, jread), (pd, pread) = dirs
        assert sorted(os.listdir(jd)) == sorted(os.listdir(pd))
        for name in os.listdir(jd):
            if name.endswith('.png'):
                assert _same(pread(os.path.join(pd, name)),
                             jread(os.path.join(jd, name))), name
        assert _same(np.load(os.path.join(pd, 'returned.npy')),
                     np.load(os.path.join(jd, 'returned.npy')))


def test_draw_muti_pic_without_text_matches_jax(tmp_path):
    """Montages of 1-9 images in rows of 1-7 (the last row padded with
    black tiles once a row is full), uint8 and float32 tiles (written
    through convertTo), an explicit batch_size, files read back."""
    rng = np.random.RandomState(5)
    for count, max_col in ((1, 7), (3, 2), (7, 7), (8, 3), (9, 4), (5, 1)):
        imgs = [rng.randint(0, 256, (3, 20, 24, 3)).astype(np.uint8)
                for _ in range(count)]
        imgs[-1] = imgs[-1].astype(np.float32) * 1.3 - 20
        for mod, sub in ((jvis, 'j'), (vis, 'p')):
            (tmp_path / f'{sub}{count}').mkdir()
        want = jvis.draw_muti_pic(imgs, 2, str(tmp_path / f'j{count}'), 'm',
                                  max_col=max_col, batch_size=2)
        got = vis.draw_muti_pic(imgs, 2, str(tmp_path / f'p{count}'), 'm',
                                max_col=max_col, batch_size=2)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert _same(g, w), (count, max_col)
        for name in ('m_4.png', 'm_5.png'):
            assert _same(imread(str(tmp_path / f'p{count}' / name)),
                         cv2.imread(str(tmp_path / f'j{count}' / name)))


def _caption_box(text, shape):
    (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_COMPLEX, 0.5, 1)
    box = np.zeros(shape[:2], bool)
    box[max(0, 15 - h - 2):15 + base + 2, 13:15 + w + 2] = True
    return box


def test_draw_muti_pic_caption_within_cv2_box(tmp_path):
    """With text: outside the caption's box (cv2.getTextSize of the same
    font, scale and thickness, plus the baseline, 2 px around) the
    montage and its file equal the JAX package's; inside it they differ
    (the control), and the port's caption has pixels of the caption's
    colour, (100, 200, 200). Texts: every printable ASCII character,
    runs of the narrowest (3 px in cv2) and widest characters, a typical
    error caption, a character outside ASCII. cv2 5.0's putText takes
    only uint8 images: a float32 montage with a caption raises on both
    sides."""
    import string
    rng = np.random.RandomState(6)
    texts = ['Ab1 err 6.9 mm', 'i' * 40, 'W' * 12, '.,:;|!' * 6,
             string.printable[:95], 'm' * 10, 'x = 3.14°', '']
    floats = [rng.randint(0, 256, (len(texts), 48, 256, 3)).astype(
        np.float32) for _ in range(3)]
    with pytest.raises(cv2.error):
        jvis.draw_muti_pic(floats, 0, '', 'cap', text=texts, save=False)
    with pytest.raises(TypeError):
        vis.draw_muti_pic(floats, 0, '', 'cap', text=texts, save=False)
    imgs = [im.astype(np.uint8) for im in floats]
    for side in 'jp':
        (tmp_path / side).mkdir()
    want = jvis.draw_muti_pic(imgs, 0, str(tmp_path / 'j'), 'cap', text=texts)
    got = vis.draw_muti_pic(imgs, 0, str(tmp_path / 'p'), 'cap', text=texts)
    for i, text in enumerate(texts):
        box = _caption_box(text, got[i].shape)
        differ = np.any(got[i] != want[i], axis=-1)
        assert got[i].dtype == want[i].dtype == np.uint8
        assert not (differ & ~box).any(), text
        if text:
            assert (differ & box).any(), text           # the control
            inked = np.all(got[i] == (100, 200, 200), axis=-1)
            assert (inked & differ).any(), text
        name = f'cap_{i}.png'
        files = (imread(str(tmp_path / 'p' / name)),
                 cv2.imread(str(tmp_path / 'j' / name)))
        assert not (np.any(files[0] != files[1], axis=-1) & ~box).any(), text


def test_debug_mesh_bytes_match_jax(tmp_path):
    """The .obj files of a batch of 3 meshes (778 vertices, 1538 faces;
    int64 and int32 faces), byte for byte."""
    rng = np.random.RandomState(7)
    verts = (rng.randn(3, 778, 3) * 0.1).astype(np.float32)
    for faces in (rng.randint(0, 778, (1538, 3)),
                  rng.randint(0, 778, (1538, 3)).astype(np.int32)):
        for mod, sub in ((jvis, 'j'), (vis, 'p')):
            (tmp_path / sub).mkdir(exist_ok=True)
            mod.debug_mesh(verts, faces, 2, str(tmp_path / sub), 'mesh')
        names = sorted(os.listdir(tmp_path / 'j'))
        assert names == sorted(os.listdir(tmp_path / 'p')) == [
            '6_mesh.obj', '7_mesh.obj', '8_mesh.obj']
        for name in names:
            assert (tmp_path / 'p' / name).read_bytes() == \
                (tmp_path / 'j' / name).read_bytes()
