"""Port parity of the off-path data modules: the cv2 calls they need
(data/cv_ops.py: the bilinear warp_affine, get_affine_transform, flip,
copy_make_border) against cv2 5.0, and data/patch_warp.py,
data/extra_datasets.py and data/occlusion.py against the JAX modules.

Tolerances: 0 everywhere. cv_ops against cv2 bit for bit on random
warps of 1- and 3-channel uint8 images whose widths are not multiples
of 16 (cv2 steps 16 columns at a time, with another rounding in the
tail), and on random 6x6 systems in double; the host functions against
the JAX package's (through cv2) bit for bit, values and dtypes;
occlusion's masks equal given JAX's draws, the visibilities equal
booleans. The committed fixture (tests/fixtures/torch_port_extra/,
scripts/make_torch_port_extra_fixture.py) equals one regenerated here.
"""

import json
import os
import random

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.data import extra_datasets as jx
from keypointfusion_tpu.data import occlusion as jocc
from keypointfusion_tpu.data import patch_warp as jpw

from keypointfusion_torch.data import cv_ops
from keypointfusion_torch.data import extra_datasets as tx
from keypointfusion_torch.data import occlusion as tocc
from keypointfusion_torch.data import patch_warp as tpw

from tests.torch_port_extra_cases import FIXTURE, case_inputs, case_outputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


# -------------------------------------------------------------- cv_ops --

def random_warps(n, seed):
    """(src, M, dsize) of random affine warps: rotations, scales and
    shears, partly outside the source; output widths and heights from 1
    to 150, sources of 1 and 3 channels."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = rng.randint(5, 120), rng.randint(5, 120)
        shape = (h, w, 3) if i % 2 else (h, w)
        kind = i % 3
        if kind == 0:
            src = rng.randint(0, 256, shape)
        elif kind == 1:
            src = rng.choice([0, 255], shape)      # the largest steps
        else:
            src = np.full(shape, rng.randint(0, 256))
        M = rng.uniform(-2, 2, (2, 3))
        M[:, 2] = rng.uniform(-50, 150, 2)
        yield src.astype(np.uint8), M.astype(np.float32), \
            (int(rng.randint(1, 150)), int(rng.randint(1, 150)))


def patch_warps(n, seed):
    """(src, M, dsize) of gen_trans_from_patch warps, as
    generate_patch_image makes them: rotations of +-180 degrees, widths
    not multiples of 16."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = rng.randint(40, 160), rng.randint(40, 160)
        src = rng.randint(0, 256, (h, w, 3) if i % 2 else (h, w))
        ow, oh = int(rng.choice([23, 40, 57, 100])), int(rng.randint(9, 80))
        bbox = [rng.uniform(-10, w / 2), rng.uniform(-10, h / 2),
                rng.uniform(10, w), rng.uniform(10, h)]
        M = jpw.gen_trans_from_patch(
            bbox[0] + bbox[2] / 2, bbox[1] + bbox[3] / 2, bbox[2], bbox[3],
            ow, oh, rng.uniform(0.9, 1.1), rng.uniform(-180, 180),
            tuple(rng.uniform(-10, 10, 2)))
        yield src.astype(np.uint8), M, (ow, oh)


@pytest.mark.parametrize('kind', ['random', 'patch'])
def test_bilinear_warp_affine_matches_cv2(kind):
    warps = random_warps(120, 0) if kind == 'random' else patch_warps(60, 1)
    values = 0
    for src, M, dsize in warps:
        want = cv2.warpAffine(src, M, dsize, flags=cv2.INTER_LINEAR)
        got = cv_ops.warp_affine(src, M, dsize, interpolation='linear')
        assert same(got, want), (src.shape, M.tolist(), dsize,
                                 int((got != want).sum()))
        values += want.size
    print(kind, values, 'values, all equal')


def test_get_affine_transform_matches_cv2():
    """In double, bit for bit (np.linalg.solve differs in most draws);
    the three-point patches of gen_trans_from_patch and random ones."""
    rng = np.random.RandomState(2)
    for i in range(1500):
        if i % 2:
            c = rng.uniform(0, 500, 2)
            s, r = rng.uniform(10, 200), rng.uniform(-np.pi, np.pi)
            src = np.stack([c, c + s * np.array([-np.sin(r), np.cos(r)]),
                            c + s * np.array([np.cos(r), np.sin(r)])])
            dst = np.array([[128, 128], [128, 256], [256, 128]])
        else:
            src, dst = rng.uniform(-300, 600, (2, 3, 2))
        src, dst = src.astype(np.float32), dst.astype(np.float32)
        assert same(cv_ops.get_affine_transform(src, dst),
                    cv2.getAffineTransform(src, dst)), i
    # collinear and nearly so: cv2 gives zeros below a pivot of 100 eps
    dst = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    for d in (1e-12, 5e-14, 1e-14, 1e-15, 0.0):
        src = np.array([[0, 0], [1, 0], [0, d]], np.float32)
        assert same(cv_ops.get_affine_transform(src, dst),
                    cv2.getAffineTransform(src, dst)), d
    src = np.array([[0, 0], [1, 1], [2, 2]], np.float32)
    assert same(cv_ops.get_affine_transform(src, dst),
                cv2.getAffineTransform(src, dst))


def test_flip_and_copy_make_border_match_cv2():
    rng = np.random.RandomState(3)
    for shape in ((7, 13), (7, 13, 3), (5, 6, 2)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        assert same(cv_ops.flip(img, 1), cv2.flip(img, 1))
        assert same(cv_ops.flip(img[:, ::-1], 1), cv2.flip(
            np.ascontiguousarray(img[:, ::-1]), 1))
        for _ in range(20):
            pads = [int(v) for v in rng.randint(0, 9, 4)]
            value = [int(v) for v in rng.randint(0, 256, 3)]
            want = cv2.copyMakeBorder(img, *pads, cv2.BORDER_CONSTANT,
                                      value=value)
            assert same(cv_ops.copy_make_border(img, *pads, value), want)
    img = rng.uniform(0, 255, (4, 5, 3))
    want = cv2.copyMakeBorder(img, 1, 2, 3, 0, cv2.BORDER_CONSTANT,
                              value=[127.5, 3.25, 300.0])
    assert same(cv_ops.copy_make_border(img, 1, 2, 3, 0,
                                        (127.5, 3.25, 300.0)), want)
    img = rng.randint(0, 256, (4, 5, 3)).astype(np.uint8)
    want = cv2.copyMakeBorder(img, 1, 1, 1, 1, cv2.BORDER_CONSTANT,
                              value=[127.5, -3, 300])
    assert same(cv_ops.copy_make_border(img, 1, 1, 1, 1,
                                        (127.5, -3, 300)), want)


# ----------------------------------------------------------- patch_warp --

def test_patch_warp_matches_jax():
    """gen_trans_from_patch both ways and generate_patch_image with and
    without the flip, then patch_augmentation's train and eval draws
    from random.Random seeds (values, dtypes and the draws' order)."""
    rng = np.random.RandomState(4)
    for i in range(40):
        args = (rng.uniform(0, 100), rng.uniform(0, 100),
                rng.uniform(10, 90), rng.uniform(10, 90), 40, 32,
                rng.uniform(0.9, 1.1), rng.uniform(-180, 180),
                tuple(rng.uniform(-10, 10, 2)))
        for inv in (False, True):
            assert same(tpw.gen_trans_from_patch(*args, inv=inv),
                        jpw.gen_trans_from_patch(*args, inv=inv))
    img = rng.randint(0, 256, (61, 77, 3)).astype(np.uint8)
    for flip in (False, True):
        args = (img, (8.5, 4.0, 40.0, 30.0), 1.05, 33.0, (2.0, -3.5), flip,
                (29, 35))
        for g, w in zip(tpw.generate_patch_image(*args),
                        jpw.generate_patch_image(*args)):
            assert same(g, w)
    for seed in range(12):
        for train in (True, False):
            bbox = (rng.uniform(-5, 30), rng.uniform(-5, 30), 40.0, 33.0)
            g_rng, w_rng = random.Random(seed), random.Random(seed)
            got = tpw.patch_augmentation(img, bbox, train, (33, 47),
                                         rng=g_rng)
            want = jpw.patch_augmentation(img, bbox, train, (33, 47),
                                          rng=w_rng)
            assert all(same(g, w) for g, w in zip(got, want))
            assert g_rng.random() == w_rng.random()


# ------------------------------------------------------- extra_datasets --

def test_extra_datasets_match_jax():
    """Every function of the module on the fixture's inputs and on more
    of the same kind: crops and pads in and out of bounds on 3-channel
    and 2-D images, RHD frames of either dominant hand, the masks of
    either side, heatmaps (all-zero joints give zero maps)."""
    inp = case_inputs()
    got = case_outputs(tpw, tx, inp)
    want = case_outputs(jpw, jx, inp)
    assert set(got) == set(want)
    bad = [k for k in want if not same(got[k], want[k])]
    assert not bad, bad
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (30, 41, 3)).astype(np.uint8)
    for _ in range(30):
        center, size = rng.uniform(-10, 50, 2), rng.uniform(1, 25)
        for im in (img, img[..., 0]):
            for g, w in zip(tx.imcrop(im.copy(), center, size),
                            jx.imcrop(im.copy(), center, size)):
                assert same(g, w)
    kp = rng.rand(21, 3)
    assert same(tx.convert_kp(kp), jx.convert_kp(kp))
    xyz, K = rng.uniform(0.2, 0.8, (21, 3)), np.array(
        [[600., 0, 320], [0, 600, 240], [0, 0, 1]])
    assert same(tx.project_points(xyz, K), jx.project_points(xyz, K))
    for version in tx.FREIHAND_VERSIONS:
        assert tx.freihand_map_id(7, version) == jx.freihand_map_id(
            7, version)
    assert tx.freihand_db_size('evaluation') == 3960
    with pytest.raises(ValueError):
        tx.freihand_map_id(0, 'nope')


def test_freihand_reader_matches_jax(tmp_path):
    """The index and a JPEG frame, read by the port's decoder and by
    cv2.imread through the JAX module: the same pixels."""
    for name, val in (('K', [[[600., 0, 320], [0, 600, 240], [0, 0, 1]]]),
                      ('verts', [[[0.0] * 3] * 4]),
                      ('xyz', [[[0.1, 0.2, 0.5]] * 21]),
                      ('scale', [1.0])):
        with open(tmp_path / f'training_{name}.json', 'w') as f:
            json.dump(val * 3, f)
    assert tx.load_freihand_annotations(str(tmp_path)) == \
        jx.load_freihand_annotations(str(tmp_path))
    os.makedirs(tmp_path / 'training' / 'rgb')
    rng = np.random.RandomState(6)
    y, x = np.mgrid[0:37, 0:45]
    img = np.stack([x * 5, y * 6, (x + y) * 2], -1) + rng.randint(
        0, 20, (37, 45, 3))
    path = tmp_path / 'training' / 'rgb' / ('%08d.jpg' % (5 + 32560))
    cv2.imwrite(str(path), img.astype(np.uint8))
    got = tx.read_freihand_img(5, str(tmp_path), 'training', 'hom')
    want = jx.read_freihand_img(5, str(tmp_path), 'training', 'hom')
    assert same(got, want)
    with pytest.raises(IOError):
        tx.read_freihand_img(6, str(tmp_path), 'training')


def test_committed_fixture_is_current():
    """tests/fixtures/torch_port_extra/extra.npz equals the arrays that
    scripts/make_torch_port_extra_fixture.py makes now, and the port
    gives its outputs from its inputs (what chip_smoke.py's [extra_data]
    phase checks on the card's host)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'make_fixture', os.path.join(REPO, 'scripts',
                                     'make_torch_port_extra_fixture.py'))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    fresh = make.fixture_arrays()
    path = os.path.join(REPO, FIXTURE)
    assert os.path.getsize(path) < 1 << 20
    stored = np.load(path)
    assert set(stored.files) == set(fresh)
    assert all(same(stored[k], fresh[k]) for k in fresh)
    inp = {k[3:]: stored[k] for k in stored.files if k.startswith('in_')}
    got = case_outputs(tpw, tx, inp)
    assert all(same(got[k], stored[k]) for k in got)


# ------------------------------------------------------------ occlusion --

def test_joint_visibility_matches_jax():
    rng = np.random.RandomState(7)
    pcl = rng.uniform(-0.5, 0.5, (3, 512, 3)).astype(np.float32)
    joints = rng.uniform(-0.5, 0.5, (3, 21, 3)).astype(np.float32)
    kernels = (0.1, 0.2, rng.uniform(0.05, 0.3, 21).astype(np.float32))
    for kernel in kernels:
        for support in (0, 10, 40):
            want = np.asarray(jocc.joint_visibility(
                jnp.asarray(pcl), jnp.asarray(joints), kernel, support))
            got = tocc.joint_visibility(torch.from_numpy(pcl),
                                        torch.from_numpy(joints), kernel,
                                        support)
            assert got.dtype == torch.bool and same(got.numpy(), want)
    offset = rng.uniform(-1, 1, (2, 16, 16, 105)).astype(np.float32)
    want = np.asarray(jocc.offset_map_visibility(jnp.asarray(offset)))
    got = tocc.offset_map_visibility(torch.from_numpy(offset))
    assert same(got.numpy(), want)


def jax_mask_draws(key, b, j, num_masks):
    """mask_image's draws as the JAX module makes them
    (occlusion.py:50-57): joint ids, uniform jitter, uniform radii."""
    k1, k2, k3 = jax.random.split(key, 3)
    joint_id = jax.random.randint(k1, (b, num_masks), 0, j)
    jitter = jax.random.uniform(k2, (b, num_masks, 3))
    radius = jax.random.uniform(k3, (b, num_masks))
    return joint_id, jitter, radius


def test_mask_image_matches_jax_with_its_draws():
    rng = np.random.RandomState(8)
    depth = rng.uniform(-1, 0.5, (3, 32, 32, 1)).astype(np.float32)
    joints = rng.uniform(-0.5, 0.5, (3, 21, 3)).astype(np.float32)
    jmask = jax.jit(jocc.mask_image, static_argnames=('num_masks',))
    draws_of = jax.jit(jax_mask_draws, static_argnums=(1, 2, 3))
    for seed, num_masks, para in ((0, 6, 0.3), (1, 6, 0.5), (2, 10, 0.2)):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jmask(jnp.asarray(depth), jnp.asarray(joints),
                                key, mask_para=para, num_masks=num_masks))
        draws = [torch.from_numpy(np.array(d))
                 for d in draws_of(key, 3, 21, num_masks)]
        got = tocc.mask_image_from_draws(
            torch.from_numpy(depth), torch.from_numpy(joints),
            draws[0].long(), *draws[1:], mask_para=para)
        assert same(got.numpy(), want)
        assert (want == 1).sum() > 0 and (want != 1).sum() > 0


def test_mask_image_draws_from_the_generator():
    depth = torch.zeros(2, 16, 16, 1) - 0.5
    joints = torch.rand(2, 21, 3, generator=torch.Generator().manual_seed(
        1)) - 0.5
    a = tocc.mask_image(depth, joints, torch.Generator().manual_seed(3))
    b = tocc.mask_image(depth, joints, torch.Generator().manual_seed(3))
    c = tocc.mask_image(depth, joints, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    draws = tocc.mask_image_draws(2, 21, 6,
                                  torch.Generator().manual_seed(3), 'cpu')
    assert torch.equal(tocc.mask_image_from_draws(depth, joints, *draws), a)
