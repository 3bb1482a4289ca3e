"""The calls behind tests/fixtures/torch_port_extra/extra.npz: the host
functions of data/patch_warp.py and data/extra_datasets.py on inputs
made with numpy from seeds. numpy and the standard library only, so that
scripts/make_torch_port_extra_fixture.py runs them through the JAX
package (cv2 5.0) and chip_smoke.py's [extra_data] phase and the tests
through the port, on the same inputs, and compare bit for bit.
"""

import random

import numpy as np

FIXTURE = 'tests/fixtures/torch_port_extra/extra.npz'
# (seed of random.Random, bbox x, y, w, h): train draws, flips among them
AUG_TRAIN = ((0, 10.0, 8.0, 40.0, 30.0), (1, 30.5, 20.25, 44.0, 36.0),
             (2, -6.0, 12.0, 50.0, 41.0), (3, 20.0, -4.0, 33.0, 47.5),
             (4, 45.0, 25.0, 38.0, 30.0), (5, 2.0, 2.0, 70.0, 52.0))
AUG_EVAL = ((10.0, 8.0, 40.0, 30.0), (-6.0, 12.0, 50.0, 41.0))
AUG_SHAPE = (32, 40)          # out_shape (h, w): w not a multiple of 16
CROPS = (((40, 30), 10), ((5, 5), 12), ((75, 55), 20), ((41.5, 3.5), 17))
PADS = ((-3, 20, -5, 30), (50, 90, 40, 70), (-2, 100, -9, 61))
HEAT_SIZE = 20
GAUSS_HW = (12, 10)


def case_inputs() -> dict:
    """The inputs, numpy arrays, from RandomState(0)."""
    rng = np.random.RandomState(0)
    inp = {'img': rng.randint(0, 256, (57, 83, 3)).astype(np.uint8),
           'mask2d': rng.randint(0, 34, (57, 83)).astype(np.uint8),
           'rhd_image': rng.randint(0, 256, (64, 64, 3)).astype(np.uint8),
           'rhd_uv': rng.uniform(0, 64, (42, 2)),
           'rhd_xyz': rng.uniform(-0.2, 0.2, (42, 3)),
           'unify': rng.randint(0, 34, (24, 24)).astype(np.uint8),
           'heat_uv': rng.uniform(-2, HEAT_SIZE + 2, (21, 2)),
           'gauss_uv': rng.uniform(-1, 12, (2, 21, 2)).astype(np.float32)}
    # RHD masks: background 0-1, left hand 2..17, right hand 18..33; one
    # mask with more left-hand pixels, one with more right-hand pixels
    for side, (lo, hi) in (('left', (2, 18)), ('right', (18, 34))):
        m = np.zeros((64, 64), np.uint8)
        m[10:40, 12:36] = rng.randint(lo, hi, (30, 24))
        other = (18, 34) if side == 'left' else (2, 18)
        m[45:55, 40:50] = rng.randint(*other, (10, 10))
        inp[f'rhd_mask_{side}'] = np.stack([m, m // 2, m % 3], -1)
    return inp


def case_outputs(patch_warp, extra_datasets, inp: dict) -> dict:
    """Every output of the calls, keyed by call, from the modules given
    (the JAX package's or the port's)."""
    out = {}
    for seed, *bbox in AUG_TRAIN:
        res = patch_warp.patch_augmentation(
            inp['img'], bbox, True, AUG_SHAPE, rng=random.Random(seed))
        for k, v in zip(('patch', 'trans', 'inv_trans', 'rot', 'flip',
                         'inv_trans_joint'), res):
            out[f'aug_train_{seed}_{k}'] = np.asarray(v)
    for i, bbox in enumerate(AUG_EVAL):
        res = patch_warp.patch_augmentation(inp['img'], bbox, False,
                                            AUG_SHAPE)
        for k, v in zip(('patch', 'trans', 'inv_trans', 'rot', 'flip',
                         'inv_trans_joint'), res):
            out[f'aug_eval_{i}_{k}'] = np.asarray(v)
    for i, (center, size) in enumerate(CROPS):
        for name in ('img', 'mask2d'):
            crop, trans = extra_datasets.imcrop(inp[name].copy(), center,
                                                size)
            out[f'imcrop_{name}_{i}'] = crop
            out[f'imcrop_{name}_{i}_trans'] = trans
    for i, (x1, x2, y1, y2) in enumerate(PADS):
        for name in ('img', 'mask2d'):
            img, *box = extra_datasets.pad_img_to_fit_bbox(
                inp[name], x1, x2, y1, y2, border_value=(127, 31, 200))
            out[f'pad_{name}_{i}'] = img
            out[f'pad_{name}_{i}_box'] = np.asarray(box)
    for side in ('left', 'right'):
        res = extra_datasets.preprocess_rhd(
            inp['rhd_image'], inp[f'rhd_mask_{side}'], inp['rhd_uv'],
            inp['rhd_xyz'])
        for k, v in zip(('image', 'mask', 'xyz', 'center', 'size',
                         'hand_side'), res):
            out[f'rhd_{side}_{k}'] = np.asarray(v)
        out[f'unify_{side}'] = extra_datasets.unify_mask(
            inp['unify'], res[5])
    out['heatmap'] = extra_datasets.create_heatmap(inp['heat_uv'],
                                                   HEAT_SIZE)
    out['heatmap_zero'] = extra_datasets.create_heatmap(
        np.zeros((21, 2)), HEAT_SIZE)
    out['gaussian'] = extra_datasets.make_gaussian_heatmap(inp['gauss_uv'],
                                                           GAUSS_HW)
    return out
