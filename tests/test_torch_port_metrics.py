"""Port parity of the eval metrics (keypointfusion_torch/training/metrics.py)
against keypointfusion_tpu/training/metrics.py on the same seeded inputs.

Tolerances: every float32 metric within 1e-5 of its scale (max |value|,
at least 1): the two sides compute the same float32 expressions, and the
Procrustes alignment goes through each framework's SVD (measured: the
alignment 6.6e-7, the PA error 3.3e-6 of its scale). PCK curves and
AUCs are numpy on both sides: exact. Measured values are printed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.training import metrics as jm
from keypointfusion_torch.training import metrics as pm


def scale(x):
    return max(1.0, float(np.abs(np.asarray(x, np.float64)).max()))


def close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * scale(want), (err, scale(want))
    return err / scale(want)


def inputs(seed, b=16, j=21, noise=0.05):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(-0.8, 0.8, (b, j, 3)).astype(np.float32)
    pred = (gt + rng.normal(0, noise, (b, j, 3))).astype(np.float32)
    center = rng.uniform(-100, 600, (b, 3)).astype(np.float32)
    cube = np.tile(rng.uniform(200, 300, (b, 1)), (1, 3)).astype(np.float32)
    return pred, gt, center, cube


def both(fn_name, *args, **kw):
    want = np.asarray(getattr(jm, fn_name)(*map(jnp.asarray, args), **kw))
    got = getattr(pm, fn_name)(*map(torch.from_numpy, args), **kw).numpy()
    return got, want


@pytest.mark.parametrize('seed', [0, 1])
def test_metrics_match_jax(seed):
    """xyz_to_error_mm, rigid_align and pa_error_mm within 1e-5 of scale;
    pck_curve and auc_subset exact on the same errors."""
    pred, gt, center, cube = inputs(seed)
    measured = {
        'error_mm': close(*both('xyz_to_error_mm', pred, gt, center, cube)),
        'rigid_align': close(*both('rigid_align', pred, gt)),
        'pa_error_mm': close(*both('pa_error_mm', pred, gt, center, cube)),
    }
    errors, _ = both('xyz_to_error_mm', pred, gt, center, cube)
    errors = errors * 0.5                   # spread over the 0-50 mm curve
    auc, curve, th = pm.pck_curve(errors)
    jauc, jcurve, jth = jm.pck_curve(errors)
    assert auc == jauc and 0 < auc < 1
    assert np.array_equal(curve, jcurve) and np.array_equal(th, jth)
    assert pm.auc_subset(curve, th) == jm.auc_subset(jcurve, jth)
    print('measured (of scale)', measured, 'auc', auc)


def test_reflection_and_nyu_subset():
    """A mirrored prediction (x -> -x, det -1 in the best orthogonal fit):
    both sides take the reflection fix and agree; the aligned points are
    not the mirror image. The NYU 23-joint protocol keeps 14 joints."""
    pred, gt, center, cube = inputs(2, noise=0.01)
    mirrored = pred * np.array([-1, 1, 1], np.float32)
    got, want = both('rigid_align', mirrored, gt)
    e = close(got, want)
    assert np.abs(got - gt).max() > 0.1     # no rotation undoes a mirror
    pred23, gt23, c, k = inputs(3, j=23)
    sub, jsub = both('xyz_to_error_mm', pred23, gt23, c, k, nyu_subset=True)
    full, _ = both('xyz_to_error_mm', pred23, gt23, c, k)
    assert sub.shape == (16, 14)
    assert np.array_equal(sub, full[:, list(pm.NYU_SUBSET)])
    e_sub = close(sub, jsub)
    print('measured (of scale): reflected', e, 'nyu', e_sub)


def test_similarity_transform_recovered():
    """B = s R A + t with a proper rotation: rigid_align(A, B) gives B
    within 1e-5 of scale, and the PA error is below 1e-3 mm."""
    rng = np.random.RandomState(4)
    a = rng.uniform(-1, 1, (8, 21, 3))
    q, _ = np.linalg.qr(rng.normal(size=(8, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]       # proper rotations
    s = rng.uniform(0.5, 2.0, (8, 1, 1))
    t = rng.uniform(-0.5, 0.5, (8, 1, 3))
    b = (s * np.einsum('bij,bnj->bni', q, a) + t).astype(np.float32)
    a = a.astype(np.float32)
    aligned = pm.rigid_align(torch.from_numpy(a), torch.from_numpy(b))
    e = close(aligned.numpy(), b)
    center = np.zeros((8, 3), np.float32)
    cube = np.full((8, 3), 250.0, np.float32)
    pa = pm.pa_error_mm(*map(torch.from_numpy, (a, b, center, cube)))
    assert float(pa.max()) < 1e-3
    print('measured: aligned', e, 'pa mm', float(pa.max()))
