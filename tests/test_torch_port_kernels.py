"""Port parity of the two kernels on the serving path, K2 (pixel sampler)
and K1 (whole-DESA eval pass).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX Pallas kernels in interpret mode at 'highest' precision
and against the JAX module paths they replace. The CUDA kernels are held
against these plain versions on the card by tests/test_torch_port_cuda.py,
which imports no JAX.

Tolerances:
  * K2: the selected pixel indices must be equal (the distances round
    alike, ops/pairwise.py, and ties go to the lower index on both
    sides); values to 2e-5, since XLA's dense [N,HW] product and the
    gather-sum add the same four products in another order.
  * K1: 1e-4. The port folds BatchNorm into the weights and takes
    (f_m - f_j) Wf where the JAX module takes Dense(f_m) - Dense(f_j) and
    the JAX kernel A - B_j; float32 reassociation over 128-wide sums.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.geometry.camera import uvd_nl_to_xyz_nl
from keypointfusion_tpu.geometry.grid import img_uvd_points
from keypointfusion_tpu.geometry.pcl import (
    img_to_pcl_index, sample_pixel_features,
)
from keypointfusion_tpu.kernels.desa_dense_pallas import desa_dense_fused
from keypointfusion_tpu.kernels.desa_pallas import fold_bn as j_fold_bn
from keypointfusion_tpu.kernels.pixel_sampler_pallas import \
    sample_pixel_features_fused as j_fused_sampler
from keypointfusion_tpu.models.desa import DESA as JDESA, dense_group_masks
from keypointfusion_tpu.ops.pairwise import pairwise_sqdist as j_sqdist
from keypointfusion_tpu.training.train_step import frame_from_batch

from keypointfusion_torch.geometry.pcl import topk_smallest
from keypointfusion_torch.kernels import desa_dense as tk1
from keypointfusion_torch.kernels import pixel_sampler as tk2
from keypointfusion_torch.models.desa import DESA as TDESA
from keypointfusion_torch.ops.ball_query import ball_query_slots
from keypointfusion_torch.ops.pairwise import pairwise_sqdist as t_sqdist
from keypointfusion_torch.utils import weights as tweights

from tests.torch_port_helpers import perturb_batch_stats

torch.set_num_threads(2)


# ---------------------------------------------------------------- K2 ----

def _sampler_case(kind, c, seed=0):
    """(pcl [B,N,3], img_xyz [B,HW,3], feat [B,HW,C], JAX top-k indices)."""
    rng = np.random.RandomState(seed)
    if kind == 'synthetic':
        # the inputs of tests/test_pixel_sampler.py
        batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
            batch_size=2, point_num=256, seed=seed).items()}
        frame = frame_from_batch(batch, JConfig())
        img_down = batch['depth'][:, ::4, ::4]
        img_xyz = uvd_nl_to_xyz_nl(img_uvd_points(img_down), frame)
        pcl = batch['pcl']
        _, idx = img_to_pcl_index(pcl, img_down, frame, select_num=4)
    elif kind == 'all_tied':
        # the pixel centres at 3 positions: each point's 4 nearest are all
        # at one distance, so the lowest indices there must win
        where = rng.uniform(-1, 1, (2, 3, 3)).astype(np.float32)
        img_xyz = jnp.asarray(
            where[np.arange(2)[:, None], rng.randint(0, 3, (2, 1024))])
        pcl = jnp.asarray(rng.uniform(-.9, .9, (2, 256, 3)).astype(
            np.float32))
        _, idx = jax.lax.top_k(-j_sqdist(pcl, img_xyz), 4)
    else:
        # flat background: the 32x32 pixel centres on one depth plane,
        # points on the same dyadic grid, so every d2 is exact and
        # equidistant pixels tie exactly, also across the 4th/5th slot
        r = (np.arange(32, dtype=np.float32) + 0.5) / 16.0 - 1.0
        u, v = np.meshgrid(r, r)
        grid = np.stack([u, v, np.full_like(u, 0.5)], -1).reshape(-1, 3)
        img_xyz = jnp.asarray(np.broadcast_to(grid, (2, 1024, 3)).copy())
        k = rng.randint(-32, 33, (2, 256, 2)).astype(np.float32) / 32.0
        pcl = jnp.asarray(np.concatenate(
            [k, np.full((2, 256, 1), 0.5, np.float32)], -1))
        _, idx = jax.lax.top_k(-j_sqdist(pcl, img_xyz), 4)
    feat = jnp.asarray(rng.randn(2, 1024, c).astype(np.float32))
    return pcl, img_xyz, feat, np.asarray(idx)


@pytest.mark.parametrize('kind,c', [('synthetic', 37), ('synthetic', 277),
                                    ('flat_background_ties', 37),
                                    ('all_tied', 37)])
def test_pixel_sampler_plain_matches_jax(kind, c):
    pcl, img_xyz, feat, j_idx = _sampler_case(kind, c)
    t = lambda x: torch.from_numpy(np.array(x))
    _, t_idx = topk_smallest(t_sqdist(t(pcl), t(img_xyz)), 4)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    got = tk2.sample_pixel_features_fused(t(pcl), t(img_xyz), t(feat), k=4)
    want_kernel = j_fused_sampler(pcl, img_xyz, feat, k=4, interpret=True,
                                  feat_precision='highest')
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               rtol=0, atol=2e-5)
    d2 = j_sqdist(pcl, img_xyz)
    neg, idx = jax.lax.top_k(-d2, 4)
    cl = 1.0 / (-neg + 1e-8)
    cl = cl / (jnp.sum(cl, -1, keepdims=True) + 1e-8)
    want_xla = sample_pixel_features(feat, cl, idx, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), rtol=0,
                               atol=2e-5)


def test_flat_background_has_boundary_ties():
    """The tie case above is a real one: some point's 4th and 5th nearest
    pixels are at exactly the same distance."""
    pcl, img_xyz, _, _ = _sampler_case('flat_background_ties', 4)
    d2 = np.sort(np.asarray(j_sqdist(pcl, img_xyz)), -1)
    assert (d2[..., 3] == d2[..., 4]).any()


# ---------------------------------------------------------------- K1 ----

def _desa_case(b, n, seed=0):
    rng = np.random.RandomState(seed)
    j, c = 21, 128
    pf = rng.randn(b, n, c).astype(np.float32)
    nf = rng.randn(b, j, c).astype(np.float32)
    pxyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    nxyz = rng.uniform(-0.5, 0.5, (b, j, 3)).astype(np.float32)
    nxyz[0, 0] = 5.0      # far from the cloud: its ball holds only itself
    jd = JDESA(128)
    v = jax.jit(jd.init)(jax.random.PRNGKey(0), pf, nf, pxyz, nxyz)
    v = {'params': jax.tree_util.tree_map(np.asarray, v['params']),
         'batch_stats': perturb_batch_stats(v['batch_stats'], seed)}
    return (pf, nf, pxyz, nxyz), jd, v


def _port_desa(v):
    sd = {}
    tweights._desa(sd, 'FA', v['params'], v['batch_stats'])
    module = TDESA(128)
    module.load_state_dict({k[3:]: x for k, x in sd.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize('b,n', [(2, 150), (1, 1024)])
def test_desa_plain_matches_jax(b, n):
    inputs, jd, v = _desa_case(b, n)
    want_module = jd.apply(v, *inputs)
    want_kernel = desa_dense_fused(v['params'], v['batch_stats'], *inputs,
                                   interpret=True, mlp_precision='highest')
    with torch.no_grad():
        got = _port_desa(v)(*[torch.from_numpy(x) for x in inputs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_module),
                               rtol=0, atol=1e-4)


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(0)
    dense = {'kernel': rng.randn(8, 16).astype(np.float32),
             'bias': rng.randn(16).astype(np.float32)}
    bn_p = {'scale': rng.rand(16).astype(np.float32) + 0.5,
            'bias': rng.randn(16).astype(np.float32)}
    bn_s = {'mean': rng.randn(16).astype(np.float32),
            'var': rng.rand(16).astype(np.float32) + 0.1}
    want_w, want_b = j_fold_bn(dense, bn_p, bn_s)
    t = torch.from_numpy
    got_w, got_b = tk1.fold_bn(t(dense['kernel']), t(dense['bias']),
                               t(bn_p['scale']), t(bn_p['bias']),
                               t(bn_s['mean']), t(bn_s['var']))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_ball_query_slots_match_dense_masks():
    """The group of every (b, j, radius), empty balls included, is the
    masked-max set of the JAX dense formulation."""
    rng = np.random.RandomState(7)
    d2 = rng.uniform(0, 0.3, (2, 21, 300)).astype(np.float32)
    d2[0, 3] += 0.5                        # empty at every radius
    d2[1, 4, 17] = d2[1, 4, 40] = 0.0      # tied closest points
    d2[1, 4] += 0.5 * (d2[1, 4] > 0)
    for r in (0.1, 0.2, 0.4):
        mask, _ = dense_group_masks(jnp.asarray(d2), r, 64)
        idx, valid = ball_query_slots(torch.from_numpy(d2), r, 64)
        got = np.zeros(d2.shape, bool)
        bi, ji, si = np.nonzero(valid.numpy())
        got[bi, ji, idx.numpy()[bi, ji, si]] = True
        np.testing.assert_array_equal(got, np.asarray(mask))
