"""Port parity of K3 (keypointfusion_tpu/kernels/desa_pallas.py): the
grouped MLP + max-pool, the gather-form ball query that feeds it, and
desa_apply_inference, on the CPU, where the wrapper runs its plain
version. The JAX kernel runs in interpret mode.

Tolerances:
  * ball_query_group: indices, validity and relative coordinates equal
    exactly (the same d2, the same first-S rule, the same fill).
  * grouped_mlp_pool and desa_apply_inference against JAX: 1e-4 on values
    of order 1 (measured 2.9e-5): float32 throughout, 128-wide sums in
    another order.
  * the kernel's arithmetic (grouped_mlp_pool_emulated, three TF32 passes
    per product, rows padded to a warp's 16, the max taken from 0) against
    the plain version and JAX: 1e-4, the kernel's limit (measured 2.9e-6
    against the plain version here); one TF32 pass must lie outside it
    (measured 2.0e-3), so the limit tells a kernel that drops the split
    apart. The max from 0 equals the max over the kept slots bit for bit.
  * desa_apply_inference against the port's DESA module (K1 'highest'):
    JAX's own bound for the same comparison (tests/test_kernels.py:
    rtol 1e-3, atol 2e-3); the two differ only where |rel/r|^2 < 1 and
    d2 < r^2 disagree at the ball's edge (measured 4.8e-6 here).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.kernels import desa_pallas as jk3
from keypointfusion_tpu.models.desa import DESA as JDESA
from keypointfusion_tpu.ops.ball_query import ball_query_group as j_group

from keypointfusion_torch.kernels import grouped_mlp_pool as tk3
from keypointfusion_torch.models.desa import DESA
from keypointfusion_torch.ops.ball_query import ball_query_group
from keypointfusion_torch.utils.weights import jax_desa_to_state_dict

from tests.torch_port_helpers import perturb_batch_stats

torch.set_num_threads(2)
t = torch.from_numpy


def _desa_case(b=2, n=256, seed=1):
    """tests/test_kernels.py:31-44's inputs and a JAX DESA (BatchNorm
    statistics perturbed), with the port's DESA holding its weights."""
    rng = np.random.RandomState(seed)
    j, c = 21, 128
    pcl = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    nodes = rng.uniform(-0.5, 0.5, (b, j, 3)).astype(np.float32)
    pf = rng.randn(b, n, c).astype(np.float32)
    nf = rng.randn(b, j, c).astype(np.float32)
    jd = JDESA()
    v = jax.jit(jd.init)(jax.random.PRNGKey(0), pf, nf, pcl, nodes)
    v = {'params': jax.tree_util.tree_map(np.asarray, v['params']),
         'batch_stats': perturb_batch_stats(v['batch_stats'], seed)}
    port = DESA(128)
    port.load_state_dict(jax_desa_to_state_dict(v['params'],
                                                v['batch_stats']),
                         strict=True)
    return (pf, nf, pcl, nodes), jd, v, port.eval()


@pytest.mark.parametrize('far_joint', [False, True])
def test_ball_query_group_matches_jax(far_joint):
    """With far_joint, joint 0 of element 0 sits far from the cloud and is
    left out of the support set, so its balls are empty and every slot
    holds the closest point."""
    (_, _, pcl, nodes), _, _, _ = _desa_case()
    support = pcl
    if far_joint:
        nodes = nodes.copy()
        nodes[0, 0] = 5.0
    else:
        support = np.concatenate([pcl, nodes], 1)
    for r in (0.1, 0.2, 0.4):
        want = j_group(jnp.asarray(support), jnp.asarray(nodes), r, 64)
        got = ball_query_group(t(support), t(nodes), r, 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx = got[0].numpy()
    if far_joint:
        assert (idx[0, 0] == idx[0, 0, 0]).all() and not got[1][0, 0, 1:].any()
    else:
        # short groups repeat slot 0
        short = ~got[1].numpy()
        assert short.any()
        np.testing.assert_array_equal(
            idx[short], np.broadcast_to(idx[..., :1], idx.shape)[short])


def _pool_case(b=2, j=21, s=64, seed=3, empty_balls=False):
    """One radius's groups as numpy arrays (rel, grouped, node, then the
    weights): rel uniform in [-1.2, 1.2], so slots fall on both sides of
    |rel| < 1; with empty_balls every slot but 0 lies outside."""
    rng = np.random.RandomState(seed)
    c = 128
    rel = rng.uniform(-1.2, 1.2, (b, j, s, 3)).astype(np.float32)
    if empty_balls:
        rel[:, :, 1:, 0] = (rng.choice([-1, 1], (b, j, s - 1))
                            * rng.uniform(1.01, 1.2, (b, j, s - 1)))
    grouped = rng.randn(b, j, s, c).astype(np.float32)
    node = rng.randn(b, j, c).astype(np.float32)
    w = [rng.randn(*shape).astype(np.float32) * sd for shape, sd in
         (((3, c), 0.5), ((c,), 0.1), ((c, c), 0.1), ((c,), 0.1),
          ((c, c), 0.1), ((c,), 0.1))]
    return rel, grouped, node, w


def test_grouped_mlp_pool_plain_matches_jax():
    """One radius's groups, with slots inside and outside |rel| < 1."""
    rel, grouped, node, w = _pool_case()
    keep = (rel ** 2).sum(-1) < 1
    assert keep.any() and (~keep[..., 1:]).any()
    want = jk3.grouped_mlp_pool(rel, grouped, node, None, *w,
                                interpret=True)
    got = tk3.grouped_mlp_pool(t(rel), t(grouped), t(node),
                               *(t(x) for x in w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_desa_apply_inference_matches_jax_and_module():
    inputs, jd, v, port = _desa_case()
    want = jk3.desa_apply_inference(v['params'], v['batch_stats'], *inputs,
                                    interpret=True)
    with torch.no_grad():
        got = tk3.desa_apply_inference(port, *(t(x) for x in inputs))
        module = port(*(t(x) for x in inputs))
    assert got.shape == (2, 21, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(want), np.asarray(jd.apply(v, *inputs, False)),
        rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize('tf32_passes', [3, 1])
def test_kernel_arithmetic_within_limit_only_with_three_passes(tf32_passes):
    """The kernel's arithmetic with three TF32 passes lies within 1e-4 of
    the plain version and of JAX's interpret-mode kernel; with one pass it
    lies outside."""
    rel, grouped, node, w = _pool_case(b=1)
    args = [t(x) for x in (rel, grouped, node, *w)]
    got = tk3.grouped_mlp_pool_emulated(*args, tf32_passes=tf32_passes)
    plain = tk3.grouped_mlp_pool_plain(*args)
    jax_out = np.asarray(jk3.grouped_mlp_pool(rel, grouped, node, None, *w,
                                              interpret=True))
    errs = [float((got - plain).abs().max()),
            float(np.abs(got.numpy() - jax_out).max())]
    if tf32_passes == 3:
        assert max(errs) <= 1e-4, errs
    else:
        assert min(errs) > 1e-4, errs


def test_max_from_zero_equals_max_over_kept_slots():
    """Every slot but 0 outside the ball: the max from 0 over the kept
    slots (the kernel's) equals the max over the kept slots alone (the
    plain version's -inf mask), bit for bit, on the same h2."""
    rel, grouped, node, w = _pool_case(b=2, empty_balls=True)
    rel_t = t(rel)
    assert not bool(((rel_t * rel_t).sum(-1) < 1)[..., 1:].any())
    args = [rel_t] + [t(x) for x in (grouped, node, *w)]
    want = tk3.grouped_mlp_pool_plain(*args)
    got = tk3.grouped_mlp_pool_emulated(*args, tf32_passes=None, rows=1)
    assert torch.equal(got, want)
    # on the plain version's own h2: only slot 0 counts
    h = torch.relu(torch.randn(2, 21, 64, 128))
    got = tk3.masked_max_from_zero(h, rel_t, 64)
    assert torch.equal(got, h[:, :, 0])


@pytest.mark.parametrize('s', [17, 1])
def test_rows_padded_to_a_warp_tile(s):
    """S not a multiple of 16: the kernel pads each group with zero rows,
    which are not 0 after the two relus, and leaves them out of the max;
    three passes still lie within 1e-4 of the plain version and of JAX."""
    rel, grouped, node, w = _pool_case(b=2, s=s, seed=4)
    args = [t(x) for x in (rel, grouped, node, *w)]
    got = tk3.grouped_mlp_pool_emulated(*args, tf32_passes=3)
    plain = tk3.grouped_mlp_pool_plain(*args)
    jax_out = np.asarray(jk3.grouped_mlp_pool(rel, grouped, node, None, *w,
                                              interpret=True))
    assert got.shape == (2, 21, 128)
    assert float((got - plain).abs().max()) <= 1e-4
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0, atol=1e-4)
    # the padded rows: zero rows minus node through the MLP are not 0, so
    # a max that took them in would differ
    pad = -s % tk3.WARP_ROWS
    zero_rows = torch.zeros(2, 21, pad, 128)
    h = torch.relu(torch.relu((zero_rows - args[2][:, :, None]) @ args[5]
                              + args[4] + args[6]) @ args[7] + args[8])
    assert bool((h.amax(2) > plain).any())
