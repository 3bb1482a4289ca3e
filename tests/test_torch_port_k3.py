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


def test_grouped_mlp_pool_plain_matches_jax():
    """One radius's groups, with slots inside and outside |rel| < 1."""
    rng = np.random.RandomState(3)
    b, j, s, c = 2, 21, 64, 128
    rel = rng.uniform(-1.2, 1.2, (b, j, s, 3)).astype(np.float32)
    grouped = rng.randn(b, j, s, c).astype(np.float32)
    node = rng.randn(b, j, c).astype(np.float32)
    w = [rng.randn(*shape).astype(np.float32) * sd for shape, sd in
         (((3, c), 0.5), ((c,), 0.1), ((c, c), 0.1), ((c,), 0.1),
          ((c, c), 0.1), ((c,), 0.1))]
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
