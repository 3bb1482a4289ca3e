"""Port parity of DESA's dense train path: models/norm.py's weighted
BatchNorm against the JAX package's WeightedTorchBatchNorm, and
DESA(dense_train=True) in train mode against the JAX module's dense path
and against the port's own gather path, on the DESA module alone, the
same weights carried across by utils/weights.py:jax_desa_to_state_dict.

Inputs: 3 clouds of 150 points, 21 joints, 64 channels, one joint far from
every point (an empty ball at every radius). Tolerances: the weighted
BatchNorm in float32 within 1e-5 of each output's scale (sums of 1,200
terms in another order); DESA's outputs, running statistics and
gradients in float64 on both sides (JAX under
tests/torch_port_helpers.py:jax_float64; the squared distances that pick
the balls stay float32 on both sides) within 1e-8 of each tensor's scale,
the exact-zero gradients (a bias before a train-mode BatchNorm) within
1e-8 of the largest gradient. Against the gather path, 1e-6 of scale: the
gather form rounds each point's offset from its joint to float32 before
its first Dense (as JAX's gather form does), where the dense form takes
the difference of two float64 products (measured 6.0e-8 of scale at
most).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.models.desa import DESA as JDESA
from keypointfusion_tpu.models.desa import dense_group_masks as j_masks
from keypointfusion_tpu.models.norm import WeightedTorchBatchNorm as JWBN
from keypointfusion_tpu.ops.pairwise import pairwise_sqdist as j_sqdist

from keypointfusion_torch.models.desa import DESA, dense_group_masks
from keypointfusion_torch.models.layers import set_compute_dtype
from keypointfusion_torch.models.norm import (
    TorchBatchNorm, WeightedTorchBatchNorm,
)
from keypointfusion_torch.utils import weights as tweights

from tests.torch_port_helpers import jax_float64, perturb_batch_stats

torch.set_num_threads(2)
BN_RTOL = 1e-5
RTOL = 1e-8
GATHER_RTOL = 1e-6
B, N, J, C = 3, 150, 21, 64
t = torch.from_numpy


def within(got, want, rtol, scale=None):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if scale is None else scale
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope='module')
def data():
    rng = np.random.RandomState(0)
    pf = rng.randn(B, N, C).astype(np.float32)
    nf = rng.randn(B, J, C).astype(np.float32)
    pxyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    nxyz = rng.uniform(-0.5, 0.5, (B, J, 3)).astype(np.float32)
    nxyz[0, 0] = 5.0            # an empty ball at every radius
    return pf, nf, pxyz, nxyz


@pytest.fixture(scope='module')
def variables(data):
    """JAX DESA variables (numpy) with perturbed running statistics."""
    v = jax.jit(JDESA(C, mlp=(64, 64)).init)(jax.random.PRNGKey(0), *data)
    return {'params': jax.tree_util.tree_map(np.asarray, v['params']),
            'batch_stats': perturb_batch_stats(v['batch_stats'], seed=2)}


def test_dense_group_masks_match_jax(data):
    _, _, pxyz, nxyz = data
    sup = np.concatenate([pxyz, nxyz], 1)
    d2 = np.asarray(j_sqdist(nxyz, sup))
    for r, s in ((0.1, 64), (0.2, 64), (0.4, 64), (0.2, 4)):
        want_m, want_w = j_masks(jnp.asarray(d2), r, s)
        got_m, got_w = dense_group_masks(torch.tensor(d2), r, s)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        np.testing.assert_array_equal(got_w.sum(-1).numpy(), s)


@pytest.mark.parametrize('weighted', [True, False])
def test_weighted_batch_norm_matches_jax(weighted):
    """Train mode (outputs and updated statistics, with slot counts 0-5 as
    weights, and without weights), then eval mode, from the same
    parameters and statistics."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 120, 8) * 3 + 1).astype(np.float32)
    w = rng.randint(0, 6, (2, 5, 120)).astype(np.float32) if weighted \
        else None
    p = {'scale': rng.uniform(0.5, 1.5, 8).astype(np.float32),
         'bias': rng.randn(8).astype(np.float32)}
    s = {'mean': rng.randn(8).astype(np.float32) * 0.1,
         'var': rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    jbn = JWBN(use_running_average=False)
    want, new = jbn.apply({'params': p, 'batch_stats': s}, x, w,
                          mutable=['batch_stats'])
    bn = WeightedTorchBatchNorm(8)
    assert set(bn.state_dict()) == set(TorchBatchNorm(8).state_dict())
    bn.load_state_dict({'weight': t(p['scale']), 'bias': t(p['bias']),
                        'running_mean': t(s['mean']),
                        'running_var': t(s['var']),
                        'num_batches_tracked': torch.tensor(0)})
    with torch.no_grad():
        got = bn.train()(t(x), None if w is None else t(w))
    within(got, want, BN_RTOL)
    within(bn.running_mean, new['batch_stats']['mean'], BN_RTOL)
    within(bn.running_var, new['batch_stats']['var'], BN_RTOL)
    assert int(bn.num_batches_tracked) == 1
    want_eval = JWBN(use_running_average=True).apply(
        {'params': p, 'batch_stats': new['batch_stats']}, x, w)
    with torch.no_grad():
        within(bn.eval()(t(x), None if w is None else t(w)), want_eval,
               BN_RTOL)


def port_desa(variables, dense: bool) -> DESA:
    """The port's DESA, in float64, holding the JAX variables through
    jax_desa_to_state_dict (loaded strictly: the dense path has the
    gather path's state_dict)."""
    desa = DESA(C, (64, 64), dense_train=dense)
    desa.load_state_dict(tweights.jax_desa_to_state_dict(
        variables['params'], variables['batch_stats']), strict=True)
    return set_compute_dtype(desa.double(), torch.float64).train()


def port_train_pass(desa, data, cot):
    """Outputs, new running statistics and gradients (of sum(out * cot)
    w.r.t. the parameters and pcl_feat), by port name."""
    pf, nf, pxyz, nxyz = data
    f = t(pf).double().requires_grad_()
    out = desa(f, t(nf).double(), t(pxyz), t(nxyz))
    (out * t(cot)).sum().backward()
    stats = {k: v.detach() for k, v in desa.state_dict().items()
             if 'running' in k}
    grads = {k: p.grad.detach() for k, p in desa.named_parameters()}
    grads['pcl_feat'] = f.grad
    return out.detach(), stats, grads


@pytest.fixture(scope='module')
def cot():
    return np.random.RandomState(3).randn(B, J, C)


@pytest.fixture(scope='module')
def jax_dense_f64(data, variables, cot):
    """JAX's dense train path in float64: outputs, new statistics and the
    gradients w.r.t. the parameters and pcl_feat (numpy float64)."""
    desa = JDESA(C, mlp=(64, 64), dense_train=True, dtype=jnp.float64)
    pf, nf, pxyz, nxyz = data
    with jax_float64():
        v = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                   variables)

        def scalar(params, f):
            out, new = desa.apply(
                {'params': params, 'batch_stats': v['batch_stats']}, f, nf,
                pxyz, nxyz, True, mutable=['batch_stats'])
            return jnp.sum(out * cot), (out, new['batch_stats'])

        (_, (out, stats)), (gp, gf) = jax.jit(jax.value_and_grad(
            scalar, argnums=(0, 1), has_aux=True))(v['params'],
                                                    jnp.asarray(pf,
                                                                jnp.float64))
        as_np = lambda tree: jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64), tree)
        return as_np(out), as_np(stats), as_np(gp), np.asarray(gf)


def by_port_name(params, stats, monkeypatch):
    """JAX DESA trees -> the port's state_dict names and layouts, keeping
    float64."""
    monkeypatch.setattr(tweights, '_t', lambda x: torch.from_numpy(
        np.array(x, dtype=np.float64)))
    return tweights.jax_desa_to_state_dict(params, stats)


def exact_zero(name: str) -> bool:
    """A conv bias followed by a train-mode BatchNorm: gradient 0."""
    return name.endswith('bias') and ('conv' in name or 'fusion.0' in name)


def check_grads(got, want, rtol=RTOL):
    largest = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        within(got[k], w.numpy(), rtol, largest if exact_zero(k) else None)


def test_dense_train_matches_jax_dense_in_float64(data, variables, cot,
                                                  jax_dense_f64,
                                                  monkeypatch):
    """DESA(dense_train=True) in train mode against the JAX module's dense
    path: outputs, every updated running statistic and every gradient."""
    want_out, want_stats, want_gp, want_gf = jax_dense_f64
    out, stats, grads = port_train_pass(port_desa(variables, True), data,
                                        cot)
    within(out, want_out, RTOL)
    ref = by_port_name(want_gp, want_stats, monkeypatch)
    for k, v in stats.items():
        within(v, ref[k].numpy(), RTOL)
    check_grads(grads, {k: ref[k] for k in grads if k != 'pcl_feat'})
    within(grads['pcl_feat'], want_gf, RTOL)


def test_dense_train_matches_gather_path_in_float64(data, variables, cot):
    """The dense path against the port's gather path on the same weights:
    the same outputs, running statistics and gradients."""
    want_out, want_stats, want_grads = port_train_pass(
        port_desa(variables, False), data, cot)
    out, stats, grads = port_train_pass(port_desa(variables, True), data,
                                        cot)
    within(out, want_out.numpy(), GATHER_RTOL)
    for k, v in want_stats.items():
        within(stats[k], v.numpy(), GATHER_RTOL)
    check_grads(grads, want_grads, GATHER_RTOL)
