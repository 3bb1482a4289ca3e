"""K1 'highest' (the float32 DESA kernel) around its CUDA kernel, on the
CPU: the weight pack the kernel reads, the arithmetic it runs, and the
DESA module's cache of the pack.

  * highest_weights: each folded matrix transposed to [out, in] (the
    layout csrc/desa_dense.cu reads), W2's input channels in the order
    (0, 2, 4, 6, 1, 3, 5, 7) within every 8; undoing both gives the folded
    weights back bit for bit. It refuses weights the kernel would misread.
  * The kernel runs every product of the MLP and of the fusion as three
    TF32 products with float32 sums. `_desa_highest_plain(tf32_passes=3)`
    emulates that bit by bit (TF32 rounding to nearest, ties away from
    zero, as cvt.rna) and must lie within the card's limit, 1e-4, of the
    plain version; one TF32 pass must lie outside it, so the limit tells
    a kernel that drops the split apart. Measured on synthetic_batch(2,
    256, seed=1) with seeded features: three passes 2.48e-5 (ordinary) and
    2.96e-5 (every first ball empty) from the plain version, one pass
    0.0123 and 0.0136, at output scales 30.5 and 22.3. The three passes
    also lie within 1e-4 of the JAX kernel in interpret mode.
  * the module's cache: a cached forward equals a fresh module's bit for
    bit, and the pack is made once.
The kernel itself runs only on the card (tests/test_torch_port_cuda.py).
"""

import numpy as np
import pytest
import torch

from keypointfusion_tpu.kernels.desa_dense_pallas import desa_dense_fused

from keypointfusion_torch.data.synthetic import synthetic_batch
from keypointfusion_torch.kernels import desa_dense as k1
from keypointfusion_torch.models.desa import DESA

from tests.test_torch_port_kernels import _desa_case, _port_desa

torch.set_num_threads(2)
LIMIT = 1e-4     # chip_smoke.py's K1_TOL


def _module(seed=0):
    """A seeded DESA with perturbed BatchNorm statistics, in eval."""
    torch.manual_seed(seed)
    module = DESA(128)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return module.eval()


def _folded(seed=0):
    with torch.no_grad():
        return _module(seed).folded_weights()


def _inputs(empty_first_ball=False):
    """synthetic_batch(2, 256) coordinates, seeded features; with
    `empty_first_ball` the joints on a 1/64 grid and a first radius whose
    square rounds to 0, so every first group is the closest point."""
    batch = synthetic_batch(batch_size=2, point_num=256, seed=1)
    rng = np.random.RandomState(2)
    pcl_feat = rng.randn(2, 256, 128).astype(np.float32)
    node_feat = rng.randn(2, 21, 128).astype(np.float32)
    node_xyz = batch['xyz_gt'].astype(np.float32)
    radius = (0.1, 0.2, 0.4)
    if empty_first_ball:
        node_xyz = np.round(node_xyz * 64) / 64
        radius = (1e-23,) + radius[1:]
    args = [torch.from_numpy(x) for x in (pcl_feat, node_feat, batch['pcl'],
                                          node_xyz)]
    return args, radius


def test_highest_weights_are_the_folded_weights_packed():
    w = _folded()
    pack = k1.highest_weights(w)
    for t in pack:
        assert t.dtype == torch.float32 and t.is_contiguous()
    assert pack.wf_t.shape == pack.w2_t.shape == (3, 128, 128)
    assert pack.wfu_t.shape == (4, 128, 128)
    order = (0, 2, 4, 6, 1, 3, 5, 7)
    for i in range(3):
        assert torch.equal(pack.wf_t[i], w.wf[i].t())
        for q in range(128):
            channel = 8 * (q // 8) + order[q % 8]
            assert torch.equal(pack.w2_t[i][:, q], w.w2[i][channel])
    for q in range(4):
        assert torch.equal(pack.wfu_t[q], w.wfu[128 * q:128 * (q + 1)].t())
    assert pack.wl is w.wl and pack.b1 is w.b1 and pack.b2 is w.b2
    assert pack.bfu is w.bfu
    back = k1._unpack_highest(pack)
    for name, got, want in zip(k1.DesaWeights._fields, back, w):
        assert torch.equal(got, want), name


@pytest.mark.parametrize('fault', ['shape', 'dtype', 'layout', 'device',
                                   'misaligned'])
def test_highest_weights_refuses_what_the_kernel_misreads(fault):
    w = _folded()
    if fault == 'shape':
        w = w._replace(w2=w.w2[:2])
    elif fault == 'dtype':
        w = w._replace(b1=w.b1.double())
    elif fault == 'layout':
        w = w._replace(wf=w.wf.transpose(1, 2))
    elif fault == 'device':
        w = w._replace(bfu=w.bfu.to('meta'))
    else:
        # contiguous float32 of the right shape, 4 bytes past a 16-byte
        # boundary: the kernel copies b1 16 bytes at a time
        shifted = torch.empty(w.b1.numel() + 1)[1:].view_as(w.b1)
        w = w._replace(b1=shifted.copy_(w.b1))
    with pytest.raises((ValueError, TypeError)):
        k1.highest_weights(w)


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 2 - 2 ** -23, 1 + ulp / 4, 3.0])
    want = torch.tensor([1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 1.0, 3.0])
    assert torch.equal(k1._tf32(x), want)


@pytest.mark.parametrize('empty_first_ball', [False, True],
                         ids=['ordinary', 'empty_first_ball'])
def test_three_tf32_passes_lie_within_the_limit_one_outside(
        empty_first_ball):
    args, radius = _inputs(empty_first_ball)
    w = _folded(2)
    samples = (64, 64, 64)
    want = k1.desa_dense_plain(*args, w, radius, samples)
    three = k1._desa_highest_plain(*args, w, radius, samples, tf32_passes=3)
    one = k1._desa_highest_plain(*args, w, radius, samples, tf32_passes=1)
    assert float(want.abs().max()) > 10.0
    assert float((three - want).abs().max()) <= LIMIT
    assert float((one - want).abs().max()) > 10 * LIMIT


def test_three_tf32_passes_match_jax():
    """The kernel's arithmetic against the JAX kernel in interpret mode at
    'highest', on the inputs of test_desa_plain_matches_jax."""
    inputs, _, v = _desa_case(2, 150)
    want = desa_dense_fused(v['params'], v['batch_stats'], *inputs,
                            interpret=True, mlp_precision='highest')
    module = _port_desa(v)
    with torch.no_grad():
        got = k1._desa_highest_plain(
            *[torch.from_numpy(x) for x in inputs], module.folded_weights(),
            module.radius, module.num_samples, tf32_passes=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LIMIT)


def test_module_keeps_the_highest_pack():
    """Under no_grad the float32 module makes its pack once and reuses it;
    its output equals a fresh module's (which folds at the call, with
    gradients on) and the plain version on the folded weights, bit for
    bit."""
    args, radius = _inputs()
    module = _module(4)
    with torch.no_grad():
        first = module(*args)
        entry = module._kernel_weights
        pack = entry['highest']
        assert isinstance(pack, k1.HighestWeights)
        assert torch.equal(module(*args), first)
        assert module._kernel_weights is entry and entry['highest'] is pack
        want = k1.desa_dense_plain(*args, module.folded_weights(),
                                   module.radius, module.num_samples)
    fresh = DESA(128)
    fresh.load_state_dict(module.state_dict())
    with torch.enable_grad():
        out = fresh.eval()(*args).detach()
    assert torch.equal(first, want)
    assert torch.equal(first, out)


def test_highest_launch_needs_cuda_tensors():
    args, radius = _inputs()
    with pytest.raises(ValueError, match='CUDA'):
        k1.desa_dense_highest(*args, k1.highest_weights(_folded()), radius)
