"""K1 'default' (the bfloat16 serving DESA kernel) around its CUDA kernel,
on the CPU: the weight pack the kernel reads, the joint term computed
outside it, and the DESA module's cache of both.

  * serving_weights: exactly the bfloat16 rounding of each folded weight,
    transposed to [out, in] (the layout csrc/desa_dense_serving.cu reads),
    and the joint term's float32 weights exactly, radii side by side; it
    refuses weights the kernel would misread.
  * serving_joint_term against the JAX kernel's b_i expression
    (keypointfusion_tpu/kernels/desa_dense_pallas.py:202-206, einsums at
    HIGHEST) on the same folded weights: 1e-5 on values of order 1 (float32
    products summed in another order, and the two biases subtracted one by
    one there, summed first here).
  * the module's cache: the outputs of a cached forward equal those of a
    fresh module bit for bit, in both modes.
The kernel itself runs only on the card (tests/test_torch_port_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_torch.kernels import desa_dense as k1
from keypointfusion_torch.models.desa import DESA, fold_conv_bn
from keypointfusion_torch.models.layers import set_compute_dtype

torch.set_num_threads(2)
BF = torch.bfloat16


def _module(seed=0):
    """A seeded DESA with perturbed BatchNorm statistics, in eval."""
    torch.manual_seed(seed)
    module = DESA(128)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return module.eval()


def _inputs(b=2, n=96, j=21, seed=0):
    rng = np.random.RandomState(seed)
    x = [rng.randn(b, n, 128), rng.randn(b, j, 128),
         rng.uniform(-1, 1, (b, n, 3)), rng.uniform(-0.5, 0.5, (b, j, 3))]
    return [torch.from_numpy(a.astype(np.float32)) for a in x]


def test_serving_weights_are_the_bf16_weights_transposed():
    with torch.no_grad():
        w = _module().folded_weights()
    pack = k1.serving_weights(w)
    for t in (pack.wf_t, pack.w2_t, pack.wfu_t):
        assert t.dtype == BF and t.is_contiguous()
    assert pack.wf_t.shape == pack.w2_t.shape == (3, 128, 128)
    assert pack.wfu_t.shape == (4, 128, 128)
    for i in range(3):
        assert torch.equal(pack.wf_t[i].float(), k1._bf16(w.wf[i]).t())
        assert torch.equal(pack.w2_t[i].float(), k1._bf16(w.w2[i]).t())
    for q in range(4):
        chunk = w.wfu[128 * q:128 * (q + 1)]
        assert torch.equal(pack.wfu_t[q].float(), k1._bf16(chunk).t())
    assert pack.wl is w.wl and pack.b2 is w.b2 and pack.bfu is w.bfu
    assert pack.b1 is w.b1
    assert pack.wf_cat.shape == (128, 384) and pack.wl_cat.shape == (3, 384)
    for i in range(3):
        assert torch.equal(pack.wf_cat[:, 128 * i:128 * (i + 1)], w.wf[i])
        assert torch.equal(pack.wl_cat[:, 128 * i:128 * (i + 1)], w.wl[i])


@pytest.mark.parametrize('fault', ['shape', 'dtype', 'layout'])
def test_serving_weights_refuses_what_the_kernel_misreads(fault):
    with torch.no_grad():
        w = _module().folded_weights()
    if fault == 'shape':
        w = w._replace(b2=w.b2[:2])
    elif fault == 'dtype':
        w = w._replace(wl=w.wl.double())
    else:
        w = w._replace(wf=w.wf.transpose(1, 2))
    with pytest.raises((ValueError, TypeError)):
        k1.serving_weights(w)


def test_serving_joint_term_matches_jax():
    module = _module(1)
    _, node_feat, _, node_xyz = _inputs(seed=1)
    node_feat = node_feat.to(BF)
    radius = module.radius
    with torch.no_grad():
        got = k1.serving_joint_term(
            node_feat, node_xyz, k1.serving_weights(module.folded_weights()),
            radius)
        pairs = [(fold_conv_bn(module.conv_f0_blocks[i],
                               module.bn_f0_blocks[i]),
                  fold_conv_bn(module.conv_l0_blocks[i],
                               module.bn_l0_blocks[i])) for i in range(3)]
    assert got.dtype == torch.float32 and got.shape == (2, 21, 3, 128)
    nf = node_feat.float().numpy()
    nx = node_xyz.numpy()
    hi = jax.lax.Precision.HIGHEST
    for i, ((wf, bf), (wl, bl)) in enumerate(pairs):
        want = (jnp.einsum('bjc,cd->bjd', nf, wf.numpy(), precision=hi)
                + jnp.einsum('bjc,cd->bjd', nx, wl.numpy(), precision=hi)
                * (1.0 / radius[i]) - bf.numpy() - bl.numpy())
        np.testing.assert_allclose(got[:, :, i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


def test_desa_dense_default_takes_weights_or_their_pack():
    module = _module(2)
    pcl_feat, node_feat, pcl_xyz, node_xyz = _inputs(seed=2)
    args = (pcl_feat.to(BF), node_feat.to(BF), pcl_xyz, node_xyz)
    with torch.no_grad():
        w = module.folded_weights()
        unpacked = k1.desa_dense(*args, w, mode='default')
        packed = k1.desa_dense(*args, k1.serving_weights(w), mode='default')
    assert torch.equal(unpacked, packed)


def test_serving_launch_needs_cuda_tensors():
    pcl_feat, node_feat, pcl_xyz, node_xyz = _inputs(b=1, n=8, j=2)
    with torch.no_grad():
        pack = k1.serving_weights(_module().folded_weights())
    with pytest.raises(ValueError, match='CUDA'):
        k1.desa_dense_serving(pcl_feat.to(BF), node_feat.to(BF), pcl_xyz,
                              node_xyz, pack)


@pytest.mark.parametrize('fault', ['cpu', 'too_many_slots', 'two_radii'])
def test_serving_groups_refuses_what_the_kernel_cannot_take(fault):
    """The groups-only entry point checks before it passes a pointer: the
    kernel holds at most 64 slots per radius, for exactly 3 radii."""
    _, _, pcl_xyz, node_xyz = _inputs(b=1, n=8, j=2)
    radius, samples = (0.1, 0.2, 0.4), (64, 64, 64)
    if fault == 'too_many_slots':
        samples = (64, 65, 64)
    elif fault == 'two_radii':
        radius, samples = radius[:2], samples[:2]
    with pytest.raises(ValueError):
        k1.serving_groups(pcl_xyz, node_xyz, radius, samples)


@pytest.mark.parametrize('dtype', [torch.float32, BF],
                         ids=['highest', 'default'])
def test_desa_keeps_its_kernel_weights(dtype):
    """Two no_grad forwards and one under inference_mode share one cache
    entry; load_state_dict and an in-place change to a BatchNorm running
    statistic each remake it, and the output equals a fresh module's
    (whose forward, with gradients on, folds at the call) bit for bit."""
    args = _inputs(seed=3)
    module = set_compute_dtype(_module(3), dtype)

    def fresh_output():
        fresh = set_compute_dtype(DESA(128), dtype)
        fresh.load_state_dict(module.state_dict())
        with torch.enable_grad():
            out = fresh.eval()(*args)
        assert '_kernel_weights' not in fresh.__dict__
        return out.detach()

    with torch.no_grad():
        first = module(*args)
        entry = module._kernel_weights
        assert torch.equal(module(*args), first)
        with torch.inference_mode():
            assert torch.equal(module(*args), first)
        assert module._kernel_weights is entry
        if dtype == BF:
            assert isinstance(entry['default'], k1.ServingWeights)
        assert torch.equal(first, fresh_output())

        module.load_state_dict({k: v * 1.5 if v.is_floating_point() else v
                                for k, v in module.state_dict().items()})
        got = module(*args)
        assert module._kernel_weights is not entry
        assert torch.equal(got, fresh_output())
        assert not torch.equal(got, first)

        entry = module._kernel_weights
        module.bn_f0_blocks[1].running_mean.add_(0.25)
        moved = module(*args)
        assert module._kernel_weights is not entry
        assert torch.equal(moved, fresh_output())
        assert not torch.equal(moved, got)
