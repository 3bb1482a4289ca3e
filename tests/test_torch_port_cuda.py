"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda.py
(--noconftest: tests/conftest.py sets up JAX, which this file does not
need and a GPU machine may not have). Without a card every test skips.

Tolerances:
  * K2 (pixel sampler): 1e-6. The kernel and its plain version select the
    same 4 pixels (same d2 rounding, ties to the lower index) and weight
    and add them with the same float32 operations in the same order.
  * K1 (DESA): 1e-4 on values of order 1. Same groups; the plain version's
    matmuls (cuBLAS, TF32 off) sum the 128- and 512-wide products in
    another order than the kernel's per-thread loops.
  * K2 serving mode: one bfloat16 ulp; the kernel and its plain version
    select the same pixels and sum in the same order, so they are expected
    to agree bit for bit (the plain version's fused multiply-adds are
    emulated in float64, which can round a halfway case differently).
  * K1 serving mode: 1e-3 of the output's scale: sums in another order,
    then bfloat16 roundings of h1 and of the fusion input that can fall
    either way. The 'highest' arithmetic on the same bfloat16 inputs lies
    2.8e-3 of the scale or more away (measured on the CPU on these
    inputs), and the test checks that it fails the limit. chip_smoke.py
    measures the same at batch 64 on an H100: the kernel 2.29e-5 from its
    plain version, the 'highest' arithmetic 0.151, the limit 0.0355.
  * K3 (grouped MLP pool): 1e-4, as K1.
"""

import numpy as np
import pytest
import torch

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.synthetic import synthetic_batch
from keypointfusion_torch.geometry.camera import CropFrame
from keypointfusion_torch.kernels import desa_dense as k1
from keypointfusion_torch.kernels import grouped_mlp_pool as k3
from keypointfusion_torch.kernels import pixel_sampler as k2
from keypointfusion_torch.models.desa import DESA
from keypointfusion_torch.models.kpfusion import build_kpfusion


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc (the kernels are CUDA)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def flat_background_case(b=2, n=256, c=277, seed=0):
    """32x32 pixel centres on one depth plane and points on the same
    dyadic grid: every d2 is exact and equidistant pixels tie exactly,
    also between the 4th and 5th nearest."""
    rng = np.random.RandomState(seed)
    r = (np.arange(32, dtype=np.float32) + 0.5) / 16.0 - 1.0
    u, v = np.meshgrid(r, r)
    grid = np.stack([u, v, np.full_like(u, 0.5)], -1).reshape(-1, 3)
    img_xyz = np.broadcast_to(grid, (b, 1024, 3)).copy()
    k = rng.randint(-32, 33, (b, n, 2)).astype(np.float32) / 32.0
    pcl = np.concatenate([k, np.full((b, n, 1), 0.5, np.float32)], -1)
    feat = rng.randn(b, 1024, c).astype(np.float32)
    return pcl, img_xyz, feat


def desa_case(b=2, n=1024, seed=0):
    """Inputs and a seeded DESA with perturbed BatchNorm statistics; the
    first joint sits far from the cloud, so its balls hold only itself."""
    rng = np.random.RandomState(seed)
    inputs = [rng.randn(b, n, 128), rng.randn(b, 21, 128),
              rng.uniform(-1, 1, (b, n, 3)),
              rng.uniform(-0.5, 0.5, (b, 21, 3))]
    inputs = [x.astype(np.float32) for x in inputs]
    inputs[3][0, 0] = 5.0
    torch.manual_seed(seed)
    module = DESA(128)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    return inputs, module.eval()


@pytest.mark.cuda
def test_pixel_sampler_kernel_matches_plain_on_card(cuda_device):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in flat_background_case()]
    before = k2.KERNEL.launches
    got = k2.sample_pixel_features_fused(*args)
    want = k2.sample_pixel_features_plain(*args)
    assert k2.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('empty_first_ball', [False, True])
def test_desa_kernel_matches_plain_on_card(cuda_device, empty_first_ball):
    inputs, module = desa_case()
    radius = module.radius
    if empty_first_ball:
        # r^2 rounds to 0 in float32, so every first ball is empty and the
        # group falls back to the closest point; on a 1/64 grid a joint's
        # d2 to itself is exactly 0
        inputs[3] = np.round(inputs[3] * 64) / 64
        radius = (1e-23,) + radius[1:]
    module = module.to(cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in inputs]
    with torch.no_grad():
        w = module.folded_weights()
        before = k1.KERNEL.launches
        got = k1.desa_dense(*args, w, radius, module.num_samples)
        want = k1.desa_dense_plain(*args, w, radius, module.num_samples)
    assert k1.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_kpfusion_kernels_match_plain_on_card(cuda_device):
    """The whole forward through the kernels (K2 once, K1 once per block)
    against the plain path, at 1e-4 of each output's scale."""
    batch = synthetic_batch(batch_size=2, point_num=1024, seed=3)
    model = build_kpfusion(Config(), device=cuda_device)
    frame = CropFrame.from_batch(batch['cam_para'], batch['center'],
                                 batch['M'], batch['cube'],
                                 device=cuda_device)
    t = lambda k: torch.from_numpy(batch[k]).to(cuda_device)
    launches = (k2.KERNEL.launches, k1.KERNEL.launches)
    with torch.no_grad():
        got = model(t('rgb'), t('depth'), t('pcl'), frame)
        model.use_kernels = False
        want = model(t('rgb'), t('depth'), t('pcl'), frame)
    assert (k2.KERNEL.launches - launches[0],
            k1.KERNEL.launches - launches[1]) == (1, 2)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp of |x| (8 significant bits)."""
    m = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.cuda
def test_pixel_sampler_serving_kernel_matches_plain_on_card(cuda_device):
    """Flat background: whole tied rings are selected, more than 4 pixels
    for many points."""
    pcl, img_xyz, feat = [torch.from_numpy(x).to(cuda_device)
                          for x in flat_background_case()]
    feat = feat.to(torch.bfloat16)
    before = k2.SERVING_KERNEL.launches
    got = k2.sample_pixel_features_fused(pcl, img_xyz, feat, mode='default')
    want = k2.sample_pixel_features_plain(pcl, img_xyz, feat, mode='default')
    assert k2.SERVING_KERNEL.launches == before + 1
    assert got.dtype == torch.bfloat16
    d2 = k2.serving_sqdist(pcl, img_xyz)
    assert int((d2 <= k2.serving_threshold(d2)).sum(-1).max()) > 4
    assert bool(((got.float() - want.float()).abs()
                 <= bf16_ulp(want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize('empty_first_ball', [False, True])
def test_desa_serving_kernel_matches_plain_on_card(cuda_device,
                                                  empty_first_ball):
    inputs, module = desa_case()
    radius = module.radius
    if empty_first_ball:
        inputs[3] = np.round(inputs[3] * 64) / 64
        radius = (1e-23,) + radius[1:]
    module = module.to(cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in inputs]
    args[0], args[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    with torch.no_grad():
        w = module.folded_weights()
        before = k1.SERVING_KERNEL.launches
        got = k1.desa_dense(*args, w, radius, module.num_samples,
                            mode='default')
        want = k1.desa_dense_plain(*args, w, radius, module.num_samples,
                                   mode='default')
        other = k1.desa_dense_plain(*args, w, radius, module.num_samples,
                                    mode='highest')
    assert k1.SERVING_KERNEL.launches == before + 1
    tol = 1e-3 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert float((other - want).abs().max()) > tol


@pytest.mark.cuda
def test_grouped_mlp_pool_kernel_matches_plain_on_card(cuda_device):
    """K3 through desa_apply_inference at B=2 (three launches, one per
    radius), against the same function with the plain K3."""
    inputs, module = desa_case()
    module = module.to(cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in inputs]
    before = k3.KERNEL.launches
    with torch.no_grad():
        got = k3.desa_apply_inference(module, *args)
        want = k3.desa_apply_inference(module, *args, use_kernel=False)
    assert k3.KERNEL.launches - before == 3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
