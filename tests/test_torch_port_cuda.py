"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU and nvcc:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda.py
(--noconftest: tests/conftest.py sets up JAX, which this file does not
need and a GPU machine may not have). Without a card every test skips.

Tolerances:
  * K2 (pixel sampler): 0, bit for bit. The kernel and its plain version
    select the same 4 pixels (same d2 rounding, ties to the lower index)
    and weight and add them with the same float32 operations in the same
    order. The cases (HIGHEST_SAMPLER_CASES): random, a flat background
    (4th/5th-nearest ties), every slot tied (pixel centres at 3
    positions), HW = 256 with N = 100 (not a multiple of the kernel's
    points per block), HW = 100 (not a multiple of 32) with points on the
    axes, and HW = 2048 (MAX_HW).
  * K1 (DESA): 1e-4 on values of order 1 (scales 20-35 here). Same
    groups; the kernel runs each product as three TF32 products with
    float32 sums, the plain version's matmuls (cuBLAS, TF32 off) in
    float32. One TF32 product per product (the plain version with TF32
    on) lies outside the limit, and the test checks that it does; each
    case records its errors, as the serving mode's do.
  * K2 serving mode: one bfloat16 ulp; the kernel and its plain version
    select the same pixels and sum in the same order, so they are expected
    to agree bit for bit (the plain version's fused multiply-adds are
    emulated in float64, which can round a halfway case differently). The
    cases (SERVING_SAMPLER_CASES): a flat background (whole tied rings),
    every pixel selected, HW = 2048 (MAX_HW), C = 384 (MAX_SERVING_C), and
    N = 1000 (not a multiple of the kernel's points per block).
  * K1 serving mode: 5e-4 of the output's scale: sums in another order
    (the tensor cores' against cuBLAS's), then bfloat16 roundings of h1
    and of the fusion input that can fall either way. Plain versions that
    leave h1 or the fusion input in float32, and the 'highest' arithmetic,
    lie 7.9e-4 of the scale or more away in every case (CPU, these
    inputs), and the test checks that each fails the limit. The limit is
    half chip_smoke.py's (1e-3 at batch 64): over 2 elements a max of
    rounding flips is smaller, and one joint's fusion-input control lies
    inside 1e-3. Each case records its errors (`record_property`; keep
    them with --junitxml=FILE -o junit_family=xunit1). The kernel's
    groups equal the plain ball query's slot by slot.
  * K3 (grouped MLP pool): 1e-4, as K1: the kernel's three TF32 products
    per product against float32 products (one TF32 product lies some 0.01
    away; tests/test_torch_port_k3.py). The direct cases (K3_CASES): S 64,
    17, 1 and 130 (rows padded to a warp's 16, a group longer than a
    block's 64-row step), group counts that leave a block's pair half
    empty (B=1, J=21; B=3), more groups than the grid has blocks, and a
    group whose every slot but 0 lies outside the ball; rel uniform in
    [-1.2, 1.2] everywhere, so slots fall on both sides of the mask.
  * The feature types' decode, MANO and DESA's dense train step hold
    chip_smoke.py's limits (TRAINER_MM_TOL, MANO_TOL, TRAIN_TOL).
  * The optional model families (models/legacy.py, rgbd_fusion.py,
    transformer_extra.py) at narrow widths, batch 2: the eval forward,
    one train step's gradients and the statistics' change on the card
    against the CPU within chip_smoke.py's OPTIONAL_TOL, no kernel
    launched; occlusion's mask_image and joint_visibility equal on the
    card and the CPU given the same draws.
  * The multi-device paths and the native core, as chip_smoke.py's
    [parallel] and [native] phases hold them: two engine replicas on the
    card against one engine at batch 8 (float32 within SERVING_TOL, 0.0125
    mm; bfloat16 within replica_errors' budget; K2 twice and K1 four
    times a request); global_batch_norm in an NCCL world of one against
    torch's BatchNorm within PARALLEL_BN_TOL of scale; the fixture's test
    split through data/native.py against the JAX core's stored samples,
    tolerance 0. A spawned two-rank gloo step costs ~25 s on the card's
    machine and stays in chip_smoke.py's [parallel] only.
  * The debug renderers (utils/vis.py) on the [vis_debug] fixture's
    inputs against the JAX package's digests, tolerance 0, so that the
    card's machine's numpy is held outside chip_smoke.py too.
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
from keypointfusion_torch.ops.ball_query import ball_query_slots
from keypointfusion_torch.ops.pairwise import pairwise_sqdist


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc (the kernels are CUDA)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def sampler_case(kind, b=2, n=256, hw=1024, c=277, seed=0):
    """K2 inputs as numpy arrays (pcl, img_xyz, feat float32).
    'random': uniform points and pixel centres (4 pixels selected each).
    'flat_background': HW pixel centres 32 to a row on one depth plane and
    points on the same dyadic grid, so equidistant pixels tie exactly and
    whole rings are selected, also across the 4th/5th nearest.
    'three_positions': the pixel centres sit at 3 positions, so no point
    has a 4th distinct distance: the serving mode selects all HW pixels,
    and every one of the 4 nearest is a tie. 'axes': uniform pixel
    centres and points on the coordinate axes (two of each point's
    coordinates 0)."""
    rng = np.random.RandomState(seed)
    if kind == 'random':
        pcl = rng.uniform(-.9, .9, (b, n, 3))
        img_xyz = rng.uniform(-1, 1, (b, hw, 3))
    elif kind == 'axes':
        img_xyz = rng.uniform(-1, 1, (b, hw, 3))
        pcl = np.zeros((b, n, 3))
        axis = rng.randint(0, 3, (b, n))
        np.put_along_axis(pcl, axis[..., None],
                          rng.uniform(-.9, .9, (b, n, 1)), -1)
    elif kind == 'flat_background':
        rows = hw // 32
        u, v = np.meshgrid((np.arange(32) + 0.5) / 16.0 - 1.0,
                           (np.arange(rows) + 0.5) / 16.0 - rows / 32.0)
        grid = np.stack([u, v, np.full_like(u, 0.5)], -1).reshape(-1, 3)
        img_xyz = np.broadcast_to(grid, (b, hw, 3))
        pcl = np.concatenate(
            [rng.randint(-32, 33, (b, n, 1)) / 32.0,
             rng.randint(-rows, rows + 1, (b, n, 1)) / 32.0,
             np.full((b, n, 1), 0.5)], -1)
    elif kind == 'three_positions':
        where = rng.uniform(-1, 1, (b, 3, 3))
        img_xyz = where[np.arange(b)[:, None], rng.randint(0, 3, (b, hw))]
        pcl = rng.uniform(-.9, .9, (b, n, 3))
    else:
        raise ValueError(kind)
    feat = rng.randn(b, hw, c)
    return [np.ascontiguousarray(x, dtype=np.float32)
            for x in (pcl, img_xyz, feat)]


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


# name -> sampler_case arguments, K2 'highest'
HIGHEST_SAMPLER_CASES = {
    'random': dict(kind='random'),
    'flat_background': dict(kind='flat_background'),
    'all_tied': dict(kind='three_positions'),
    'hw_256_n_100': dict(kind='flat_background', hw=256, n=100),
    'hw_100_axes': dict(kind='axes', hw=100),
    'hw_2048': dict(kind='flat_background', hw=2048),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(HIGHEST_SAMPLER_CASES))
def test_pixel_sampler_kernel_matches_plain_on_card(cuda_device, case):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in sampler_case(**HIGHEST_SAMPLER_CASES[case])]
    before = k2.KERNEL.launches
    got = k2.sample_pixel_features_fused(*args)
    want = k2.sample_pixel_features_plain(*args)
    assert k2.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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


# name -> sampler_case arguments, K2 'default'
SERVING_SAMPLER_CASES = {
    'flat_background': dict(kind='flat_background'),
    'all_selected': dict(kind='three_positions'),
    'hw_2048': dict(kind='flat_background', hw=2048),
    'c_384': dict(kind='flat_background', c=384),
    'n_1000': dict(kind='flat_background', n=1000),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(SERVING_SAMPLER_CASES))
def test_pixel_sampler_serving_kernel_matches_plain_on_card(cuda_device,
                                                            case):
    """Each case of SERVING_SAMPLER_CASES: the flat backgrounds select
    whole tied rings, more than 4 pixels for many points; 'all_selected'
    every pixel for every point."""
    pcl, img_xyz, feat = [
        torch.from_numpy(x).to(cuda_device)
        for x in sampler_case(**SERVING_SAMPLER_CASES[case])]
    feat = feat.to(torch.bfloat16)
    before = k2.SERVING_KERNEL.launches
    got = k2.sample_pixel_features_fused(pcl, img_xyz, feat, mode='default')
    want = k2.sample_pixel_features_plain(pcl, img_xyz, feat, mode='default')
    assert k2.SERVING_KERNEL.launches == before + 1
    assert got.dtype == torch.bfloat16
    d2 = k2.serving_sqdist(pcl, img_xyz)
    counts = (d2 <= k2.serving_threshold(d2)).sum(-1)
    if case == 'all_selected':
        assert bool((counts == img_xyz.shape[1]).all())
    else:
        assert int(counts.max()) > 4
    assert bool(((got.float() - want.float()).abs()
                 <= bf16_ulp(want)).all())


DESA_CASES = ('ordinary', 'empty_first_ball', 'five_joints', 'one_joint',
              'full_groups', 'small_groups')
SERVING_TOL = 5e-4     # of the scale
HIGHEST_TOL = 1e-4


def desa_variant(case, device):
    """desa_case() on `device` in one of DESA_CASES: J not a multiple of
    the kernels' joint tiles (5) and J = 1, every group full (64 slots,
    radius 2), groups of under 16 slots (one warp of four per group busy),
    every first ball empty. Returns (inputs, module, radius,
    num_samples)."""
    inputs, module = desa_case()
    radius, num_samples = module.radius, module.num_samples
    if case == 'empty_first_ball':
        inputs[3] = np.round(inputs[3] * 64) / 64
        radius = (1e-23,) + radius[1:]
    elif case in ('five_joints', 'one_joint'):
        j = 5 if case == 'five_joints' else 1
        inputs[1], inputs[3] = inputs[1][:, :j], inputs[3][:, :j]
    elif case == 'full_groups':
        inputs[3][0, 0] = 0.0
        radius = (2.0, 2.0, 2.0)
    elif case == 'small_groups':
        num_samples = (5, 11, 15)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in inputs]
    return args, module.to(device), radius, num_samples


@pytest.mark.cuda
@pytest.mark.parametrize('case', DESA_CASES)
def test_desa_highest_kernel_cases_on_card(cuda_device, case,
                                           record_property):
    """K1 'highest' in every case of desa_variant. The public entry point
    with unpacked weights gives the same bits as a packed launch; the
    plain version with one TF32 pass per product lies outside the
    limit."""
    args, module, radius, num_samples = desa_variant(case, cuda_device)
    with torch.no_grad():
        w = module.folded_weights()
        pack = k1.highest_weights(w)
        before = k1.KERNEL.launches
        got = k1.desa_dense_highest(*args, pack, radius, num_samples)
        entry = k1.desa_dense(*args, w, radius, num_samples)
        want = k1.desa_dense_plain(*args, w, radius, num_samples)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            one_pass = k1.desa_dense_plain(*args, w, radius, num_samples)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert k1.KERNEL.launches == before + 2
    assert torch.equal(entry, got)
    err = float((got - want).abs().max())
    control = float((one_pass - want).abs().max())
    record_property('scale', float(want.abs().max()))
    record_property('max_abs_err', err)
    record_property('tf32_1pass_vs_plain', control)
    torch.testing.assert_close(got, want, rtol=0, atol=HIGHEST_TOL)
    assert control > HIGHEST_TOL, control


@pytest.mark.cuda
@pytest.mark.parametrize('case', DESA_CASES)
def test_desa_serving_kernel_matches_plain_on_card(cuda_device, case,
                                                   record_property):
    """K1 'default' in every case of desa_variant. The public entry
    point with unpacked weights gives the same bits as a packed launch;
    the kernel's groups are the plain ball query's; each control lies
    outside the limit."""
    args, module, radius, num_samples = desa_variant(case, cuda_device)
    args[0], args[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    with torch.no_grad():
        w = module.folded_weights()
        pack = k1.serving_weights(w)
        before = k1.SERVING_KERNEL.launches
        got = k1.desa_dense_serving(*args, pack, radius, num_samples)
        entry = k1.desa_dense(*args, w, radius, num_samples, mode='default')
        sel, nsel = k1.serving_groups(args[2], args[3], radius, num_samples)
        want = k1.desa_dense_plain(*args, w, radius, num_samples,
                                   mode='default')
        controls = {
            'highest': k1.desa_dense_plain(*args, w, radius, num_samples,
                                           mode='highest'),
            'h1_float32': k1._desa_serving_plain(
                *args, pack, radius, num_samples, keep_float32=('h1',)),
            'fusion_float32': k1._desa_serving_plain(
                *args, pack, radius, num_samples, keep_float32=('fusion',))}
    assert k1.SERVING_KERNEL.launches == before + 2
    assert torch.equal(entry, got)
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    dist = {k: float((v - want).abs().max()) for k, v in controls.items()}
    record_property('scale', scale)
    record_property('max_abs_err', err)
    for k, v in dist.items():
        record_property(f'{k}_vs_plain', v)
    tol = SERVING_TOL * scale
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert min(dist.values()) > tol, dist
    d2 = pairwise_sqdist(args[3], torch.cat([args[2], args[3]], 1))
    for i, (r, s) in enumerate(zip(radius, num_samples)):
        idx, valid = ball_query_slots(d2, r, s)
        assert torch.equal(nsel[:, :, i], valid.sum(-1).int())
        assert torch.equal(sel[:, :, i, :s].long(),
                           torch.where(valid, idx, -1))
        assert bool((sel[:, :, i, s:] == -1).all())
    if case == 'full_groups':
        assert bool(ball_query_slots(d2, 2.0, 64)[1].all())


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


# name -> (B, J, S) of a direct K3 call
K3_CASES = {'s64': (2, 21, 64), 's17': (2, 21, 17), 's1': (2, 21, 1),
            's130': (2, 5, 130), 'b1_j21': (1, 21, 64), 'b3': (3, 21, 64),
            'more_groups_than_blocks': (16, 21, 64),
            'empty_ball': (1, 3, 64)}


def k3_case(b, j, s, empty_ball=False, seed=0):
    """K3's inputs as numpy arrays: rel uniform in [-1.2, 1.2], features
    and weights from a seed (the weights' scales of
    tests/test_torch_port_k3.py); with empty_ball every slot but 0 of
    every group lies outside the ball."""
    rng = np.random.RandomState(seed)
    c = 128
    rel = rng.uniform(-1.2, 1.2, (b, j, s, 3))
    if empty_ball:
        rel[:, :, 1:, 0] = rng.choice([-1, 1], (b, j, s - 1)) * \
            rng.uniform(1.01, 1.2, (b, j, s - 1))
    grouped = rng.randn(b, j, s, c)
    node = rng.randn(b, j, c)
    w = [rng.randn(*shape) * sd for shape, sd in
         (((3, c), 0.5), ((c,), 0.1), ((c, c), 0.1), ((c,), 0.1),
          ((c, c), 0.1), ((c,), 0.1))]
    return [np.ascontiguousarray(x, dtype=np.float32)
            for x in [rel, grouped, node] + w]


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(K3_CASES))
def test_grouped_mlp_pool_direct_on_card(cuda_device, case):
    """K3's entry point against its plain version, one launch a call."""
    args = [torch.from_numpy(x).to(cuda_device) for x in
            k3_case(*K3_CASES[case], empty_ball=case == 'empty_ball')]
    rel = args[0]
    keep = (rel * rel).sum(-1) < 1
    if case == 'empty_ball':
        assert not bool(keep[..., 1:].any())
    elif K3_CASES[case][2] > 1:
        assert bool(keep.any()) and bool((~keep[..., 1:]).any())
    before = k3.KERNEL.launches
    got = k3.grouped_mlp_pool(*args)
    assert k3.KERNEL.launches - before == 1
    want = k3.grouped_mlp_pool_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def train_on(device, cfg, batch, dropout=0.0):
    """One train step of a state drawn from seed 0 on `device`: (model,
    loss, launches of every kernel during the step)."""
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, make_train_step,
    )
    b = batch_to_device(batch, device)
    state = create_train_state(cfg, b, device=device, seed=0,
                               dropout=dropout)
    kernels = (k1.KERNEL, k1.SERVING_KERNEL, k2.KERNEL, k2.SERVING_KERNEL,
               k3.KERNEL)
    for k in kernels:
        k.launches = 0
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.backends.mkldnn.flags(enabled=False):
        state, metrics = make_train_step(cfg)(state, b, gen, 0)
    return (state.model, float(metrics['loss']),
            {k.name: k.launches for k in kernels})


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One SGD-momentum step (lr 1e-3, dropout 0, float32) at batch 2 with
    256 points on the card and on the CPU from the same weights, held by
    chip_smoke.py's float32 TRAIN_TOL (which says why): the loss, each
    parameter, each running statistic, the update over all parameters
    against the CPU's and against -lr times the card's own gradient, and
    the statistics' change; the card's update and statistics' change
    skipped, halved or doubled fail those three lines. The step launches no
    kernel: K1 and K2 are eval-only."""
    from chip_smoke import (
        TRAIN_TOL, state64, step_grads, train_step_failures,
    )
    lr, tol = 1e-3, TRAIN_TOL['float32']
    cfg = Config(opt='sgd', lr=lr)
    batch = synthetic_batch(batch_size=2, point_num=256, seed=42)
    start = state64(build_kpfusion(cfg, device='cpu', seed=0))
    card, card_loss, launches = train_on(cuda_device, cfg, batch)
    cpu, cpu_loss, _ = train_on('cpu', cfg, batch)
    assert not any(launches.values()), launches
    assert abs(card_loss - cpu_loss) <= tol['loss_rel'] * abs(cpu_loss)
    for (name, x), y in zip(card.state_dict().items(),
                            cpu.state_dict().values()):
        if not x.is_floating_point():
            assert torch.equal(x.cpu(), y), name
    failures, errors, controls = train_step_failures(
        state64(card), state64(cpu), start, step_grads(card), lr, tol)
    assert not failures, (failures, errors, controls)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', ['float32', 'mixed', 'bfloat16'])
def test_train_step_launches_no_kernel_on_card(cuda_device, compute_dtype):
    """A train step with dropout 0.1 from a CUDA generator, batch 2 at
    full width: finite loss, every launch counter 0."""
    batch = synthetic_batch(batch_size=2, point_num=1024, seed=3)
    _, loss, launches = train_on(
        cuda_device, Config(compute_dtype=compute_dtype), batch, 0.1)
    assert np.isfinite(loss)
    assert not any(launches.values()), launches


def small_trainer(cuda_device, tmp_path, name, **kw):
    """A float32 Trainer at batch 8 and 256 points on the card: 16
    training samples (2 steps an epoch), 12 test samples (a batch of 8,
    then 4 padded)."""
    import dataclasses
    from keypointfusion_torch.data.synthetic import synthetic_dataset
    from keypointfusion_torch.training.trainer import Trainer

    @dataclasses.dataclass(frozen=True)
    class TwoEpochs(Config):
        epochs: int = 2

        @property
        def max_epoch(self) -> int:
            return self.epochs

    cfg = TwoEpochs(batch_size=8, point_num=256, seed=0, pretrain='', **kw)
    return Trainer(cfg, synthetic_dataset(16, 256, seed=10),
                   synthetic_dataset(12, 256, seed=40),
                   model_dir=str(tmp_path / name), device=cuda_device)


@pytest.mark.cuda
def test_trainer_resume_on_card(cuda_device, tmp_path):
    """chip_smoke.py's resume check at its size (batch 64, 1024 points,
    256 training samples, 2 epochs): the restored state is the saved one
    bit for bit, the resumed run lies within RESUME_TOL of the straight
    run, and a control resumed without the optimizer's state fails every
    limit; the restored AdamW step counts are on the host."""
    import dataclasses
    from chip_smoke import resume_runs, trainer_state
    from keypointfusion_torch.data.synthetic import synthetic_dataset
    from keypointfusion_torch.training.trainer import Trainer

    @dataclasses.dataclass(frozen=True)
    class TwoEpochs(Config):
        epochs: int = 2

        @property
        def max_epoch(self) -> int:
            return self.epochs

    cfg = TwoEpochs(batch_size=64, point_num=1024, seed=0, pretrain='')
    train_set = synthetic_dataset(256, 1024, seed=1000)
    make = lambda name, c=cfg: Trainer(c, train_set,
                                       model_dir=str(tmp_path / name),
                                       device=cuda_device)
    straight = make('straight')
    start = trainer_state(straight)
    straight.train()
    failures, errors, control_errors, resumed = resume_runs(
        make, cfg, start, trainer_state(straight))
    assert not failures, (failures, errors, control_errors)
    # AdamW's step counts stay on the host (on the card each costs a wait)
    assert all(s['step'].device.type == 'cpu'
               for s in resumed.state.optimizer.state.values())


@pytest.mark.cuda
def test_device_prefetch_from_pinned_memory(cuda_device):
    """20 batches through device_prefetch while the consuming stream is
    kept busy: each equals its host batch, in order. The host arrays are
    handed over and dropped, so only the prefetcher's pinned buffers hold
    the data while the copies run."""
    from keypointfusion_torch.data.pipeline import device_prefetch
    rng = np.random.RandomState(0)
    want = [{'x': rng.randn(64, 128, 128).astype(np.float32),
             'i': np.full((64,), i, np.int64)} for i in range(20)]

    def batches():
        for w in want:
            yield {k: v.copy() for k, v in w.items()}

    busy = torch.randn(4096, 4096, device=cuda_device)
    sums = []
    for got in device_prefetch(batches(), cuda_device, depth=3):
        for _ in range(4):
            busy = busy @ busy / 64.0
        sums.append({k: v.clone() for k, v in got.items()})
    torch.cuda.synchronize()
    assert len(sums) == 20
    for got, w in zip(sums, want):
        for k in w:
            assert np.array_equal(got[k].cpu().numpy(), w[k]), k


@pytest.mark.cuda
def test_trainer_test_kernels_match_plain_on_card(cuda_device, tmp_path):
    """test() through K1 and K2 'highest' against test() on the plain
    path, block 2 taking the same inputs on both (chip_smoke.py's
    Block2Inputs): every stage's error and PA error of every sample and
    joint within chip_smoke.py's TRAINER_MM_TOL; 2 K2 and 4 K1 launches
    for its 2 batches."""
    from chip_smoke import TRAINER_MM_TOL, Block2Inputs
    from keypointfusion_torch.kernels import desa_dense as k1
    from keypointfusion_torch.kernels import pixel_sampler as k2
    trainer = small_trainer(cuda_device, tmp_path, 'test', phase='test')
    rows = []
    stage_results = trainer._stage_results
    trainer._stage_results = lambda batch: rows.append(
        stage_results(batch)) or rows[-1]
    block2 = Block2Inputs(trainer.state.model)
    k1.KERNEL.launches = k2.KERNEL.launches = 0
    trainer.test()
    assert (k2.KERNEL.launches, k1.KERNEL.launches) == (2, 4)
    trainer.state.model.use_kernels = False
    block2.replay()
    trainer.test()
    block2.remove()
    got, want = rows[:2], rows[2:]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g[..., :2] - w[..., :2]).max() <= TRAINER_MM_TOL


@pytest.mark.cuda
def test_data_path_on_card_machine(cuda_device, tmp_path):
    """The committed DexYCB fixture (tests/fixtures/torch_port_dexycb) on
    the card's machine, which has no cv2 and no JAX: the port decodes its
    images to the stored cv2 decode, bit for bit, and builds the stored
    JAX samples (rgb bit for bit, the rest within chip_smoke.py's
    DATA_SAMPLE_TOL); then the trainer loads a tree over its frames
    (batch 8, 256 points, 16 training and 12 test annotations) and trains
    one epoch on the card, its test() launching K2 'highest' once and K1
    'highest' twice a batch."""
    import dataclasses
    import os
    from chip_smoke import DATA_FIXTURE, DATA_SAMPLE_TOL, write_dexycb_tree
    from keypointfusion_torch.data.datasets import DexYCBDataset
    from keypointfusion_torch.data.image_io import imread
    from keypointfusion_torch.kernels import desa_dense as k1
    from keypointfusion_torch.kernels import pixel_sampler as k2
    from keypointfusion_torch.training.trainer import Trainer

    fixture = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), DATA_FIXTURE)
    decoded = np.load(os.path.join(fixture, 'decoded.npz'))
    for name in decoded.files:
        colour = name.startswith('color_')
        path = os.path.join(fixture, 'DexYCB', 'imgs',
                            name + ('.jpg' if colour else '.png'))
        assert np.array_equal(imread(path, anydepth=not colour),
                              decoded[name]), name
    stored = np.load(os.path.join(fixture, 'samples.npz'))
    for split, indices in (('train', (1, 2)), ('test', (0, 3))):
        ds = DexYCBDataset('s0', split, fixture, sample_num=1024, seed=7)
        for i in indices:
            for k, v in ds[i].items():
                want = stored[f'{split}_{i}_{k}']
                tol = 0.0 if k == 'rgb' else DATA_SAMPLE_TOL
                assert np.abs(v.astype(np.float64) - want).max() <= tol, k

    @dataclasses.dataclass(frozen=True)
    class OneEpoch(Config):
        epochs: int = 1

        @property
        def max_epoch(self) -> int:
            return self.epochs

    root = str(tmp_path / 'data')
    write_dexycb_tree(root, fixture, 16, 12)
    trainer = Trainer(OneEpoch(root_dir=root, batch_size=8, point_num=256,
                               seed=0, pretrain=''),
                      model_dir=str(tmp_path / 'run'), device=cuda_device)
    assert (len(trainer.train_data), len(trainer.test_data)) == (16, 12)
    k1.KERNEL.launches = k2.KERNEL.launches = 0
    assert np.isfinite(trainer.train())
    assert trainer.state.step == 2
    assert (k2.KERNEL.launches, k1.KERNEL.launches) == (2, 4)


@pytest.mark.cuda
def test_demo_kernels_match_plain_on_card(cuda_device):
    """ModelRGBD on the card at batch 1 (the fixture's test frame 0):
    K2 'highest' once and K1 'highest' twice a frame, and the joints
    within chip_smoke.py's DEMO_TOL (normalized units) of the plain path
    on the same point draws."""
    from chip_smoke import DEMO_TOL, demo_frame, demo_normalized
    from keypointfusion_torch import demo

    inp, cam = demo_frame(0)
    model = demo.ModelRGBD(Config(phase='test'), cam, device=cuda_device)
    answers = []
    for use_kernels in (True, False):
        model.np_rng = np.random.RandomState(model.cfg.seed)
        model.model.use_kernels = use_kernels
        launches = (k2.KERNEL.launches, k1.KERNEL.launches)
        meta, out = model.estimate_pose_rgbd([inp])
        if use_kernels:
            assert (k2.KERNEL.launches - launches[0],
                    k1.KERNEL.launches - launches[1]) == (1, 2)
        answers.append(demo_normalized(model, meta[0], out[0]))
    for g, w in zip(*answers):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= DEMO_TOL


@pytest.mark.cuda
@pytest.mark.parametrize('feature_type', ['offset', 'heatmap',
                                          'weight_offset_nosoftmax'])
def test_feature_type_decode_kernels_match_plain_on_card(cuda_device,
                                                         feature_type):
    """An eval batch (batch 2, 1024 points) decoded by the feature type
    through the trainer's _decode_stage (chip_smoke.py:decode_stages):
    K2 'highest' once and K1 'highest' twice, and every stage within
    chip_smoke.py's TRAINER_MM_TOL (mm) of the plain path, non-finite
    joints (the nosoftmax decode on random weights) at the same places."""
    from chip_smoke import TRAINER_MM_TOL, decode_stages
    from keypointfusion_torch.training.train_step import batch_to_device
    cfg = Config(feature_type=(feature_type,))
    batch = batch_to_device(synthetic_batch(batch_size=2, point_num=1024,
                                            seed=5), cuda_device)
    model = build_kpfusion(cfg, device=cuda_device, seed=0)
    k1.KERNEL.launches = k2.KERNEL.launches = 0
    got = decode_stages(model, batch, cfg, True)
    assert (k2.KERNEL.launches, k1.KERNEL.launches) == (1, 2)
    want = decode_stages(model, batch, cfg, False)
    same = (got == want) | (got.isnan() & want.isnan())
    assert float(torch.where(same, torch.zeros_like(got),
                             (got - want).abs()).max()) <= TRAINER_MM_TOL


@pytest.mark.cuda
def test_mano_on_card_matches_cpu(cuda_device):
    """mano_forward (PCA with betas and trans; rotation matrices) and
    ManoRegHead's outputs and gradients at batch 4 on the card against the
    CPU within chip_smoke.py's MANO_TOL of each tensor's scale, and no
    wait for the card inside a call."""
    from chip_smoke import MANO_TOL, count_waits
    from keypointfusion_torch.mano.assets import synthetic_mano_model
    from keypointfusion_torch.mano.mano_head import ManoRegHead
    from keypointfusion_torch.mano.manolayer import (
        ManoLayer, batch_rodrigues, mano_forward,
    )
    asset = synthetic_mano_model()
    rng = np.random.RandomState(0)
    x = {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
        'pose': rng.randn(4, 48) * 0.5, 'betas': rng.randn(4, 10),
        'trans': rng.randn(4, 3) * 0.1, 'aa': rng.randn(4, 16, 3) * 0.7,
        'feat': rng.randn(4, 256)}.items()}
    cpu_head = ManoRegHead(asset, 256, (128, 64), device='cpu')

    def run(where):
        layer = ManoLayer(asset, device=where)
        head = ManoRegHead(layer, 256, (128, 64), device=where)
        head.load_state_dict(cpu_head.state_dict())
        d = {k: v.to(where) for k, v in x.items()}
        out = dict(zip(('pca_v', 'pca_j'), mano_forward(
            layer, d['pose'], betas=d['betas'], trans=d['trans'])))
        out.update(zip(('rot_v', 'rot_j'), mano_forward(
            layer, None, betas=d['betas'],
            pose_rotmats=batch_rodrigues(d['aa']))))
        res = head(d['feat'])
        (res['verts3d'].square().mean() + res['joints3d'].square().mean()
         + res['mano_pose_aa'].square().mean()).backward()
        out.update({k: res[k] for k in ('verts3d', 'joints3d')})
        out.update({f'grad {k}': p.grad for k, p in
                    head.named_parameters()})
        if where != 'cpu':
            _, sites = count_waits(lambda: head(d['feat']))
            assert not sites, sites
        return {k: v.detach().cpu().double() for k, v in out.items()}

    want, got = run('cpu'), run(cuda_device)
    for k, w in want.items():
        tol = MANO_TOL['grad' if k.startswith('grad') else 'mesh']
        assert float((got[k] - w).abs().max()) \
            <= tol * max(1.0, float(w.abs().max())), k


@pytest.mark.cuda
def test_dense_train_step_matches_gather_on_card(cuda_device):
    """chip_smoke.py's compare_steps of the train step with DESA's dense
    form against its gather form, both on the card, at batch 2 with 256
    points: within TRAIN_TOL['float32'] (it raises otherwise)."""
    from chip_smoke import compare_steps
    out = compare_steps([(cuda_device, False), (cuda_device, True)],
                        'float32', 'KPFusion-resnet-18', 2)
    assert out['update_rel'] <= out['tol']['update_rel']


OPTIONAL_CARD_SHAPES = {
    'posenet': [(2, 64, 64, 1)],
    'centernet': [(2, 64, 64, 1)],
    'cbam': [(2, 12, 10, 64)],
    'rgbd_resnet_unet': [(2, 64, 64, 3), (2, 64, 64, 1)],
    'detr_decoder': [(2, 21, 128), (2, 8, 8, 128)],
    'spatial_aggregate_tr': [(2, 8, 8, 128), (2, 21, 128)],
}


def optional_card_model(name):
    """The family `name` at the CPU tests' narrow widths (DETR's layers
    at dropout 0)."""
    from keypointfusion_torch.models import legacy, rgbd_fusion
    from keypointfusion_torch.models import transformer_extra as tx
    return {
        'posenet': lambda: legacy.PoseNet(nstack=2, inp_dim=32),
        'centernet': legacy.CenterNetRegressor,
        'cbam': lambda: legacy.CBAM(64),
        'rgbd_resnet_unet': rgbd_fusion.RGBDResNetUNet,
        'detr_decoder': lambda: tx.DetrDecoder(layers=2, dropout=0.0),
        'spatial_aggregate_tr': lambda: tx.SpatialAggregateTR(
            layers=2, dropout=0.0),
    }[name]()


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(OPTIONAL_CARD_SHAPES))
def test_optional_family_on_card_matches_cpu(cuda_device, name):
    """chip_smoke.py's family_pass on the card against the CPU (eval
    outputs, gradients, the statistics' change) within OPTIONAL_TOL, in
    float64 on both sides (at batch 2 on 64x64 frames the last stages'
    train-mode BatchNorms normalize 8 values a channel, which turns
    float32 rounding into gradient noise; chip_smoke.py's phase holds
    float32 at full size), and no kernel launched on the card."""
    import copy
    from chip_smoke import family_errors, family_inputs, family_outputs, \
        family_pass
    from keypointfusion_torch.models.layers import set_compute_dtype
    torch.manual_seed(0)
    model = set_compute_dtype(optional_card_model(name).double(),
                              torch.float64)
    xs = [x.double() for x in family_inputs(OPTIONAL_CARD_SHAPES[name], 1,
                                            'cpu')]
    rng = np.random.RandomState(2)
    with torch.no_grad():
        cots = [torch.from_numpy(rng.randn(*o.shape))
                for o in family_outputs(model.eval()(*xs))]
    want = family_pass(copy.deepcopy(model), xs, cots)
    kernels = (k2.KERNEL, k1.KERNEL, k2.SERVING_KERNEL, k1.SERVING_KERNEL,
               k3.KERNEL)
    before = [k.launches for k in kernels]
    got = family_pass(copy.deepcopy(model).to(cuda_device),
                      [x.to(cuda_device) for x in xs],
                      [c.to(cuda_device) for c in cots])
    assert [k.launches for k in kernels] == before
    errors = family_errors(got, want)
    assert max(errors.values()) <= 1.0, errors


@pytest.mark.cuda
def test_occlusion_on_card_matches_cpu(cuda_device):
    """mask_image (the same draws, made on the CPU) and joint_visibility
    on the card equal to the CPU; a card generator's draws stay on the
    card."""
    from keypointfusion_torch.data import occlusion
    rng = np.random.RandomState(3)
    depth = torch.from_numpy(rng.uniform(-1, 0.5, (4, 32, 32, 1)).astype(
        np.float32))
    joints = torch.from_numpy(rng.uniform(-0.6, 0.6, (4, 21, 3)).astype(
        np.float32))
    pcl = torch.from_numpy(rng.uniform(-0.6, 0.6, (4, 512, 3)).astype(
        np.float32))
    draws = occlusion.mask_image_draws(
        4, 21, 6, torch.Generator().manual_seed(0), 'cpu')
    want = occlusion.mask_image_from_draws(depth, joints, *draws)
    got = occlusion.mask_image_from_draws(
        depth.to(cuda_device), joints.to(cuda_device),
        *[d.to(cuda_device) for d in draws])
    assert torch.equal(got.cpu(), want) and bool((want == 1).any())
    for kernel in (0.1, 0.2):
        assert torch.equal(occlusion.joint_visibility(
            pcl.to(cuda_device), joints.to(cuda_device), kernel).cpu(),
            occlusion.joint_visibility(pcl, joints, kernel))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    out = occlusion.mask_image(depth.to(cuda_device),
                               joints.to(cuda_device), gen)
    assert out.device.type == 'cuda' and out.shape == depth.shape


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_engine_replicas_match_one_engine_on_card(cuda_device, dtype):
    """StreamingEngine(devices=[card, card]) against one engine (the same
    weights and point draws) on one batch of 8 full 480x640 frames,
    within chip_smoke.py:replica_errors' limits; a request launches K2
    twice and K1 four times (each replica once and twice)."""
    from chip_smoke import replica_errors
    from keypointfusion_torch.data.synthetic import synthetic_frames
    from keypointfusion_torch.serving import StreamingEngine
    frames = synthetic_frames(8, rng=np.random.RandomState(11))
    args = [frames[k] for k in ('depth', 'rgb', 'centers', 'cube', 'cam')]

    def engine(dt, replicas):
        return StreamingEngine(Config(), batch_size=8, img_hw=(480, 640),
                               dtype=dt, seed=0, device=cuda_device,
                               devices=[cuda_device] * replicas)

    def answer(eng):
        return eng._unpack(eng.submit(*args).cpu().numpy())

    dt = getattr(torch, dtype)
    ref32 = answer(engine(torch.float32, 1))
    one = ref32 if dt == torch.float32 else answer(engine(dt, 1))
    replicas = engine(dt, 2)
    errors = replica_errors(answer(replicas), one, ref32, dt)
    assert all(e <= limit for e, limit in errors.values()), errors
    sampler, desa = ((k2.KERNEL, k1.KERNEL) if dt == torch.float32 else
                     (k2.SERVING_KERNEL, k1.SERVING_KERNEL))
    torch.cuda.synchronize()
    sampler.launches = desa.launches = 0
    replicas.submit(*args)
    torch.cuda.synchronize()
    assert (sampler.launches, desa.launches) == (2, 4)


@pytest.mark.cuda
def test_global_batch_norm_nccl_world_of_one_on_card(cuda_device, tmp_path):
    """models/norm.py:global_batch_norm with its all-reduces on NCCL (a
    process group of one rank) against torch's train-mode BatchNorm:
    outputs, input gradients and running statistics within
    chip_smoke.py's PARALLEL_BN_TOL of scale."""
    import torch.distributed as dist
    from chip_smoke import PARALLEL_BN_TOL, global_batch_norm_errors
    from keypointfusion_torch.parallel.mesh import init_process_group
    group = init_process_group('nccl', 0, 1, store=dist.FileStore(
        str(tmp_path / 'store'), 1))
    try:
        errors = global_batch_norm_errors(cuda_device, group)
    finally:
        dist.destroy_process_group()
    assert all(e <= PARALLEL_BN_TOL for e in errors.values()), errors


@pytest.mark.cuda
def test_native_core_matches_jax_samples_on_card_machine(cuda_device):
    """The fixture's test split through data/native.py (built with g++ on
    the card's machine) against the JAX package's default-route samples
    in tests/fixtures/torch_port_dexycb/native_samples.npz, every value
    equal."""
    from chip_smoke import native_fixture_differences
    values, differ = native_fixture_differences()
    assert values > 0 and differ == 0, (values, differ)


@pytest.mark.cuda
def test_vis_debug_fixture_on_card_machine(cuda_device):
    """utils/vis.py's debug renderers on the [vis_debug] fixture's inputs
    (tests/fixtures/torch_port_vis/vis_debug.npz), their arrays, PNGs read
    back and .obj bytes against the JAX package's digests stored there."""
    from chip_smoke import vis_fixture_differences
    n_outputs, differ = vis_fixture_differences()
    assert n_outputs > 200 and not differ, differ
