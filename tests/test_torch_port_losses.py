"""Port parity of the training codecs, the losses and the optimizers:
ops/codecs.py's joint_to_offset, offset_to_joint_softmax and
pcl_offset_to_joint_weight, ops/codecs_extra.py's 'weight_offset'
dispatch, ops/loss.py:smooth_l1_loss, training/losses.py:compute_losses,
and training/train_step.py's optimizers and learning-rate schedule, each
against the JAX function on the same numpy inputs.

Tolerances (float32): the codecs 1e-6 (elementwise arithmetic, softmaxes
and sums of up to 1024 terms in another order; values of order 1);
smooth_l1_loss, the total loss and every metric 1e-5 relative to the
value (at least 1; the metrics in mm relative to theirs); the optimizers
1e-6 on parameters of order 1 after 4 updates (torch divides by
sqrt(v)/sqrt(1 - b2^t) where optax takes sqrt(v / (1 - b2^t))).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.ops import codecs as jcodecs
from keypointfusion_tpu.ops import codecs_extra as jextra
from keypointfusion_tpu.ops.loss import smooth_l1_loss as j_smooth_l1
from keypointfusion_tpu.training.losses import compute_losses as j_losses
from keypointfusion_tpu.training.train_step import (
    frame_from_batch as j_frame, make_optimizer as j_make_optimizer,
)

from keypointfusion_torch.config import Config
from keypointfusion_torch.ops import codecs, codecs_extra
from keypointfusion_torch.ops.loss import smooth_l1_loss
from keypointfusion_torch.training.losses import compute_losses
from keypointfusion_torch.training.train_step import (
    TrainState, apply_gradients, batch_to_device, frame_from_batch,
    make_optimizer,
)

torch.set_num_threads(2)
CODEC_TOL = 1e-6
LOSS_RTOL = 1e-5
t = torch.from_numpy


@pytest.fixture(scope='module')
def batch():
    return synthetic_batch(batch_size=2, point_num=256, seed=42)


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize('kernel', [0.8, 'per_joint'])
def test_joint_to_offset_matches_jax(batch, kernel):
    """GT encoding [B,32,32,4J] of the batch's joints over its depth,
    with a scalar and a per-joint kernel (NYU's)."""
    if kernel == 'per_joint':
        kernel = np.linspace(0.4, 1.0, 21).astype(np.float32)
    want = jcodecs.joint_to_offset(batch['uvd_gt'], batch['depth'], kernel,
                                   32)
    got = codecs.joint_to_offset(t(batch['uvd_gt']), t(batch['depth']),
                                 kernel, 32)
    assert got.shape == (2, 32, 32, 84)
    assert float((got[..., 63:] > 0).float().mean()) > 0.01
    close(got, want, CODEC_TOL)


def test_decoders_match_jax(batch):
    """offset_to_joint_softmax on a 4J map and pcl_offset_to_joint_weight
    on per-point 5J predictions (a tenth of the points on the background)."""
    rng = np.random.RandomState(0)
    off4 = rng.randn(2, 32, 32, 84).astype(np.float32) * 0.5
    close(codecs.offset_to_joint_softmax(t(off4), t(batch['depth']), 0.8),
          jcodecs.offset_to_joint_softmax(off4, batch['depth'], 0.8),
          CODEC_TOL)
    pcl_result = rng.randn(2, 256, 105).astype(np.float32)
    pcl = batch['pcl'].copy()
    pcl[:, ::10, 2] = 1.0
    close(codecs.pcl_offset_to_joint_weight(t(pcl_result), t(pcl), 0.8),
          jcodecs.pcl_offset_to_joint_weight(pcl_result, pcl, 0.8),
          CODEC_TOL)


def test_feature_dispatch_matches_jax_and_rejects_the_rest(batch):
    """Every feature type JAX's dispatch decodes ('weight_offset',
    'offset', 'heatmap', 'weight_offset_nosoftmax') encodes and decodes the
    5J map as JAX's does; the types JAX only encodes raise on decode, as
    JAX's do, and an unknown type raises on encode (tests/
    test_torch_port_codecs_extra.py holds each codec)."""
    rng = np.random.RandomState(1)
    pixel_pd = rng.randn(2, 32, 32, 105).astype(np.float32)
    pixel_pd[..., 84:] = np.abs(pixel_pd[..., 84:]) + 0.1
    for ftype in ('weight_offset', 'offset', 'heatmap',
                  'weight_offset_nosoftmax'):
        close(codecs_extra.joint_to_feature(t(batch['uvd_gt']),
                                            t(batch['depth']), (0.8,), 32,
                                            (ftype,)),
              jextra.joint_to_feature(batch['uvd_gt'], batch['depth'],
                                      (0.8,), 32, (ftype,)), CODEC_TOL)
        close(codecs_extra.feature_to_joint(t(batch['depth']), t(pixel_pd),
                                            (ftype,), (0.8,), 21),
              jextra.feature_to_joint(batch['depth'], pixel_pd, (ftype,),
                                      (0.8,), 21),
              CODEC_TOL)
    for ftype in ('heatmap_depth', 'weight_pos'):
        with pytest.raises(NotImplementedError):
            jextra.feature_to_joint(batch['depth'], pixel_pd, (ftype,),
                                    (0.8,), 21)
        with pytest.raises(NotImplementedError):
            codecs_extra.feature_to_joint(t(batch['depth']), t(pixel_pd),
                                          (ftype,), (0.8,), 21)
    with pytest.raises(NotImplementedError):
        codecs_extra.joint_to_feature(t(batch['uvd_gt']), t(batch['depth']),
                                      (0.8,), 32, ('no_such_type',))


def test_smooth_l1_loss_matches_jax():
    """Differences on both sides of the 0.01 knee, mean and sum."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 21, 3).astype(np.float32) * 0.02
    y = rng.randn(4, 21, 3).astype(np.float32) * 0.02
    for size_average in (True, False):
        want = float(j_smooth_l1(x, y, size_average))
        got = float(smooth_l1_loss(t(x), t(y), size_average))
        assert abs(got - want) <= LOSS_RTOL * max(1.0, abs(want))


def loss_inputs(batch, seed=3):
    """KPFusion-shaped results and spatial weights: dense maps of the
    scale the backbones give at initialization, joints near the GT."""
    rng = np.random.RandomState(seed)
    res = [rng.randn(2, 32, 32, 105).astype(np.float32) * 0.1
           for _ in range(2)]
    res += [(batch['xyz_gt'] + rng.randn(2, 21, 3) * 0.05).astype(np.float32)
            for _ in range(4)]
    sw = [rng.uniform(0, 1, (2, 32, 32, 21)).astype(np.float32)
          for _ in range(2)]
    return res, sw


@pytest.mark.parametrize('stage_type,loss_type,epoch', [
    ((1, 1, 2, 3, 2, 3), 'L1Loss', 0),
    ((1, 1, 2, 3, 2, 3), 'L1Loss', 24),     # the gate's last open epoch
    ((1, 1, 2, 3, 2, 3), 'L1Loss', 25),     # closed
    ((0, 1, 2, 0, 3, 2), 'Mse', 3),         # stage 0: no loss
])
def test_compute_losses_matches_jax(batch, stage_type, loss_type, epoch):
    """The total and every metric of compute_losses, with both stage kinds,
    the spatial gate on each side, stage 0 and 'Mse'; epoch also as a
    0-dim tensor."""
    res, sw = loss_inputs(batch)
    jcfg = JConfig(stage_type=stage_type, loss_type=loss_type)
    cfg = Config(stage_type=stage_type, loss_type=loss_type)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_total, want = j_losses(res, sw, jb['depth'], jb['uvd_gt'],
                                jb['xyz_gt'], j_frame(jb, jcfg), jcfg,
                                epoch)
    b = batch_to_device(batch, 'cpu')
    for ep in (epoch, torch.tensor(epoch)):
        total, got = compute_losses([t(r) for r in res], [t(s) for s in sw],
                                    b['depth'], b['uvd_gt'], b['xyz_gt'],
                                    frame_from_batch(b, cfg), cfg, ep)
        assert set(got) == set(want)
        assert float(total) == float(got['loss'])
        for k, w in want.items():
            w = float(w)
            assert abs(float(got[k]) - w) <= LOSS_RTOL * max(1.0, abs(w)), k
    gate_open = epoch <= cfg.spatial_epoch[0]
    assert (float(want['loss_spatial_0']) > 0) == gate_open
    assert ('loss_coord_0' in want) == (stage_type[0] != 0)


class _StepConfig:
    """A decay every 2 epochs of 1 step each: the 'step' schedule's
    boundary falls between updates 2 and 3."""
    lr = 8e-4
    scheduler = 'step'
    step_gamma = 0.1
    step_size = 2

    def __init__(self, opt):
        self.opt = opt


@pytest.mark.parametrize('opt', ['adamw', 'adam', 'sgd'])
def test_optimizers_match_optax(opt):
    """4 updates of make_optimizer's optimizer across a 'step' decay, with
    lr_scale 0.5, against the JAX package's optax optimizer (flattened,
    as it runs) with its updates scaled as its step scales them, on a
    conv kernel, BN scale and bias, and a dense bias."""
    cfg = _StepConfig(opt)
    rng = np.random.RandomState(4)
    shapes = {'conv': (8, 4, 3, 3), 'bn_scale': (8,), 'bn_bias': (8,),
              'dense_bias': (16,)}
    start = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]

    params = {k: torch.nn.Parameter(t(v.copy())) for k, v in start.items()}
    optimizer, schedule = make_optimizer(cfg, params.values(),
                                         steps_per_epoch=1)
    state = TrainState(None, optimizer, schedule, lr_scale=0.5)
    tx = j_make_optimizer(cfg, steps_per_epoch=1)
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    opt_state = tx.init(jparams)
    for g in grads:
        for k, p in params.items():
            p.grad = t(g[k].copy())
        apply_gradients(state)
        state.step += 1
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in
                                        g.items()}, opt_state, jparams)
        updates = jax.tree_util.tree_map(lambda u: u * 0.5, updates)
        jparams = optax.apply_updates(jparams, updates)
    assert optimizer.param_groups[0]['lr'] == pytest.approx(0.5 * 8e-5)
    for k in shapes:
        moved = np.abs(np.asarray(jparams[k]) - start[k]).max()
        assert moved > 1e-4, k
        close(params[k], jparams[k], 1e-6)


def test_lr_schedules():
    """'step' decays by step_gamma every step_size epochs; 'constant'
    and 'auto' are flat (auto decays through lr_scale)."""
    from keypointfusion_torch.training.train_step import make_lr_schedule
    cfg = Config(lr=1e-3)
    sched = make_lr_schedule(cfg, steps_per_epoch=5)
    assert cfg.step_size == 10 and cfg.max_epoch == 15
    assert sched(0) == sched(49) == 1e-3
    assert sched(50) == pytest.approx(1e-4)
    assert sched(100) == pytest.approx(1e-5)
    for name in ('constant', 'auto'):
        flat = make_lr_schedule(Config(lr=1e-3, scheduler=name), 5)
        assert flat(0) == flat(1000) == 1e-3
    with pytest.raises(ValueError):
        make_optimizer(Config(opt='lamb'), [torch.nn.Parameter(
            torch.zeros(1))])
