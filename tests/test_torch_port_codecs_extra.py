"""Port parity of ops/codecs_extra.py: every encoder and decoder, every
branch of the feature-type dispatch, compute_losses and the trainer's
per-stage decode for each decodable feature type, each against the JAX
function on the same numpy inputs (float32).

Tolerances: top-k indices equal; values 1e-5 absolute (maps and joints of
order 1: softmaxes and sums of up to 1024 terms in another order, and the
float32 divisions of the nosoftmax decode's raw weights); the losses and
metrics of compute_losses 1e-5 relative to the value (at least 1), as in
tests/test_torch_port_losses.py. joint_to_pc draws from a torch.Generator
where JAX draws from a key, so it is held to its properties.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.ops import codecs_extra as jx
from keypointfusion_tpu.training.losses import compute_losses as j_losses
from keypointfusion_tpu.training.train_step import frame_from_batch as j_frame
from keypointfusion_tpu.training.trainer import Trainer as JTrainer

from keypointfusion_torch.config import Config
from keypointfusion_torch.ops import codecs_extra as tx
from keypointfusion_torch.training.losses import compute_losses
from keypointfusion_torch.training.train_step import (
    batch_to_device, frame_from_batch,
)
from keypointfusion_torch.training.trainer import Trainer

torch.set_num_threads(2)
TOL = 1e-5
LOSS_RTOL = 1e-5
B, J, FS = 2, 21, 32
KERNEL = 0.8
DECODABLE = ('weight_offset', 'weight_offset_nosoftmax', 'offset', 'heatmap')
ENCODE_ONLY = ('heatmap_depth', 'heatmap_depthoffset', 'plainoffset_depth',
               'plainoffset_depthoffset', 'weight_pos')
t = torch.from_numpy


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


@pytest.fixture(scope='module')
def batch():
    return synthetic_batch(batch_size=B, point_num=256, seed=42)


@pytest.fixture(scope='module')
def maps():
    """Dense 5J predictions at the backbone's scale, and a weight channel
    kept positive where the nosoftmax decode divides by its sum."""
    rng = np.random.RandomState(5)
    m = rng.randn(B, FS, FS, 5 * J).astype(np.float32) * 0.5
    pos = m.copy()
    pos[..., 4 * J:] = np.abs(pos[..., 4 * J:]) + 0.1
    return m, pos


def test_offset_to_joint_topk_matches_jax(batch, maps):
    """Top-30 heatmap voting, on random maps and on maps with tied
    heatmap values (rounded to 1/8), where lax.top_k takes the lower
    pixel first."""
    m = maps[0][..., :4 * J]
    tied = m.copy()
    tied[..., 3 * J:] = np.round(tied[..., 3 * J:] * 8) / 8
    for x in (m, tied):
        close(tx.offset_to_joint_topk(t(x), t(batch['depth']), KERNEL),
              jx.offset_to_joint_topk(x, batch['depth'], KERNEL))
    hm = np.transpose(tied[..., 3 * J:].reshape(B, FS * FS, J), (0, 2, 1))
    _, want = jax.lax.top_k(hm, 30)
    from keypointfusion_torch.geometry.pcl import topk_largest
    _, got = topk_largest(t(hm), 30)
    assert (np.diff(np.sort(hm, -1), axis=-1) == 0).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_weight_nosoftmax_and_heatmap_decodes_match_jax(batch, maps):
    _, pos = maps
    close(tx.offset_to_joint_weight_nosoftmax(t(pos), t(batch['depth']),
                                              KERNEL),
          jx.offset_to_joint_weight_nosoftmax(pos, batch['depth'], KERNEL))
    hm = pos[..., :J] * 3
    close(tx.heatmap_to_joint_softmax(t(hm)), jx.heatmap_to_joint_softmax(hm))


def test_plain_offset_and_depth_codecs_match_jax(batch):
    """The 2D encoders and decoders and the depth maps, with a scalar and
    a per-joint kernel."""
    joint, depth = batch['uvd_gt'], batch['depth']
    for kernel in (KERNEL, np.linspace(0.4, 1.0, J).astype(np.float32)):
        got, gmask = tx.joint_to_plain_offset(t(joint), t(depth), kernel,
                                              FS)
        want, wmask = jx.joint_to_plain_offset(joint, depth, kernel, FS)
        close(got, want)
        close(gmask, wmask, 0)
        assert float(gmask.mean()) > 0.01
        close(tx.joint_to_depth_offset(t(joint), t(depth), gmask, FS),
              jx.joint_to_depth_offset(joint, depth, wmask, FS))
        rng = np.random.RandomState(6)
        off = rng.randn(B, FS, FS, 2 * J).astype(np.float32) * 0.5
        wgt = rng.randn(B, FS, FS, J).astype(np.float32) * 0.5
        close(tx.plain_offset_to_joint_softmax(t(off), t(wgt), kernel),
              jx.plain_offset_to_joint_softmax(off, wgt, kernel))
    hm, mask = tx.joint_to_gaussian_heatmap(t(joint), t(depth), KERNEL, FS)
    jhm, jmask = jx.joint_to_gaussian_heatmap(joint, depth, KERNEL, FS)
    close(hm, jhm)
    close(mask, jmask, 0)
    d = joint[..., 2]
    close(tx.depth_to_map(t(d), FS), jx.depth_to_map(d, FS), 0)


@pytest.mark.parametrize('ftype', DECODABLE + ENCODE_ONLY)
def test_joint_to_feature_matches_jax(batch, ftype):
    """Every branch of the GT encoding dispatch, and two types at once."""
    joint, depth = batch['uvd_gt'], batch['depth']
    types_, paras = (ftype, 'heatmap'), (KERNEL, 0.6)
    got = tx.joint_to_feature(t(joint), t(depth), paras, FS, types_)
    want = jx.joint_to_feature(joint, depth, paras, FS, types_)
    assert got.shape == want.shape
    close(got, want)


def test_dispatch_raises_where_jax_does(batch, maps):
    depth = t(batch['depth'])
    with pytest.raises(NotImplementedError):
        tx.joint_to_feature(t(batch['uvd_gt']), depth, [KERNEL], FS,
                            ['no_such_type'])
    for ftype in ENCODE_ONLY:
        with pytest.raises(NotImplementedError):
            jx.feature_to_joint(batch['depth'], maps[1], [ftype], [KERNEL],
                                joint_num=J)
        with pytest.raises(NotImplementedError):
            tx.feature_to_joint(depth, t(maps[1]), [ftype], [KERNEL],
                                joint_num=J)


def _results(batch, pos):
    rng = np.random.RandomState(3)
    res = [pos, (pos * 0.8).astype(np.float32)]
    res += [(batch['xyz_gt'] + rng.randn(B, J, 3) * 0.05).astype(np.float32)
            for _ in range(4)]
    sw = [rng.uniform(0, 1, (B, FS, FS, J)).astype(np.float32)
          for _ in range(2)]
    return res, sw


@pytest.mark.parametrize('ftype', DECODABLE)
def test_feature_to_joint_and_decode_stage_match_jax(batch, maps, ftype):
    """feature_to_joint on the full 5J map with joint_num (the channel
    slices of 'offset' and 'heatmap'), and the trainer's _decode_stage for
    every stage kind of the default stage_type."""
    depth = batch['depth']
    close(tx.feature_to_joint(t(depth), t(maps[1]), [ftype], [KERNEL],
                              joint_num=J),
          jx.feature_to_joint(depth, maps[1], [ftype], [KERNEL],
                              joint_num=J))
    res, _ = _results(batch, maps[1])
    jcfg = JConfig(feature_type=(ftype,))
    cfg = Config(feature_type=(ftype,))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    b = batch_to_device(batch, 'cpu')
    jframe, frame = j_frame(jb, jcfg), frame_from_batch(b, cfg)
    jself, tself = types.SimpleNamespace(cfg=jcfg), \
        types.SimpleNamespace(cfg=cfg)
    for index, stage in enumerate((0, 1, 2)):
        r = res[index] if stage != 0 else batch['uvd_gt']
        want = JTrainer._decode_stage(jself, [r], jb, jframe, 0, stage)
        got = Trainer._decode_stage(tself, [t(r)], b, frame, 0, stage)
        close(got, want)


@pytest.mark.parametrize('ftype', DECODABLE)
def test_compute_losses_matches_jax(batch, maps, ftype):
    """The total and every metric of compute_losses with the feature type's
    GT encoding and decode."""
    res, sw = _results(batch, maps[1])
    jcfg = JConfig(feature_type=(ftype,))
    cfg = Config(feature_type=(ftype,))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_total, want = j_losses(res, sw, jb['depth'], jb['uvd_gt'],
                                jb['xyz_gt'], j_frame(jb, jcfg), jcfg, 0)
    b = batch_to_device(batch, 'cpu')
    total, got = compute_losses([t(r) for r in res], [t(s) for s in sw],
                                b['depth'], b['uvd_gt'], b['xyz_gt'],
                                frame_from_batch(b, cfg), cfg, 0)
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= LOSS_RTOL * max(1.0, abs(w)), k


def test_joint_to_pc_properties(batch):
    """Shape, joint types 1..J, every point within `radius` of its joint,
    one selection without replacement shared by the batch, the same draws
    from the same generator state."""
    joint = t(batch['uvd_gt'])
    draw = lambda seed: tx.joint_to_pc(
        joint, torch.Generator().manual_seed(seed), sample_point=1000,
        radius=0.08, cloud_per_joint=100)
    pc = draw(0)
    assert pc.shape == (B, 1000, 4)
    types_ = pc[..., 3]
    assert types_.min() >= 1 and types_.max() <= J
    assert torch.equal(types_, types_.round())
    owner = joint[torch.arange(B)[:, None], types_.long() - 1]
    assert float(torch.linalg.norm(pc[..., :3] - owner, dim=-1).max()) \
        < 0.08
    assert torch.equal(types_[0], types_[1])            # one selection
    # the selection holds no point twice: with the joints moved apart, the
    # points' offsets from their joints are all distinct
    offsets = (pc[..., :3] - owner)[0]
    assert len({tuple(v) for v in offsets.tolist()}) == 1000
    assert torch.equal(pc, draw(0))
    assert not torch.equal(pc, draw(1))
