"""Port parity of the bfloat16 serving slice: K2's and K1's 'default'
(serving) modes, each bfloat16 module against its flax counterpart on the
same bfloat16 inputs, the whole bfloat16 KPFusion against an error budget,
and the bfloat16 engine's output contract.

The JAX kernels run in interpret mode (tests/test_kernels_serving_mode.py
runs them so); weights are carried across by keypointfusion_torch/utils/
weights.py; inputs come from numpy seeds, rounded to bfloat16 where the
module takes bfloat16. Tolerances, each measured on these inputs:
  * K2 'default': the selected pixel sets equal exactly (read from the JAX
    kernel itself by sampling an identity feature map) and values within
    one bfloat16 ulp (measured: equal bit for bit, the d2 rounding being
    XLA's, fma(dz, dz, fma(dx, dx, dy*dy))).
  * K1 'default': 2^-8 of the output's scale (measured 3.07e-3 on a scale
    of 23.3, 0.034 of the bound): float32 sums in another order, then
    bfloat16 roundings of h1 and of the fusion input that can fall either
    way.
  * modules: a bfloat16 result that a float32 sum order rounds one way in
    XLA and the other in PyTorch differs by one bfloat16 ulp (2^-8 of the
    value), and each such flip feeds every later layer. BatchNorm comes
    out bit for bit equal; KPInteraction within 2^-7 of its scale
    (measured 4.4e-3) and the cross decoder within 2^-6 (measured 8.5e-3:
    torch's layer_norm takes the variance in two passes where flax takes
    E[x^2] - mean^2, which differ at float32 rounding and flip bfloat16
    roundings); the fusion block within 2^-5 of each output's scale; the ResNet-UNet, 22 convolution layers deep, within
    2^-5 of img_result's scale and 2^-4 of img_feature's (measured 0.024
    and 0.048; its encoder alone 0.023 at c4; JAX's own bfloat16 run is
    0.035 of the scale from its float32 run there). Beside each bound the
    module also keeps the budget of the whole model below.
  * the budget, for the whole model, whose soft selections bfloat16
    rounding flips (tests/test_serving.py says so of JAX itself): for each
    output, max|port_bf16 - jax_f32| <= 2 max|jax_bf16 - jax_f32| + 2^-8
    of its scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.kernels.desa_dense_pallas import desa_dense_fused
from keypointfusion_tpu.kernels.pixel_sampler_pallas import \
    sample_pixel_features_fused as j_sampler
from keypointfusion_tpu.models.desa import DESA as JDESA
from keypointfusion_tpu.models.fusion_block import FusionBlock as JBlock
from keypointfusion_tpu.models.kpfusion import KPFusion as JKPFusion
from keypointfusion_tpu.models.norm import TorchBatchNorm as JBN
from keypointfusion_tpu.models.transformer import (
    CrossDecoder as JCross, KPInteraction as JKPI,
)
from keypointfusion_tpu.models.unet import ResNetUNet as JUNet
from keypointfusion_tpu.training.train_step import frame_from_batch
from keypointfusion_tpu.utils.torch_convert import convert_resnet_unet

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.synthetic import synthetic_frames
from keypointfusion_torch.geometry.camera import CropFrame
from keypointfusion_torch.kernels import desa_dense as tk1
from keypointfusion_torch.kernels import pixel_sampler as tk2
from keypointfusion_torch.models.desa import DESA
from keypointfusion_torch.models.fusion_block import FusionBlock
from keypointfusion_torch.models.kpfusion import KPFusion
from keypointfusion_torch.models.layers import (
    Conv2d, Linear, set_compute_dtype,
)
from keypointfusion_torch.models.norm import TorchBatchNorm
from keypointfusion_torch.models.transformer import (
    CrossDecoder, KPInteraction,
)
from keypointfusion_torch.models.unet import ResNetUNet
from keypointfusion_torch.serving import StreamingEngine
from keypointfusion_torch.utils import weights as tweights

from tests.torch_port_helpers import (
    calibrate_batch_norms, cpu_reference_convs, init_jax_kpfusion,
    perturb_batch_stats, shared_kpfusion_weights,
)

torch.set_num_threads(2)
BF = torch.bfloat16
OUTPUTS = ('img_offset', 'img_offset_rgb', 'b1_3d', 'b1_2d', 'b2_3d',
           'b2_2d', 'spatial_weight_1', 'spatial_weight_2')


def bf16(x):
    """x rounded to bfloat16, as a float32 numpy array."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def scale(x):
    return max(1.0, float(np.abs(f32(x)).max()))


def err(a, b):
    return float(np.abs(f32(a) - f32(b)).max())


def within_budget(got, want_bf16, want_f32):
    """The bfloat16 error budget: the port's distance from JAX's float32
    result within twice JAX's own bfloat16 distance from it, plus 2^-8
    of the scale."""
    return err(got, want_f32) <= (2 * err(want_bf16, want_f32)
                                  + 2 ** -8 * scale(want_f32))


def bf16_ulp(x):
    """One bfloat16 ulp of |x| (8 significant bits)."""
    m = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _init(module, *args, seed=0):
    v = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    out = {'params': jax.tree_util.tree_map(np.asarray, v['params'])}
    if 'batch_stats' in v:
        out['batch_stats'] = perturb_batch_stats(v['batch_stats'], seed)
    return out


def _load_bf16(module, sd, prefix=''):
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return set_compute_dtype(module.eval(), BF)


# ---------------------------------------------------------- K2 'default' --

def _sampler_case(kind, c, seed=1):
    rng = np.random.RandomState(seed)
    if kind == 'random':
        # tests/test_kernels_serving_mode.py's inputs
        pcl = rng.uniform(-.9, .9, (2, 256, 3)).astype(np.float32)
        img_xyz = rng.uniform(-1, 1, (2, 1024, 3)).astype(np.float32)
    else:
        # flat background: pixel centres on one depth plane, points on the
        # same dyadic grid, so d2 is exact and whole rings of pixels tie
        r = (np.arange(32, dtype=np.float32) + 0.5) / 16.0 - 1.0
        u, v = np.meshgrid(r, r)
        grid = np.stack([u, v, np.full_like(u, 0.5)], -1).reshape(-1, 3)
        img_xyz = np.broadcast_to(grid, (2, 1024, 3)).copy()
        k = rng.randint(-32, 33, (2, 256, 2)).astype(np.float32) / 32.0
        pcl = np.concatenate([k, np.full((2, 256, 1), 0.5, np.float32)], -1)
    feat = rng.randn(2, 1024, c).astype(np.float32)
    return pcl, img_xyz, feat


@pytest.mark.parametrize('kind,c', [('random', 64), ('random', 128),
                                    ('flat_background', 64)])
def test_pixel_sampler_serving_plain_matches_jax(kind, c):
    pcl, img_xyz, feat = _sampler_case(kind, c)
    t = torch.from_numpy
    got = tk2.sample_pixel_features_fused(t(pcl), t(img_xyz), t(feat),
                                          mode='default')
    assert got.dtype == BF and got.shape == (2, 256, c)
    want = f32(j_sampler(pcl, img_xyz, feat, k=4, interpret=True,
                         feat_precision='default'))
    diff = np.abs(f32(got) - want)
    assert (diff <= bf16_ulp(want)).all(), diff.max()

    # the selected set: the JAX kernel sampling the identity map returns
    # w_m / sum(w) > 0 exactly at the pixels it selected
    eye = np.broadcast_to(np.eye(1024, dtype=np.float32), (2, 1024, 1024))
    j_sel = f32(j_sampler(pcl, img_xyz, eye.copy(), k=4, interpret=True,
                          feat_precision='default')) > 0
    d2 = tk2.serving_sqdist(t(pcl), t(img_xyz))
    t_sel = (d2 <= tk2.serving_threshold(d2)).numpy()
    np.testing.assert_array_equal(t_sel, j_sel)
    counts = t_sel.sum(-1)
    if kind == 'flat_background':
        # whole tied rings are admitted: far more than 4 pixels
        assert counts.max() > 4 and (counts > 4).sum() > 100
    else:
        assert (counts == 4).all()


# ---------------------------------------------------------- K1 'default' --

def test_desa_serving_plain_matches_jax():
    """tests/test_kernels.py:58-68's shapes, with the joint far from the
    cloud whose balls hold only itself."""
    rng = np.random.RandomState(0)
    b, n, j, c = 2, 150, 21, 128
    pf = bf16(rng.randn(b, n, c).astype(np.float32))
    nf = bf16(rng.randn(b, j, c).astype(np.float32))
    pxyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    nxyz = rng.uniform(-0.5, 0.5, (b, j, 3)).astype(np.float32)
    nxyz[0, 0] = 5.0
    jd = JDESA(128)
    v = jax.jit(jd.init)(jax.random.PRNGKey(0), pf, nf, pxyz, nxyz)
    v = {'params': jax.tree_util.tree_map(np.asarray, v['params']),
         'batch_stats': perturb_batch_stats(v['batch_stats'], 0)}
    want = f32(desa_dense_fused(v['params'], v['batch_stats'], pf, nf, pxyz,
                                nxyz, interpret=True,
                                mlp_precision='default'))
    module = DESA(128)
    module.load_state_dict(tweights.jax_desa_to_state_dict(
        v['params'], v['batch_stats']))
    t = torch.from_numpy
    with torch.no_grad():
        got = tk1.desa_dense(t(pf).to(BF), t(nf).to(BF), t(pxyz), t(nxyz),
                             module.eval().folded_weights(), mode='default')
    assert got.dtype == torch.float32
    assert err(got, want) <= 2 ** -8 * scale(want)


# -------------------------------------------------------------- modules --

def test_decode_promotes_bf16_map_like_jax():
    """offset_to_joint_weight on a bfloat16 map and float32 depth: JAX
    promotes the weights to float32 against the float32 coordinates,
    where torch.einsum would refuse the two dtypes. Within 2^-8 (measured
    1.8e-3 on values up to 0.57: the bfloat16 softmax rounds once in
    torch, step by step in JAX)."""
    from keypointfusion_tpu.ops.codecs import offset_to_joint_weight as jd
    from keypointfusion_torch.ops.codecs import offset_to_joint_weight as td
    depth = synthetic_batch(batch_size=2, point_num=256, seed=42)['depth']
    m = bf16(np.random.RandomState(0).randn(2, 32, 32, 105)
             .astype(np.float32))
    want = jd(jnp.asarray(m).astype(jnp.bfloat16), jnp.asarray(depth), 0.8)
    got = td(torch.from_numpy(m).to(BF), torch.from_numpy(depth), 0.8)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert err(got, want) <= 2 ** -8


def test_batch_norm_bf16_matches_flax():
    x = bf16(np.random.RandomState(0).randn(4, 7, 128).astype(np.float32)
             * 3)
    jm = JBN(use_running_average=True, dtype=jnp.bfloat16)
    v = _init(jm, x)
    want = jm.apply(v, jnp.asarray(x).astype(jnp.bfloat16))
    bn = TorchBatchNorm(128)
    t = lambda a: torch.from_numpy(np.array(a))
    bn.load_state_dict({'weight': t(v['params']['scale']),
                        'bias': t(v['params']['bias']),
                        'running_mean': t(v['batch_stats']['mean']),
                        'running_var': t(v['batch_stats']['var']),
                        'num_batches_tracked': torch.tensor(0)})
    got = set_compute_dtype(bn.eval(), BF)(t(x).to(BF))
    assert got.dtype == BF
    assert err(got, want) <= 2 ** -6 * scale(want)


def test_resnet_unet_bf16_matches_flax():
    x = bf16(np.random.RandomState(1).uniform(
        -1, 1, (2, 128, 128, 1)).astype(np.float32))
    jm = JUNet(depth=18, joint_num=21, out_dims=(63, 21, 21))
    v = _init(jm, x)
    sd = {}
    tweights._resnet_unet(sd, '', v['params'], v['batch_stats'], 18)
    port = ResNetUNet(1)
    port.load_state_dict(sd)
    with cpu_reference_convs():
        calibrate_batch_norms(port, torch.from_numpy(x))
    params, stats = convert_resnet_unet(port.state_dict(), 18)
    variables = {'params': params, 'batch_stats': stats}
    want_bf = jax.jit(JUNet(depth=18, joint_num=21, out_dims=(63, 21, 21),
                            dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(x).astype(jnp.bfloat16))
    want_f32 = jax.jit(jm.apply)(variables, x)
    set_compute_dtype(port.eval(), BF)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(BF))
    for g, w, w32, tol in zip(got, want_bf, want_f32, (2 ** -5, 2 ** -4)):
        assert g.dtype == BF and g.shape == w.shape
        assert err(g, w) <= tol * scale(w)
        assert within_budget(g, w, w32)


def test_transformers_bf16_match_flax():
    rng = np.random.RandomState(1)
    x = bf16(rng.randn(2, 21, 131).astype(np.float32))
    jm = JKPI(img_dim=131, dtype=jnp.bfloat16)
    v = _init(jm, x)
    want = jm.apply(v, jnp.asarray(x).astype(jnp.bfloat16))
    want_f32 = JKPI(img_dim=131).apply(v, x)
    sd = {}
    tweights._kp_interaction(sd, 'm', v['params'])
    port = _load_bf16(KPInteraction(img_dim=131), sd, 'm.')
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(BF))
    for g, w, w32 in zip(got, want, want_f32):
        assert g.dtype == BF
        assert err(g, w) <= 2 ** -7 * scale(w)
        assert within_budget(g, w, w32)

    anchor = rng.randn(2, 21, 128).astype(np.float32)   # float32, as in
    img = bf16(rng.randn(2, 21, 128).astype(np.float32))  # the block
    jm = JCross(hidden=128, joint_num=21, dtype=jnp.bfloat16)
    v = _init(jm, anchor, img)
    v['params'] = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32),
        v['params'])
    want = jm.apply(v, jnp.asarray(anchor),
                    jnp.asarray(img).astype(jnp.bfloat16))
    sd = {}
    tweights._cross_decoder(sd, 'm', v['params'])
    port = _load_bf16(CrossDecoder(hidden=128, joint_num=21), sd, 'm.')
    with torch.no_grad():
        got = port(torch.from_numpy(anchor), torch.from_numpy(img).to(BF))
    assert got.dtype == BF
    assert err(got, want) <= 2 ** -6 * scale(want)


def test_fusion_block_bf16_matches_flax():
    """The second block's inputs (float32 previous-stage feature, bfloat16
    sampled maps), DESA through K1's 'default' mode on both sides."""
    batch = synthetic_batch(batch_size=2, point_num=256, seed=42)
    rng = np.random.RandomState(2)
    img_feat = bf16(rng.randn(2, 32, 32, 128).astype(np.float32))
    img_feat_rgb = bf16(rng.randn(2, 32, 32, 128).astype(np.float32))
    weight_map = bf16(rng.randn(2, 32, 32, 21).astype(np.float32))
    sampled = np.concatenate(
        [bf16(rng.randn(2, 256, 256).astype(np.float32)),
         weight_map.reshape(2, 1024, 21)[:, :256]], -1)
    updated = rng.randn(2, 21, 128).astype(np.float32)
    img_down = batch['depth'][:, ::4, ::4]
    jframe = frame_from_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              JConfig())
    tframe = CropFrame.from_batch(batch['cam_para'], batch['center'],
                                  batch['M'], batch['cube'])
    bfj = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    args = (bfj(img_feat), bfj(img_feat_rgb), batch['pcl'], batch['xyz_gt'],
            bfj(sampled), bfj(weight_map))
    jm = JBlock(joint_num=21, dim=128, dtype=jnp.bfloat16,
                use_pallas_desa=True, pallas_interpret=True)
    v = _init(jm, *args, None, jframe, img_down)
    want = jm.apply(v, *args, updated, jframe, img_down, 0.8, False)
    want_f32 = JBlock(joint_num=21, dim=128, use_pallas_desa=True,
                      pallas_interpret=True).apply(
        v, img_feat, img_feat_rgb, batch['pcl'], batch['xyz_gt'], sampled,
        weight_map, updated, jframe, img_down, 0.8, False)
    sd = {}
    tweights._fusion_block(sd, 'b', v['params'], v['batch_stats'])
    port = _load_bf16(FusionBlock(21, 128), sd, 'b.')
    t = torch.from_numpy
    with torch.no_grad():
        got = port(t(img_feat).to(BF), t(img_feat_rgb).to(BF),
                   t(batch['pcl']), t(batch['xyz_gt']), t(sampled).to(BF),
                   t(updated), tframe, t(img_down), 0.8)
    for g, w, w32 in zip(got, want, want_f32):
        assert g.dtype == (BF if w.dtype == jnp.bfloat16
                           else torch.float32)
        assert err(g, w) <= 2 ** -5 * scale(w)
        assert within_budget(g, w, w32)


# ----------------------------------------------------------- whole model --

@pytest.fixture(scope='module')
def batch():
    return synthetic_batch(batch_size=2, point_num=256, seed=42)


@pytest.fixture(scope='module')
def shared_weights(batch):
    """(port state_dict, JAX variables) holding the same weights."""
    return shared_kpfusion_weights(init_jax_kpfusion(batch)[1], batch)


def _jax_forward(variables, batch, **kwargs):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    res, sw = JKPFusion(joint_num=21, **kwargs).apply(
        variables, jb['rgb'], jb['depth'], jb['pcl'],
        frame_from_batch(jb, JConfig()))
    return [f32(x) for x in res + sw]


def test_kpfusion_bf16_within_budget(batch, shared_weights):
    """The bfloat16 port against JAX's float32 forward, within twice JAX's
    own bfloat16 gap plus 2^-8 of the scale. Measured here (JAX bf16 with
    its kernels in interpret mode): JAX's gap / the port's gap are
    img_offset 0.0163 / 0.0172, b1_3d 0.0598 / 0.0559, b2_3d 0.0270 /
    0.0213, b2_2d 0.0112 / 0.0074 and the spatial weights (sigmoids of
    logits of ~40) 0.74 / 0.73; the port is within 0.058 of JAX's own
    bfloat16 run on the six results. JAX's gap is of the order measured
    when this slice was planned without the kernels (img_offset 0.0178,
    b1_3d 0.024, b2_3d 0.158): within a factor of 10."""
    sd, variables = shared_weights
    want_f32 = _jax_forward(variables, batch)
    want_bf = _jax_forward(variables, batch, dtype=jnp.bfloat16,
                           use_pallas_desa=True, use_pallas_sampler=True,
                           pallas_interpret=True)
    port = KPFusion(dtype=BF)
    port.load_state_dict(sd, strict=True)
    frame = CropFrame.from_batch(batch['cam_para'], batch['center'],
                                 batch['M'], batch['cube'])
    t = lambda k: torch.from_numpy(batch[k])
    with torch.no_grad():
        res, sw = port.eval()(t('rgb'), t('depth'), t('pcl'), frame)
    got = res + sw
    assert [g.dtype for g in got] == [BF] * 8
    for name, g, w32, wbf in zip(OUTPUTS, got, want_f32, want_bf):
        assert g.shape == w32.shape, name
        jax_gap = err(wbf, w32)
        assert err(g, w32) <= 2 * jax_gap + 2 ** -8 * scale(w32), name
    for name, gap in (('img_offset', 0.0178), ('b1_3d', 0.024),
                      ('b2_3d', 0.158)):
        i = OUTPUTS.index(name)
        assert gap / 10 <= err(want_bf[i], want_f32[i]) <= gap * 10, name


@pytest.mark.parametrize('make', [lambda: Linear(8, 4),
                                  lambda: Conv2d(8, 4, 3, padding=1)],
                         ids=['linear', 'conv'])
def test_cached_casts_follow_the_weights(make):
    """Without gradients a bfloat16 layer casts its float32 weight once and
    reuses the cast; its state_dict stays float32; load_state_dict makes
    the cast again; with gradients on it casts at the op, as before."""
    torch.manual_seed(0)
    layer = set_compute_dtype(make(), BF)
    x = torch.randn((3, 8) if isinstance(layer, Linear) else (1, 8, 5, 5))
    with torch.no_grad():
        layer(x)
        cached = layer._casts['weight'][1]
        layer(x)
        assert layer._casts['weight'][1] is cached
        assert {v.dtype for v in layer.state_dict().values()} \
            == {torch.float32}
        sd = {k: v * 2 for k, v in layer.state_dict().items()}
        layer.load_state_dict(sd)
        got = layer(x)
    fresh = set_compute_dtype(make(), BF)
    fresh.load_state_dict(sd)
    want = fresh(x)                          # gradients on: cast at the op
    assert want.requires_grad and not hasattr(fresh, '_casts')
    assert torch.equal(got, want.detach())


def test_kpfusion_backbone_dtype():
    """KPFusion(dtype, backbone_dtype), as the JAX module takes them: the
    backbones compute in backbone_dtype, the fusion blocks in dtype."""
    model = KPFusion(dtype=torch.float32, backbone_dtype=BF)

    def dtypes(module):
        return {m.compute_dtype for m in module.modules()
                if hasattr(m, 'compute_dtype')}
    assert dtypes(model.backbone_d) == dtypes(model.backbone_rgb) == {BF}
    assert dtypes(model.block1) == dtypes(model.block2) == {torch.float32}
    assert KPFusion(dtype=BF).backbone_dtype == BF


# ---------------------------------------------------------------- engine --

def test_streaming_engine_bf16_contract():
    """bfloat16 is the engine's default. With the point draws injected,
    its packed output is float32, its crop matrices are the float32
    engine's bit for bit (preprocessing stays float32), its joints are
    finite and stay near the float32 engine's; process_stream answers in
    order."""
    cfg = Config(point_num=128)
    eng = StreamingEngine(cfg, batch_size=2, img_hw=(120, 160),
                          device='cpu')
    assert eng.model.dtype == BF
    eng32 = StreamingEngine(cfg, state_dict=eng.model.state_dict(),
                            batch_size=2, img_hw=(120, 160),
                            dtype=torch.float32, device='cpu')
    frames = synthetic_frames(2, 120, 160, np.random.RandomState(0))
    staged = [torch.from_numpy(frames['depth'].astype(np.int32))] + [
        torch.from_numpy(frames[k]) for k in ('rgb', 'centers', 'cube',
                                              'cam')]
    uniform = torch.from_numpy(
        np.random.RandomState(1).uniform(size=(2, 128)).astype(np.float32))
    got = eng.pipeline(*staged, uniform=uniform)
    want = eng32.pipeline(*staged, uniform=uniform)
    assert got.dtype == torch.float32 and got.shape == (2, 2 * 3 * 21 + 9)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 126:].numpy(), want[:, 126:].numpy())
    # the cube is 250 mm: a joint within a tenth of it of float32's
    assert float((got[:, :63] - want[:, :63]).abs().max()) < 25.0

    outs = list(eng.process_stream(iter([frames, frames]), depth=2))
    assert len(outs) == 2
    for o in outs:
        assert o['joint_xyz_mm'].shape == (2, 21, 3)
        assert o['joint_uvd'].dtype == np.float32
        assert np.isfinite(o['joint_xyz_mm']).all()
