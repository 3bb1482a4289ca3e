"""Port parity of KPFusion-resnet-18's train-mode forward and its
gradients: each module against its flax counterpart on the same inputs
and weights, the whole model against JAX's op-by-op train-mode `apply`,
'mixed' and full bfloat16 against an error budget, and the port's own
train-mode contract (dropout, stop-gradients).

Inputs: synthetic_batch(batch_size=2, point_num=256, seed=42). Weights:
the port's KPFusion from seed 0, its BatchNorm statistics perturbed,
carried to JAX by the JAX package's converter and back by
utils/weights.py:jax_kpfusion_to_state_dict (tests/torch_port_helpers.py:
train_weights). Dropout 0 on both sides (the frameworks draw different
masks). JAX runs op by op, never under one jit of the model (ROADMAP.md
§3: its jitted forward moves b1_3d by 4.05e-4 on this batch).

The port runs its convolutions without oneDNN and its train-mode
BatchNorm statistics in two passes (torch_port_helpers.py:
cpu_reference_convs, cpu_reference_batch_norms): torch's CPU batch_norm
sums a channel's 8192-32768 terms in one sequential pass, and train-mode
BatchNorm amplifies that rounding through the network (the depth
backbone's first layer already lies 1.6e-4 from float64 statistics with
it, 1.4e-6 without).

Tolerances:
  * modules on the same inputs (each ResNet-UNet, each fusion block): every
    output and every new running mean and variance within 1e-4 of its
    scale (max |value|, at least 1), and the parameter gradients of a
    fixed random scalar of the module's outputs within 1e-4 of each
    tensor's scale, each fusion block's in float32, each ResNet-UNet's in
    float64 on both sides (in float32 its BatchNorms amplify rounding past
    any such limit); the tensors whose gradient is 0 in exact arithmetic
    (a bias followed by a train-mode BatchNorm, an attention key's bias,
    which the softmax cancels) are held instead to 1e-4 of the module's
    largest gradient.
  * the whole model in float64 on both sides (the port's modules in
    float64, `port_pass(..., torch.float64)`; JAX under jax_enable_x64,
    tests/torch_port_helpers.py:jax_float64), where float32 rounding no
    longer hides an error: each output and new running statistic within
    1e-4 of its scale, the loss and each metric within 1e-5 of itself (at
    least 1), each of the 926 gradients within 1e-4 of its tensor's scale
    (the exact zeros: of the largest gradient), but for the two blocks'
    `weight_dis`, a scalar whose gradient sums 43,008 terms of both
    signs (one per gate, 2x32x32x21): 1e-3 (measured 1.15e-4 and
    7.4e-5). Neither side is pure float64: both pick neighbours and ball
    members from float32 squared distances, and the port samples its
    maps, takes DESA's offsets and the smooth-L1 loss in float32.
    Measured: outputs 1.19e-5 of scale, statistics 1.3e-6, metrics
    1.2e-7, the other gradients 4.6e-5.
  * the whole model in float32, whose train-mode BatchNorms amplify
    rounding: JAX's float32 run itself lies up to 3.3e-4 of scale from its
    float64 run on the outputs, and more than 1% of the tensor's scale on
    335 of the 926 gradients (33% on the depth backbone's layer4_1.conv1).
    So each output, each new running statistic, the loss and each metric
    is held to twice JAX's own float32-to-float64 distance plus 1e-4 of
    its scale, that distance to at most 1e-3 of the scale for the
    outputs; each gradient to three times that distance plus 1e-4 of its
    scale (two float32 runs each lie about that distance from float64),
    the exact zeros to 1e-4 of the largest gradient. The budget is JAX's
    alone: a fault of the port does not widen it. Measured: 0.45 of the
    budget on the outputs, 0.27 on the statistics, 0.08 on the metrics,
    0.50 on the gradients.
  * 'mixed' and full bfloat16: each output and the loss within twice
    JAX's own gap between that precision and float32 plus 2^-8 of the
    scale, the gap taken on the same batch and weights (bfloat16
    roundings flip soft selections in JAX itself, so no tighter
    comparison holds); in bfloat16 every gradient finite and non-zero
    wherever JAX's float32 gradient is.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.models.fusion_block import FusionBlock as JBlock
from keypointfusion_tpu.models.kpfusion import KPFusion as JKPFusion
from keypointfusion_tpu.models.unet import ResNetUNet as JUNet
from keypointfusion_tpu.training.losses import compute_losses as j_losses
from keypointfusion_tpu.training.train_step import \
    frame_from_batch as j_frame
from keypointfusion_tpu.utils.torch_convert import convert_resnet_unet

import keypointfusion_torch.models.kpfusion as kpf
from keypointfusion_torch.config import Config
from keypointfusion_torch.models.kpfusion import KPFusion
from keypointfusion_torch.models.layers import set_compute_dtype
from keypointfusion_torch.models.transformer import KPInteraction, dropout
from keypointfusion_torch.training.losses import compute_losses
from keypointfusion_torch.training.train_step import (
    batch_to_device, frame_from_batch,
)

from tests.torch_port_helpers import (
    cpu_reference_batch_norms, cpu_reference_convs, jax_float64,
    leaf_errors, port_to_jax_tree, train_weights,
)

torch.set_num_threads(2)
OUTPUTS = ('img_offset', 'img_offset_rgb', 'b1_3d', 'b1_2d', 'b2_3d',
           'b2_2d', 'spatial_weight_1', 'spatial_weight_2')


def exact_zero_gradient(path: str) -> bool:
    """A bias followed by a train-mode BatchNorm (the embeddings', DESA's,
    the UNet Residuals' first two convolutions'), an attention key's bias
    (the softmax cancels it) or the weight channels' bias (the softmax
    over the pixels cancels it): gradient 0 in exact arithmetic."""
    return path.endswith("['bias']") and (
        '_emb' in path and "['dense']" in path
        or 'backbone' in path and any(
            k in path for k in ("['conv1']", "['conv2']", "['final_2']"))
        or any(k in path for k in ("['FA']['conv_", "['FA']['fusion']",
                                   "['key']")))


def scale(x):
    return max(1.0, float(np.abs(np.asarray(x, np.float64)).max()))


def err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope='module')
def batch():
    return synthetic_batch(batch_size=2, point_num=256, seed=42)


@pytest.fixture(scope='module')
def weights():
    return train_weights(0)


def jax_pass(variables, batch, backbone_dtype=None, grads=True,
             dtype=jnp.float32):
    """JAX's train-mode forward, compute_losses (epoch 0) and, with
    `grads`, the total's gradient, op by op, the model in `dtype`. numpy
    out, float64."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    frame = j_frame(jb, JConfig())
    model = JKPFusion(joint_num=21, dropout=0.0, dtype=dtype,
                      backbone_dtype=backbone_dtype)

    def loss_fn(params):
        (res, sw), new = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jb['rgb'], jb['depth'], jb['pcl'], frame, 0.8, True,
            mutable=['batch_stats'])
        loss, metrics = j_losses(res, sw, jb['depth'], jb['uvd_gt'],
                                 jb['xyz_gt'], frame, JConfig(), 0)
        return loss, (res + sw, new['batch_stats'], metrics)

    if grads:
        (_, (out, stats, metrics)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(variables['params'])
    else:
        _, (out, stats, metrics), g = *loss_fn(variables['params']), None
    as_np = lambda t: jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), t)
    return {'out': as_np(list(out)), 'stats': as_np(stats),
            'metrics': as_np(metrics), 'grads': as_np(g)}


def port_pass(sd, batch, dtype=torch.float32, backbone_dtype=None):
    """The port's train-mode forward, compute_losses (epoch 0) and
    backward in `dtype` (float64: every module in float64 arithmetic;
    bfloat16: the whole model computing in bfloat16).
    Also returns each block's inputs, for the module tests."""
    model = KPFusion(dropout=0.0, backbone_dtype=backbone_dtype,
                     dtype=torch.float32 if dtype == torch.float64 else dtype)
    model.load_state_dict(sd)
    if dtype == torch.float64:
        set_compute_dtype(model.double(), torch.float64)
    model.train()
    blocks = {}
    for name in ('block1', 'block2'):
        getattr(model, name).register_forward_pre_hook(
            lambda m, args, name=name: blocks.__setitem__(name, args))
    b = batch_to_device(batch, 'cpu')
    frame = frame_from_batch(b, Config())
    with cpu_reference_convs(), cpu_reference_batch_norms():
        res, sw = model(b['rgb'], b['depth'], b['pcl'], frame, 0.8)
        loss, metrics = compute_losses(res, sw, b['depth'], b['uvd_gt'],
                                       b['xyz_gt'], frame, Config(), 0)
        loss.backward()
    tree = port_to_jax_tree(model)
    return {'out': [t.detach().double().numpy() for t in res + sw],
            'stats': tree['batch_stats'],
            'metrics': {k: float(v) for k, v in metrics.items()},
            'grads': port_to_jax_tree(model, grads=True)['params'],
            'model': model, 'blocks': blocks}


@pytest.fixture(scope='module')
def jax_f32(batch, weights):
    return jax_pass(weights[1], batch)


@pytest.fixture(scope='module')
def jax_f64(batch, weights):
    """JAX's pass in float64 (float32 inputs, as the port's float64 run
    takes them)."""
    with jax_float64():
        v = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                   weights[1])
        return jax_pass(v, batch, dtype=jnp.float64)


@pytest.fixture(scope='module')
def port_f32(batch, weights):
    return port_pass(weights[0], batch)


@pytest.fixture(scope='module')
def port_f64(batch, weights):
    return port_pass(weights[0], batch, torch.float64)


# ------------------------------------------------------------- modules --

@pytest.mark.parametrize('name,key', [('backbone_d', 'depth'),
                                      ('backbone_rgb', 'rgb')])
def test_resnet_unet_train_matches_flax(batch, weights, name, key):
    """img_result, img_feature and every new running statistic of one
    ResNet-UNet in train mode, within 1e-4 of scale (measured: the depth
    backbone's 2.1e-5 and 5.5e-5 of scale, its statistics 2.7e-5; the
    RGB backbone's 1.6e-6, 3.1e-6 and 5.4e-6)."""
    sd, v = weights
    ju = JUNet(depth=18, joint_num=21, deconv_dim=128,
               out_dims=(63, 21, 21))
    want, new = ju.apply({'params': v['params'][name],
                          'batch_stats': v['batch_stats'][name]},
                         jnp.asarray(batch[key]), True,
                         mutable=['batch_stats'])
    unet = KPFusion(dropout=0.0)
    unet.load_state_dict(sd)
    unet = getattr(unet, name).train()
    with torch.no_grad(), cpu_reference_convs(), \
            cpu_reference_batch_norms():
        got = unet(torch.from_numpy(batch[key]))
    for g, w in zip(got, want):
        assert err(g, w) <= 1e-4 * scale(w)
    sd_got = {f'{name}.{k}': t for k, t in unet.state_dict().items()}
    got_stats = convert_resnet_unet(sd_got, 18, f'{name}.')[1]
    for path, (e, s) in leaf_errors(got_stats, new['batch_stats']).items():
        assert e <= 1e-4 * max(1.0, s), path


@pytest.mark.parametrize('name,key', [('backbone_d', 'depth'),
                                      ('backbone_rgb', 'rgb')])
def test_resnet_unet_train_gradients_match_flax(batch, weights, name, key):
    """The parameter gradients of a fixed random scalar of one
    ResNet-UNet's two train-mode outputs, in float64 on both sides (the
    port's module in float64, JAX under jax_float64), within 1e-4 of each
    tensor's scale; the exact zeros within 1e-4 of the largest gradient.
    In float32 train-mode BatchNorm amplifies rounding past any such
    limit: the depth backbone's gradients there lie up to 0.51 of their
    scale apart (layer4_1.conv2). Measured in float64: 3.3e-13 of scale
    (depth), 2.4e-14 (RGB)."""
    sd, v = weights
    unet = KPFusion(dropout=0.0)
    unet.load_state_dict(sd)
    unet = getattr(unet, name).double().train()
    set_compute_dtype(unet, torch.float64)
    got = unet(torch.from_numpy(batch[key]))
    rng = np.random.RandomState(5)
    cot = [rng.randn(*g.shape) for g in got]
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cot)).backward()
    sd_grads = {f'{name}.{k}': t for k, t in unet.state_dict().items()}
    sd_grads.update({f'{name}.{k}': p.grad for k, p in
                     unet.named_parameters()})
    got_grads = jax.tree_util.tree_map(
        np.asarray, convert_resnet_unet(sd_grads, 18, f'{name}.')[0])

    ju = JUNet(depth=18, joint_num=21, deconv_dim=128,
               out_dims=(63, 21, 21), dtype=jnp.float64)
    with jax_float64():
        v64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                     {'params': v['params'][name],
                                      'batch_stats': v['batch_stats'][name]})

        def scalar(params):
            out, _ = ju.apply({'params': params,
                               'batch_stats': v64['batch_stats']},
                              jnp.asarray(batch[key]), True,
                              mutable=['batch_stats'])
            return sum(jnp.sum(o * c) for o, c in zip(out, cot))

        jgrads = jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64),
            jax.grad(scalar)(v64['params']))
    errors = leaf_errors(got_grads, jgrads)
    largest = max(s for _, s in errors.values())
    for path, (e, s) in errors.items():
        ref = largest if exact_zero_gradient(f"['{name}']" + path) else s
        assert e <= 1e-4 * ref, (path, e, s)


@pytest.mark.parametrize('name', ['block1', 'block2'])
def test_fusion_block_train_matches_flax(batch, weights, port_f32, name):
    """One fusion block in train mode on the inputs the port's forward
    gave it: its four outputs and new running statistics within 1e-4 of
    scale, and the gradients of a fixed random scalar of its outputs
    within 1e-4 of each tensor's scale (exact zeros: of the block's
    largest gradient). Measured: outputs 5.5e-6 of scale, statistics
    6.4e-6, gradients 5.9e-5 of each tensor's scale, the exact zeros
    6.5e-7 of the largest gradient."""
    _, v = weights
    args = [None if t is None else t.detach().numpy()
            for t in port_f32['blocks'][name][:6]]
    img_feat, img_feat_rgb, pcl, joint_xyz, sampled, updated = args
    img_down = port_f32['blocks'][name][7].numpy()
    rng = np.random.RandomState(3)
    cot = [rng.randn(2, 21, 3), rng.randn(2, 21, 3), rng.randn(2, 21, 128),
           rng.randn(2, 32, 32, 21)]
    cot = [c.astype(np.float32) for c in cot]
    jm = JBlock(joint_num=21, dim=128, dropout=0.0)
    jframe = j_frame({k: jnp.asarray(x) for k, x in batch.items()},
                     JConfig())

    def scalar(params):
        out, new = jm.apply(
            {'params': params, 'batch_stats': v['batch_stats'][name]},
            img_feat, img_feat_rgb, pcl, joint_xyz, sampled,
            np.zeros((2, 32, 32, 21), np.float32), updated, jframe,
            img_down, 0.8, True, mutable=['batch_stats'])
        return sum(jnp.sum(o * c) for o, c in zip(out, cot)), (out, new)

    (_, (want, new)), jgrads = jax.value_and_grad(scalar, has_aux=True)(
        v['params'][name])

    model = port_f32['model']
    block = getattr(model, name)
    before = {k: t.clone() for k, t in block.state_dict().items()}
    model.zero_grad(set_to_none=True)
    t = lambda x: None if x is None else torch.from_numpy(x)
    frame = frame_from_batch(batch_to_device(batch, 'cpu'), Config())
    with cpu_reference_batch_norms():
        got = block(t(img_feat), t(img_feat_rgb), t(pcl), t(joint_xyz),
                    t(sampled), t(updated), frame, t(img_down), 0.8)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cot)).backward()
    tree = port_to_jax_tree(model, grads=True)
    block.load_state_dict(before)       # the module fixture's state
    for g, w in zip(got, want):
        assert err(g.detach(), w) <= 1e-4 * scale(w)
    for path, (e, s) in leaf_errors(
            tree['batch_stats'][name],
            jax.tree_util.tree_map(np.asarray,
                                   new['batch_stats'])).items():
        assert e <= 1e-4 * max(1.0, s), path
    errors = leaf_errors(tree['params'][name],
                         jax.tree_util.tree_map(np.asarray, jgrads))
    largest = max(s for _, s in errors.values())
    for path, (e, s) in errors.items():
        ref = largest if exact_zero_gradient(path) else s
        assert e <= 1e-4 * ref, (path, e, s)


# --------------------------------------------------------- whole model --

def test_kpfusion_train_float64_matches_jax_float64(jax_f64, port_f64):
    """The whole train step's forward and backward in float64 on both
    sides: outputs, new running statistics, loss and metrics, and every
    parameter's gradient, at the limits of the module docstring."""
    for name, g, w in zip(OUTPUTS, port_f64['out'], jax_f64['out']):
        assert err(g, w) <= 1e-4 * scale(w), name
    for key, w in jax_f64['metrics'].items():
        w = float(w)
        assert abs(port_f64['metrics'][key] - w) \
            <= 1e-5 * max(1.0, abs(w)), key
    for path, (e, s) in leaf_errors(port_f64['stats'],
                                    jax_f64['stats']).items():
        assert e <= 1e-4 * max(1.0, s), path
    errors = leaf_errors(port_f64['grads'], jax_f64['grads'])
    largest = max(s for _, s in errors.values())
    assert len(errors) == 926
    named = {"['block1']['weight_dis']": 1e-3,
             "['block2']['weight_dis']": 1e-3}
    for path, (e, s) in errors.items():
        if exact_zero_gradient(path):
            assert e <= 1e-4 * largest, (path, e)
        else:
            assert e <= named.get(path, 1e-4) * s, (path, e, s)


def test_kpfusion_train_forward_and_gradients_match_jax(jax_f32, jax_f64,
                                                         port_f32):
    """The whole train step's forward and backward in float32: outputs,
    new running statistics, loss and metrics, and every parameter's
    gradient, within JAX's own float32-to-float64 distance (module
    docstring)."""
    for name, g, w, x in zip(OUTPUTS, port_f32['out'], jax_f32['out'],
                             jax_f64['out']):
        jax_gap = err(w, x)
        assert jax_gap <= 1e-3 * scale(w), name
        assert err(g, w) <= 2 * jax_gap + 1e-4 * scale(w), name
    for key in jax_f32['metrics']:
        w = float(jax_f32['metrics'][key])
        jax_gap = abs(w - float(jax_f64['metrics'][key]))
        assert abs(port_f32['metrics'][key] - w) \
            <= 2 * jax_gap + 1e-4 * max(1.0, abs(w)), key
    gaps = leaf_errors(jax_f32['stats'], jax_f64['stats'])
    for path, (e, s) in leaf_errors(port_f32['stats'],
                                    jax_f32['stats']).items():
        assert e <= 2 * gaps[path][0] + 1e-4 * max(1.0, s), path
    errors = leaf_errors(port_f32['grads'], jax_f32['grads'])
    gaps = leaf_errors(jax_f32['grads'], jax_f64['grads'])
    largest = max(s for _, s in errors.values())
    assert len(errors) == 926
    for path, (e, s) in errors.items():
        if exact_zero_gradient(path):
            assert e <= 1e-4 * largest, (path, e)
        else:
            assert e <= 3 * gaps[path][0] + 1e-4 * s, \
                (path, e, gaps[path][0], s)


def test_kpfusion_mixed_train_within_budget(batch, weights, jax_f32):
    """'mixed': each output and the loss within twice JAX's own
    mixed-to-float32 gap plus 2^-8 of the scale (measured in the module
    docstring)."""
    sd, v = weights
    jax_mixed = jax_pass(v, batch, backbone_dtype=jnp.bfloat16,
                         grads=False)
    port = port_pass(sd, batch, backbone_dtype=torch.bfloat16)
    assert port['model'].backbone_d.backbone.conv1.compute_dtype \
        == torch.bfloat16
    assert port['model'].block1.compute_dtype == torch.float32
    pairs = list(zip(OUTPUTS, port['out'], jax_mixed['out'],
                     jax_f32['out']))
    pairs.append(('loss', port['metrics']['loss'],
                  jax_mixed['metrics']['loss'], jax_f32['metrics']['loss']))
    for name, g, wm, w in pairs:
        jax_gap, gap = err(wm, w), err(g, w)
        assert jax_gap > 0, name
        assert gap <= 2 * jax_gap + 2 ** -8 * scale(w), (name, jax_gap, gap)


def test_kpfusion_bfloat16_train_within_budget(batch, weights, jax_f32):
    """Full bfloat16 (the whole model computing in bfloat16 over float32
    parameters, JAX's create_train_state with compute_dtype='bfloat16'):
    each output and the loss within twice JAX's own bfloat16-to-float32
    gap plus 2^-8 of the scale, the 'mixed' budget; the gradients finite
    and reaching every parameter JAX's reach."""
    sd, v = weights
    jax_bf16 = jax_pass(v, batch, dtype=jnp.bfloat16, grads=False)
    port = port_pass(sd, batch, dtype=torch.bfloat16)
    model = port['model']
    assert model.block1.compute_dtype == torch.bfloat16
    assert model.backbone_rgb.backbone.conv1.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    pairs = list(zip(OUTPUTS, port['out'], jax_bf16['out'],
                     jax_f32['out']))
    pairs.append(('loss', port['metrics']['loss'],
                  jax_bf16['metrics']['loss'], jax_f32['metrics']['loss']))
    measured = {}
    for name, g, wb, w in pairs:
        jax_gap, gap = err(wb, w), err(g, w)
        assert jax_gap > 0, name
        budget = 2 * jax_gap + 2 ** -8 * scale(w)
        measured[name] = gap / budget
        assert gap <= budget, (name, jax_gap, gap)
    port_scale = leaf_errors(port['grads'], port['grads'])
    reached = 0
    for path, (_, s) in leaf_errors(jax_f32['grads'],
                                    jax_f32['grads']).items():
        g = port_scale[path][1]
        assert np.isfinite(g), path
        if s > 0 and not exact_zero_gradient(path):
            assert g > 0, path
            reached += 1
    print('measured (of the budget)', measured, 'gradients', reached)


# ------------------------------------------------------- port contract --

def test_dropout_rate_scale_and_generator():
    """Dropout at 0.1 drops 0.1 +- 0.01 of 1e5 elements and scales the
    kept ones by 1/0.9; the same generator seed gives the same mask,
    another seed another; eval drops nothing; train mode without a
    generator raises."""
    x = torch.ones(100_000)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    y = dropout(x, 0.1, True, gen(0))
    assert abs(float((y == 0).float().mean()) - 0.1) <= 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.9, rtol=1e-6)
    assert torch.equal(y, dropout(x, 0.1, True, gen(0)))
    assert not torch.equal(y, dropout(x, 0.1, True, gen(1)))
    assert torch.equal(dropout(x, 0.1, False, gen(0)), x)
    with pytest.raises(ValueError, match='Generator'):
        dropout(x, 0.1, True, None)

    torch.manual_seed(0)
    tr = KPInteraction().eval()
    feats = torch.randn(2, 21, 128)
    with torch.no_grad():
        ref = tr(feats)[1]
        assert torch.equal(tr(feats, gen(0))[1], ref)    # eval: identity
        tr.train()
        a, b, c = (tr(feats, gen(s))[1] for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ref)


def test_no_gradient_through_the_stopped_values(batch, weights,
                                                 monkeypatch):
    """No gradient reaches the sampler's closeness, the block's
    point-joint encoding, its sampled weight channels or the joints it
    starts from; one does reach the sampled maps. A loss on the blocks'
    results alone leaves the depth backbone's decoding convolutions
    (which feed only the detached joints and weight channels) without a
    gradient."""
    sd, _ = weights
    seen = {}

    def select(*args, **kw):
        closeness, index = real_select(*args, **kw)
        seen['closeness'] = closeness.requires_grad_()
        return closeness, index

    def sample(flat, closeness, index):
        flat.retain_grad()
        seen['flat'] = flat
        return real_sample(flat, closeness, index)

    real_select, real_sample = kpf.img_to_pcl_index, kpf.sample_pixel_features
    monkeypatch.setattr(kpf, 'img_to_pcl_index', select)
    monkeypatch.setattr(kpf, 'sample_pixel_features', sample)
    model = KPFusion(dropout=0.0)
    model.load_state_dict(sd)
    model.train()
    blocks = {}
    model.block1.register_forward_pre_hook(
        lambda m, args: blocks.update(args=args))

    def grab(m, args):
        joint = args[3].detach().requires_grad_()
        sampled = args[4].detach().requires_grad_()
        blocks.update(joint=joint, sampled=sampled)
        return (*args[:3], joint, sampled, *args[5:])
    model.block2.register_forward_pre_hook(grab)
    b = batch_to_device(batch, 'cpu')
    res, sw = model(b['rgb'], b['depth'], b['pcl'],
                    frame_from_batch(b, Config()), 0.8)
    sum(t.square().sum() for t in res[2:] + sw).backward()
    assert seen['closeness'].grad is None
    assert float(seen['flat'].grad[..., :256].abs().max()) > 0
    assert float(seen['flat'].grad[..., 256:].abs().max()) == 0
    assert blocks['joint'].grad is None
    c = 128
    assert float(blocks['sampled'].grad[..., :2 * c].abs().max()) > 0
    assert float(blocks['sampled'].grad[..., 2 * c:].abs().max()) == 0
    for conv in model.backbone_d.finals:
        assert conv.weight.grad is None
    assert model.backbone_rgb.finals[0].weight.grad is None
    assert float(model.backbone_d.fusion_layer2.conv3.conv.weight.grad
                 .abs().max()) > 0
