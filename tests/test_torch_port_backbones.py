"""Port parity of the config's other backbones: ConvNeXt T/S/B/L
(keypointfusion_torch/models/convnext.py) and the Bottleneck ResNets
50/101/152 (models/resnet.py, models/unet.py), their weights
(utils/weights.py) and ImageNet warm starts (utils/pretrain.py).

The port's modules are drawn from torch seeds and carried to JAX by the
JAX package's own converters (utils/torch_convert.py), and whole models
back again by utils/weights.py:jax_kpfusion_to_state_dict, bit for bit. Layer scales (gamma, 1e-6 at init, which would leave every ConvNeXt
block an identity) are set to U(0.5, 1.5), and the decoders' BatchNorm
statistics to their input's (tests/torch_port_helpers.py:
calibrate_batch_norms), so that every layer moves the result. Narrow
ConvNeXts come from a test-only MODEL_LIST entry set in both packages;
the whole models' forward is held in test_torch_port_backbones_convnext.py
and _resnet.py.
Tolerances, float32 unless said, on inputs from numpy seeds:
  * modules in eval: 1e-4 of each output's scale (at least 1), JAX under
    jit; the port's CPU convolutions run without oneDNN
    (cpu_reference_convs).
  * train mode: outputs within 1e-4 of scale in float32; parameter
    gradients of a fixed random scalar of the outputs in float64 on both
    sides (JAX under jax_float64) within 1e-4 of each tensor's scale (of
    the largest gradient where the exact one is 0).
  * LayerNorm where |mean| >> std: flax takes the variance as E[x^2] -
    E[x]^2 in float32, which loses accuracy there; the port's two-pass
    LayerNorm is held to float64 and flax's distance from float64 is
    measured beside it.
Measured values are printed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import flax.linen as fnn

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.models import convnext as jcn
from keypointfusion_tpu.models.kpfusion import KPFusion as JKPFusion
from keypointfusion_tpu.models.unet import ResNetUNet as JUNet
from keypointfusion_tpu.training.train_step import frame_from_batch
from keypointfusion_tpu.utils import pretrain as jpretrain
from keypointfusion_tpu.utils.torch_convert import (
    conv2d_with_bias, convert_convnext_unet, convert_kpfusion_checkpoint,
    convert_resnet_unet, dense, layernorm, merge_partial as j_merge,
)

from keypointfusion_torch.config import Config
from keypointfusion_torch.models import convnext as cn
from keypointfusion_torch.models.kpfusion import build_kpfusion
from keypointfusion_torch.models.layers import set_compute_dtype
from keypointfusion_torch.models.resnet import ResNet
from keypointfusion_torch.models.unet import ResNetUNet
from keypointfusion_torch.utils.pretrain import imagenet_backbone_state_dict
from keypointfusion_torch.utils.weights import (
    jax_kpfusion_to_state_dict, load_kpfusion_weights,
    load_torch_checkpoint, merge_partial,
)

from tests.torch_port_helpers import (
    calibrate_batch_norms, cpu_reference_batch_norms, cpu_reference_convs,
    jax_float64, leaf_errors, set_layer_scales,
)

torch.set_num_threads(2)
NARROW = ((1, 2, 1, 1), (8, 16, 24, 32))


def err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def scale(a):
    return max(1.0, float(np.abs(np.asarray(a, np.float64)).max()))


def np_(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


@pytest.fixture
def narrow(monkeypatch):
    """The 'narrow' ConvNeXt size in both packages."""
    monkeypatch.setitem(cn.MODEL_LIST, 'narrow', NARROW)
    monkeypatch.setitem(jcn.MODEL_LIST, 'narrow', NARROW)
    return 'narrow'


def unet_variables(unet, kind, sd=None):
    """A port UNet of `kind` ('narrow', 'T' or 50), or the state_dict
    `sd` of one, as JAX variables through the JAX package's converter."""
    sd = {f'u.{k}': v for k, v in (sd or unet.state_dict()).items()}
    if kind == 50:
        p, s = convert_resnet_unet(sd, 50, 'u.')
    else:
        p, s = convert_convnext_unet(sd, kind, 'u.',
                                     unet.finals[0].in_channels)
    return jax.tree_util.tree_map(np.asarray, {'params': p,
                                               'batch_stats': s})


def jax_unet(unet, kind, dtype=jnp.float32):
    out_dims = tuple(c.out_channels for c in unet.finals)
    if kind == 50:
        return JUNet(depth=50, out_dims=out_dims, dtype=dtype)
    return jcn.ConvNeXtUNet(size=kind, deconv_dim=unet.finals[0].in_channels,
                            out_dims=out_dims, dtype=dtype)


def make_unet(kind, in_channels, x, seed=0):
    """A port UNet of `kind` from `seed`, its layer scales and decoder
    statistics set (module docstring)."""
    torch.manual_seed(seed)
    if kind == 50:
        unet = ResNetUNet(in_channels, 50)
    elif kind == 'narrow':
        unet = cn.ConvNeXtUNet(in_channels, 'narrow', 16, (6, 2, 2))
    else:
        unet = cn.ConvNeXtUNet(in_channels, kind)
    set_layer_scales(unet, seed + 1)
    with cpu_reference_convs():
        calibrate_batch_norms(unet, torch.from_numpy(x))
    return unet.eval()


# -------------------------------------------------------------- modules --

def test_convnext_block_matches_flax():
    """One ConvNeXt block (dwconv, LayerNorm, both Linears, exact GELU,
    layer scale, residual), eval, width 16."""
    torch.manual_seed(0)
    block = cn.ConvNeXtBlock(16).eval()
    set_layer_scales(block, 1)
    sd = {f'b.{k}': v for k, v in block.state_dict().items()}
    params = {'dwconv': conv2d_with_bias(sd, 'b.dwconv'),
              'norm': layernorm(sd, 'b.norm'),
              'pwconv1': dense(sd, 'b.pwconv1'),
              'pwconv2': dense(sd, 'b.pwconv2'),
              'gamma': sd['b.gamma'].numpy()}
    x = np.random.RandomState(0).randn(2, 9, 11, 16).astype(np.float32)
    want = jcn.ConvNeXtBlock(16).apply({'params': params}, jnp.asarray(x))
    with torch.no_grad(), cpu_reference_convs():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    e = err(np_(got.permute(0, 2, 3, 1)), want)
    print('block', e)
    assert e <= 1e-5 * scale(want)


@pytest.mark.parametrize('kind,channels', [('narrow', 1), ('narrow', 3),
                                           ('T', 1), (50, 1)],
                         ids=['convnext-narrow-depth', 'convnext-narrow-rgb',
                              'convnext-T-depth', 'resnet-50-depth'])
def test_unet_eval_matches_flax(request, kind, channels):
    """The encoder's four stage maps (ConvNeXt) and the UNet's two
    outputs, eval: narrow at batch 2, ConvNeXt-T and ResNet-50 at full
    width on one 128x128 frame."""
    if kind == 'narrow':
        request.getfixturevalue('narrow')
    b = 2 if kind == 'narrow' else 1
    x = synthetic_batch(batch_size=b, point_num=64, seed=3)[
        'depth' if channels == 1 else 'rgb']
    unet = make_unet(kind, channels, x)
    v = unet_variables(unet, kind)
    want = jax.jit(jax_unet(unet, kind).apply)(v, jnp.asarray(x))
    with torch.no_grad(), cpu_reference_convs():
        got = unet(torch.from_numpy(x))
    errors = [err(np_(g), w) / scale(w) for g, w in zip(got, want)]
    if isinstance(unet, cn.ConvNeXtUNet):
        jfeats = jax.jit(jcn.ConvNeXt(
            *cn.MODEL_LIST[cn.resolve_size(kind)]).apply)(
            {'params': v['params']['backbone']}, jnp.asarray(x))
        with torch.no_grad(), cpu_reference_convs():
            feats = unet.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        errors += [err(np_(f.permute(0, 2, 3, 1)), w) / scale(w)
                   for f, w in zip(feats, jfeats)]
    print(kind, channels, 'errors / scale', errors)
    assert max(errors) <= 1e-4


def test_layernorm_large_mean_against_float64():
    """Both LayerNorm layouts on inputs whose mean is 30 std from 0: the
    port within float32 rounding of float64 (2e-5; measured 4.9e-6),
    flax's fast variance much further (its E[x^2] - E[x]^2 cancels 3 of
    float32's 7 digits; measured 5.6e-4 at width 96). No float32 sum order
    in torch reproduces XLA's: flax's formula computed in torch lies
    further from flax (measured 8.9e-4) than the port does. At |mean| ~ std, as in the models' inputs
    here, the port and flax agree within 1e-5 (measured 1.4e-6)."""
    rng = np.random.RandomState(0)
    w = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    bias = (0.1 * rng.randn(96)).astype(np.float32)
    ln_last = cn.LayerNorm(96, eps=1e-6)
    ln_first = cn.LayerNorm2d(96, eps=1e-6)
    with torch.no_grad():
        for ln in (ln_last, ln_first):
            ln.weight.copy_(torch.from_numpy(w))
            ln.bias.copy_(torch.from_numpy(bias))
    flax_ln = fnn.LayerNorm(epsilon=1e-6)
    for offset, port_tol, flax_min in ((30.0, 2e-5, 1e-4),
                                       (1.0, 1e-5, None)):
        x = (rng.randn(2, 8, 8, 96)
             + offset * rng.choice([-1, 1], (2, 8, 8, 1))).astype(np.float32)
        exact = torch.nn.functional.layer_norm(
            torch.from_numpy(x).double(), (96,), torch.from_numpy(w).double(),
            torch.from_numpy(bias).double(), 1e-6).numpy()
        flax_out = np.asarray(flax_ln.apply(
            {'params': {'scale': w, 'bias': bias}}, jnp.asarray(x)))
        with torch.no_grad():
            last = ln_last(torch.from_numpy(x)).numpy()
            first = ln_first(torch.from_numpy(x).permute(0, 3, 1, 2)
                             ).permute(0, 2, 3, 1).numpy()
        xt = torch.from_numpy(x)          # flax's formula in torch
        mean = xt.mean(-1, keepdim=True)
        var = ((xt * xt).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
        fast = ((xt - mean) * (torch.rsqrt(var + 1e-6) * torch.from_numpy(w))
                + torch.from_numpy(bias)).numpy()
        print(offset, 'port', err(last, exact), err(first, exact),
              'flax', err(flax_out, exact), 'port-flax', err(last, flax_out),
              "flax's formula in torch - flax", err(fast, flax_out))
        assert err(last, exact) <= port_tol and err(first, exact) <= port_tol
        assert np.array_equal(last, first)
        if flax_min is None:
            assert err(last, flax_out) <= 1e-5
        else:
            assert err(flax_out, exact) >= flax_min


def test_drop_path_contract():
    """Identity in eval and at rate 0; in train each sample's branch is
    dropped or scaled by 1/keep, the masks drawn from the generator (the
    same seed, the same masks), about keep of them kept; gradients pass
    to the kept samples only."""
    x = torch.randn(4000, 3, 2, 2, requires_grad=True)
    dp = cn.DropPath(0.25)
    assert dp.eval()(x) is x and cn.DropPath(0.0).train()(x) is x
    dp.train()
    y1 = dp(x, torch.Generator().manual_seed(1))
    y2 = dp(x, torch.Generator().manual_seed(1))
    y3 = dp(x, torch.Generator().manual_seed(2))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    kept = (y1 != 0).flatten(1).any(1)
    assert torch.equal((y1 == 0).flatten(1).all(1), ~kept)
    torch.testing.assert_close(y1[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    y1.sum().backward()
    grad_kept = x.grad.flatten(1)[:, 0]
    assert torch.equal(grad_kept, torch.where(kept, 1 / 0.75, 0.0))


# ---------------------------------------------------------- train mode --

@pytest.mark.parametrize('kind,stride', [('narrow', 4), (50, 2)],
                         ids=['convnext-narrow', 'resnet-50'])
def test_unet_train_matches_flax(request, kind, stride):
    """Train mode (batch statistics), batch 2: the outputs and the
    parameter gradients of a fixed random scalar of both outputs in
    float64 on both sides within 1e-4 of each tensor's scale; narrow
    ConvNeXt on 32x32 frames, ResNet-50 at its widths on 64x64. In
    float32 the narrow ConvNeXt's outputs are within 1e-4 of scale as
    well; ResNet-50's are not: its last stage's BatchNorms normalize 8
    values per channel (2x2, batch 2) and amplify float32 rounding past
    that limit, in JAX's own float32 run too."""
    if kind == 'narrow':
        request.getfixturevalue('narrow')
    x = synthetic_batch(batch_size=2, point_num=64, seed=4)['depth']
    x = np.ascontiguousarray(x[:, ::stride, ::stride])
    unet = make_unet(kind, 1, x)
    v = unet_variables(unet, kind)
    unet.train()
    out_errors = []
    if kind == 'narrow':
        ju = jax_unet(unet, kind)
        want, _ = jax.jit(lambda v, x: ju.apply(v, x, True, mutable=[
            'batch_stats']))(v, jnp.asarray(x))
        with torch.no_grad(), cpu_reference_convs(), \
                cpu_reference_batch_norms():
            got = unet(torch.from_numpy(x))
        out_errors = [err(np_(g), w) / scale(w) for g, w in zip(got, want)]
        assert max(out_errors) <= 1e-4, out_errors

    u64 = set_compute_dtype(unet.double(), torch.float64)
    got = u64(torch.from_numpy(x))
    rng = np.random.RandomState(5)
    cot = [rng.randn(*g.shape) for g in got]
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cot)).backward()
    sd = dict(u64.state_dict())
    sd.update({k: p.grad for k, p in u64.named_parameters()})
    got_grads = unet_variables(unet, kind, sd)['params']
    ju = jax_unet(unet, kind, jnp.float64)
    with jax_float64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

        def scalar(params):
            out, _ = ju.apply({'params': params,
                               'batch_stats': v64['batch_stats']},
                              jnp.asarray(x), True, mutable=['batch_stats'])
            return sum(jnp.sum(o * c) for o, c in zip(out, cot)), out
        (_, want64), jgrads = jax.jit(jax.value_and_grad(
            scalar, has_aux=True))(v64['params'])
        want64 = [np.asarray(w, np.float64) for w in want64]
        jgrads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        jgrads)
    out64 = [err(np_(g), w) / scale(w) for g, w in zip(got, want64)]
    assert max(out64) <= 1e-4, out64
    errors = leaf_errors(got_grads, jgrads)
    largest = max(s for _, s in errors.values())
    # a bias before a train-mode BatchNorm: 0 in exact arithmetic, held
    # within 1e-4 of the largest gradient
    ref = {p: largest if s < 1e-9 * largest else s
           for p, (_, s) in errors.items()}
    worst = max(e / ref[p] for p, (e, _) in errors.items())
    print(kind, 'train outputs / scale, float32', out_errors, 'float64',
          out64, 'gradients', worst)
    assert worst <= 1e-4


# -------------------------------------------------------------- weights --

@pytest.fixture(params=['KPFusion-convnext-narrow', 'KPFusion-resnet-50'])
def net(request):
    if 'narrow' in request.param:
        request.getfixturevalue('narrow')
    return request.param


@torch.no_grad()
def perturbed_model(net, seed=0):
    """The port's model of `net` from `seed`, its layer scales and every
    BatchNorm's running statistics perturbed (without a forward pass)."""
    model = build_kpfusion(Config(net=net), device='cpu', seed=seed)
    set_layer_scales(model, seed + 1)
    g = torch.Generator().manual_seed(seed + 2)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


def test_weights_round_trip(net):
    """Port state_dict -> the JAX package's converter -> utils/weights.py
    gives back every tensor bit for bit, and the converted tree has
    exactly the leaves and shapes of the JAX module's own init."""
    sd = perturbed_model(net).state_dict()
    variables = jax.tree_util.tree_map(
        np.asarray, convert_kpfusion_checkpoint(sd, net=net))
    back = jax_kpfusion_to_state_dict(variables, net)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    b = synthetic_batch(batch_size=1, point_num=32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    shapes = jax.eval_shape(
        JKPFusion(net=net, joint_num=21).init, jax.random.PRNGKey(0),
        jb['rgb'], jb['depth'], jb['pcl'], frame_from_batch(jb, JConfig()))
    for tree in ('params', 'batch_stats'):
        want = {jax.tree_util.keystr(p): s.shape for p, s in
                jax.tree_util.tree_leaves_with_path(shapes[tree])}
        got = {jax.tree_util.keystr(p): np.shape(a) for p, a in
               jax.tree_util.tree_leaves_with_path(variables[tree])}
        assert got == want, tree


def test_reference_checkpoint_loads(net, tmp_path):
    """A reference-named `.pth` ({'model': sd} with the DataParallel
    prefix, and the ConvNeXt decoder's dead `feat_emb`) loads every
    weight through load_torch_checkpoint + load_kpfusion_weights; a
    missing weight raises."""
    sd = perturbed_model(net).state_dict()
    ref = {f'module.{k}': v for k, v in sd.items()}
    for b in ('backbone_d', 'backbone_rgb'):
        ref[f'module.{b}.feat_emb.bn1.weight'] = torch.ones(128)
    path = str(tmp_path / 'ref.pth')
    torch.save({'model': ref}, path)
    model = build_kpfusion(Config(net=net), device='cpu', seed=1)
    load_kpfusion_weights(model, load_torch_checkpoint(path))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del ref['module.backbone_d.finals.0.bias']
    torch.save({'model': ref}, path)
    with pytest.raises(KeyError, match='backbone_d.finals.0.bias'):
        load_kpfusion_weights(model, load_torch_checkpoint(path))


# --------------------------------------------------------- warm starts --

def _fabricated_imagenet(net, path):
    """An ImageNet release checkpoint of the net's encoder with random
    weights: ConvNeXt's {'model': sd} with its RGB stem and classifier
    (norm, head); torchvision's ResNet state_dict with its fc."""
    torch.manual_seed(7)
    if 'convnext' in net:
        depths, dims = cn.MODEL_LIST[cn.resolve_size(net.split('-')[-1])]
        enc = cn.ConvNeXt(3, depths, dims)
        set_layer_scales(enc, 8)
        sd = dict(enc.state_dict())
        sd['norm.weight'], sd['norm.bias'] = torch.rand(dims[3]), \
            torch.rand(dims[3])
        sd['head.weight'] = torch.rand(1000, dims[3])
        sd['head.bias'] = torch.rand(1000)
        torch.save({'model': sd}, path)
    else:
        enc = ResNet(int(net.split('-')[-1]), 3)
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 1.5)
        sd = dict(enc.state_dict())
        sd['fc.weight'], sd['fc.bias'] = torch.rand(1000, 2048), \
            torch.rand(1000)
        torch.save(sd, path)
    return sd


def test_imagenet_warm_start_matches_jax(net, tmp_path):
    """The port's warm start (imagenet_backbone_state_dict merged by
    merge_partial over a fresh model) against JAX's
    (imagenet_backbone_variables merged by its merge_partial over the
    same fresh model's variables): equal leaf for leaf. Both keep the
    fresh stems (ConvNeXt: both; ResNet: the depth one) and take every
    other encoder tensor."""
    path = str(tmp_path / 'imagenet.pth')
    release = _fabricated_imagenet(net, path)
    fresh = build_kpfusion(Config(net=net), device='cpu', seed=2)
    init = fresh.state_dict()
    pre = imagenet_backbone_state_dict(Config(net=net, pretrain_dir=path))
    merged, used, _ = merge_partial(init, pre)
    jinit = convert_kpfusion_checkpoint(init, net=net)
    jpre = jpretrain.imagenet_backbone_variables(
        JConfig(net=net, pretrain_dir=path))
    jmerged, _, _ = j_merge(jinit, jpre)
    for tree in ('params', 'batch_stats'):
        errors = leaf_errors(convert_kpfusion_checkpoint(merged, net=net)[
            tree], jmerged[tree])
        assert all(e == 0 for e, _ in errors.values()), tree
    stems = [k for k in init if k.endswith(
        ('backbone.conv1.weight', 'downsample_layers.0.0.weight'))]
    for k in stems:
        took = k in used
        assert took == (net.endswith('50') and 'backbone_rgb' in k), k
    n_encoder = sum(1 for k in release if not k.startswith(
        ('fc.', 'norm.', 'head.', 'downsample_layers.0.')))
    assert len(used) == 2 * n_encoder - (1 if net.endswith('50') else 0)
