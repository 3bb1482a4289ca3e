"""Port parity of the optional model families: models/legacy.py (PoseNet,
Hourglass, ConvBNRelu, CBAM with its channel and spatial gates,
CenterNetRegressor), models/rgbd_fusion.py (FilterLayer, FSP,
RGBDFusion, ACFusion, RGBDBasicBlock, RGBDResNet, RGBDResNetUNet) and
models/transformer_extra.py (the DETR sine embedding, DetrDecoder,
SpatialAggregateTR), with their weight carries (utils/weights.py).

Each port module is drawn from a torch seed, its BatchNorm statistics
set to those of its input (tests/torch_port_helpers.py:
calibrate_batch_norms) and its variables carried to JAX by the inverse
of the family's carry (tests/torch_port_helpers.py:carry_inverse); the
JAX module's variable shapes come from jax.eval_shape of its init.
Inputs are drawn with numpy from seeds. Tolerances:
  * eval, float32: every output within 1e-4 of its scale (at least 1),
    JAX under jit; the port's CPU convolutions run without oneDNN
    (cpu_reference_convs).
  * train mode, PoseNet (one stack; eval holds two) and RGBDResNetUNet:
    the outputs, the updated BatchNorm statistics and the parameter
    gradients of a fixed random scalar of the outputs, in float64 on
    both sides (JAX under jax_float64) within 1e-4 of each tensor's
    scale (of the largest
    gradient where the exact one is 0: a bias before a train-mode
    BatchNorm, the attention's key bias). The running statistics are
    drawn at random first, so that their update is seen. float32 is
    ill-conditioned there: RGBDResNetUNet's last stage normalizes 2x2
    maps at batch 2, and the hourglass's innermost Residuals 2x2 maps
    as well.
  * train mode, CBAM (its spatial BatchNorm's momentum 0.01 against the
    Residuals' 0.1) and the DETR layers (dropout 0): float32, 1e-4 of
    scale on outputs, statistics and gradients.
  * the sine embedding within 1e-6 (float32 powers may differ by an ulp
    between XLA and torch).
  * carries: the parity above is their real check. Besides, each carry
    is injective (JAX variables -> state_dict -> the inverse learned
    from the same carry gives the variables back bit for bit: no JAX
    element is lost or written twice) and its state_dict loads strictly
    into the port module.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.models import legacy as jl
from keypointfusion_tpu.models import rgbd_fusion as jr
from keypointfusion_tpu.models import transformer_extra as jt

from keypointfusion_torch.models import legacy as tl
from keypointfusion_torch.models import rgbd_fusion as tr
from keypointfusion_torch.models import transformer_extra as tt
from keypointfusion_torch.models.layers import set_compute_dtype
from keypointfusion_torch.utils import weights as W

from tests.torch_port_helpers import (
    calibrate_batch_norms, carry_inverse, cpu_reference_convs, jax_float64,
    leaf_errors,
)

torch.set_num_threads(2)


def err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def scale(a):
    return max(1.0, float(np.abs(np.asarray(a, np.float64)).max()))


def np_(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def template(jmodel, inputs):
    """Zeros shaped like jmodel's variables on `inputs`, from
    jax.eval_shape of its init (nothing compiled)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(x) for x in inputs])
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  dict(shapes))


_CARRIED = {}


def carried(tmodel, jmodel, carry, inputs, calibrate=True):
    """(port module in eval, its JAX variables, the carry of whole
    variables, its inverse): the port module's BatchNorm statistics,
    where it has some, set to those of `inputs`, its state_dict carried
    back to JAX."""
    if calibrate and any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                         for m in tmodel.modules()):
        with cpu_reference_convs():
            calibrate_batch_norms(tmodel, *[torch.from_numpy(x)
                                            for x in inputs])
    tmodel.eval()
    key = (repr(jmodel), carry.__name__, tuple(x.shape for x in inputs))
    if key not in _CARRIED:     # the eval and the train test share these
        tmpl = template(jmodel, inputs)
        if 'batch_stats' not in tmpl:   # the carry takes {'params'} alone
            carry = (lambda c: lambda v: c(v['params']))(carry)
        _CARRIED[key] = carry, carry_inverse(carry, tmpl)
    carry, inverse = _CARRIED[key]
    return tmodel, inverse(tmodel.state_dict()), carry, inverse


@torch.no_grad()
def perturb_stats(tmodel, seed=12):
    """Running means ~N(0, 0.1), variances ~U(0.5, 1.5): a train step then
    moves them (after calibrate_batch_norms it would leave them)."""
    g = torch.Generator().manual_seed(seed)
    for m in tmodel.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.uniform_(0.5, 1.5, generator=g)


def eval_errors(tmodel, jmodel, v, inputs):
    want = flat(jax.jit(jmodel.apply)(v, *[jnp.asarray(x) for x in inputs]))
    with torch.no_grad(), cpu_reference_convs():
        got = tmodel(*[torch.from_numpy(x) for x in inputs])
    got = [got] if isinstance(got, torch.Tensor) else \
        [g for g in jax.tree_util.tree_leaves(
            got, is_leaf=lambda t: isinstance(t, torch.Tensor))]
    assert len(got) == len(want)
    return [err(np_(g), w) / scale(w) for g, w in zip(got, want)]


def check_round_trip(tmodel, carry, v, inverse):
    sd = carry(v)
    tmodel.load_state_dict(sd, strict=True)
    back = inverse(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    assert all(np.array_equal(a, b) for a, b in zip(flat(back), flat(v)))
    for k, t in tmodel.state_dict().items():
        if t.is_floating_point():
            assert torch.equal(t, sd[k]), k


# --------------------------------------------------------------- eval --

def posenet_case(nstack=2):
    torch.manual_seed(0)
    x = [np.abs(rand(1, 2, 64, 64, 1))]
    return (tl.PoseNet(nstack=nstack, inp_dim=32),
            jl.PoseNet(nstack=nstack, inp_dim=32),
            W.jax_posenet_to_state_dict, x)


def rgbd_case():
    torch.manual_seed(1)
    x = [rand(2, 2, 64, 64, 3), rand(3, 2, 64, 64, 1)]
    return (tr.RGBDResNetUNet(), jr.RGBDResNetUNet(),
            W.jax_rgbd_resnet_unet_to_state_dict, x)


def cbam_case():
    torch.manual_seed(2)
    return (tl.CBAM(64), jl.CBAM(64), W.jax_cbam_to_state_dict,
            [rand(4, 2, 12, 10, 64) + 0.5])


def centernet_case():
    torch.manual_seed(3)
    return (tl.CenterNetRegressor(), jl.CenterNetRegressor(),
            W.jax_centernet_to_state_dict, [rand(5, 2, 64, 64, 1)])


def fusion_case(name):
    torch.manual_seed(4)
    x = [rand(6, 2, 8, 8, 32), rand(7, 2, 8, 8, 32)]
    tmod, jmod, carry = {
        'rgbd_fusion': (tr.RGBDFusion(32), jr.RGBDFusion(32),
                        W.jax_rgbd_fusion_to_state_dict),
        'acfusion': (tr.ACFusion(32), jr.ACFusion(32),
                     W.jax_acfusion_to_state_dict),
        'fsp': (tr.FSP(64, 32), jr.FSP(32),
                W.jax_fsp_to_state_dict)}[name]
    return _NHWC(tmod), jmod, carry, x


class _NHWC(torch.nn.Module):
    """A fusion layer (NCHW in the port) called on NHWC inputs, its
    outputs NHWC, as the JAX layer is called; its state_dict is the
    layer's."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *xs):
        out = self.layer(*[x.permute(0, 3, 1, 2) for x in xs])
        return jax.tree_util.tree_map(
            lambda t: t.permute(0, 2, 3, 1), out,
            is_leaf=lambda t: isinstance(t, torch.Tensor))

    def state_dict(self, *args, **kw):
        return self.layer.state_dict(*args, **kw)

    def load_state_dict(self, *args, **kw):
        return self.layer.load_state_dict(*args, **kw)


def detr_case(cls, layers=1, dropout=0.1):
    torch.manual_seed(5)
    anchors, img = rand(8, 2, 21, 128), rand(9, 2, 6, 7, 128)
    x = [anchors, img] if cls == 'DetrDecoder' else [img, anchors]
    carry = W.jax_detr_decoder_to_state_dict if cls == 'DetrDecoder' \
        else W.jax_spatial_aggregate_tr_to_state_dict
    return (getattr(tt, cls)(layers=layers, dropout=dropout),
            getattr(jt, cls)(layers=layers, dropout=dropout), carry, x)


CASES = {
    'posenet': posenet_case,
    'rgbd_resnet_unet': rgbd_case,
    'cbam': cbam_case,
    'centernet': centernet_case,
    'rgbd_fusion': lambda: fusion_case('rgbd_fusion'),
    'acfusion': lambda: fusion_case('acfusion'),
    'fsp': lambda: fusion_case('fsp'),
    'detr_decoder': lambda: detr_case('DetrDecoder'),
    'spatial_aggregate_tr': lambda: detr_case('SpatialAggregateTR'),
    'detr_decoder_3_layers': lambda: detr_case('DetrDecoder', 3),
}


@pytest.mark.parametrize('name', list(CASES))
def test_eval_matches_jax_and_weights_round_trip(name):
    """The eval forward within 1e-4 of scale; the carry is injective
    (carry, then its inverse, gives the JAX variables back bit for bit)
    and loads strictly. 'detr_decoder_3_layers' checks that only the
    last of the layers counts, each fed the original inputs."""
    tmodel, jmodel, carry, x = CASES[name]()
    tmodel, v, carry, inverse = carried(tmodel, jmodel, carry, x)
    errors = eval_errors(tmodel, jmodel, v, x)
    print(name, 'errors / scale', errors)
    assert max(errors) <= 1e-4
    check_round_trip(tmodel, carry, v, inverse)


def test_detr_sine_position_embedding_matches_jax():
    for h, w, dim in ((32, 32, 64), (6, 7, 16), (1, 5, 4)):
        want = np.asarray(jax.jit(jt.detr_sine_position_embedding,
                                  static_argnums=(0, 1, 2))(h, w, dim))
        got = tt.detr_sine_position_embedding(h, w, dim, device='cpu')
        assert got.dtype == torch.float32 and got.shape == want.shape
        e = err(got.numpy(), want)
        print(h, w, dim, 'error', e)
        assert e <= 1e-6


def test_posenet_and_centernet_contracts():
    """The JAX contract test's shapes at the config's 128x128 input."""
    x = torch.zeros(1, 128, 128, 1)
    with torch.no_grad():
        preds, feature = tl.PoseNet().eval()(x)
        assert preds.shape == (1, 32, 32, 105)
        assert feature.shape == (1, 32, 32, 256)
        assert tl.CenterNetRegressor().eval()(
            torch.zeros(2, 128, 128, 1)).shape == (2, 21, 3)


# --------------------------------------------------------- train mode --

def grad_ratio(got_grads, want_grads):
    """The worst gradient error over its tensor's scale; a gradient under
    1e-6 of the largest is one whose exact value is 0 (a bias before a
    train-mode BatchNorm, the attention's key bias, which the softmax
    cancels), held against the largest."""
    errors = leaf_errors(got_grads, want_grads)
    largest = max(s for _, s in errors.values())
    ref = {p: largest if s < 1e-6 * largest else s
           for p, (_, s) in errors.items()}
    return max(e / ref[p] for p, (e, _) in errors.items())


def train_errors(tmodel, jmodel, v, inverse, x, float64, seed=11):
    """(outputs, statistics, gradients) of one train-mode forward and
    backward of sum(out * cot): each the worst error over its scale,
    the port against JAX, in float64 on both sides or in float32."""
    dt = torch.float64 if float64 else torch.float32
    jdt = jnp.float64 if float64 else jnp.float32
    tmodel.train()
    if float64:
        tmodel = set_compute_dtype(tmodel.double(), torch.float64)
    xs = [torch.from_numpy(a).to(dt) for a in x]
    with cpu_reference_convs():
        out = tmodel(*xs)
    out = [out] if isinstance(out, torch.Tensor) else list(out)
    rng = np.random.RandomState(seed)
    cot = [rng.randn(*o.shape) for o in out]
    sum((o * torch.from_numpy(c).to(dt)).sum()
        for o, c in zip(out, cot)).backward()
    sd = dict(tmodel.state_dict())
    grads = dict(sd)
    grads.update({k: (torch.zeros_like(p) if p.grad is None else p.grad)
                  for k, p in tmodel.named_parameters()})
    got_v, got_g = inverse(sd), inverse(grads)
    jmodel = jmodel.clone(dtype=jdt)
    with jax_float64() if float64 else contextlib.nullcontext():
        vj = jax.tree_util.tree_map(lambda a: np.asarray(a, jdt), v)

        def scalar(params):
            res, state = jmodel.apply(
                {'params': params, 'batch_stats': vj.get('batch_stats', {})},
                *[jnp.asarray(a) for a in x], True, mutable=['batch_stats'])
            res = jax.tree_util.tree_leaves(res)
            return sum(jnp.sum(r * c) for r, c in zip(res, cot)), (res,
                                                                  state)
        (_, (want, state)), jgrads = jax.jit(jax.value_and_grad(
            scalar, has_aux=True))(vj['params'])
        want = [np.asarray(w, np.float64) for w in want]
        jgrads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        jgrads)
        state = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       dict(state))
    outs = max(err(np_(o), w) / scale(w) for o, w in zip(out, want))
    stats = 0.0
    if 'batch_stats' in v:
        # the step moved every running statistic
        assert all(not np.allclose(a, b) for a, b in zip(
            flat(state['batch_stats']), flat(v['batch_stats'])))
        stats = max(e / max(1.0, s) for e, s in leaf_errors(
            got_v['batch_stats'], state['batch_stats']).values())
    return outs, stats, grad_ratio(got_g['params'], jgrads)


@pytest.mark.parametrize('name,float64', [
    ('posenet', True), ('rgbd_resnet_unet', True), ('cbam', False)],
    ids=['posenet-float64', 'rgbd_resnet_unet-float64', 'cbam-float32'])
def test_train_mode_matches_jax(name, float64):
    """Train mode: outputs, updated BatchNorm statistics (the shared
    downsample BatchNorm of RGBDResNetUNet's blocks updated twice a
    call, CBAM's spatial BatchNorm at momentum 0.01) and parameter
    gradients, within 1e-4 of scale."""
    # one hourglass: the train graph's JAX trace and compile take most of
    # the file's time, and the second stack adds only plain 1x1 merges
    tmodel, jmodel, carry, x = posenet_case(nstack=1) \
        if name == 'posenet' else CASES[name]()
    perturb_stats(tmodel)
    tmodel, v, _, inverse = carried(tmodel, jmodel, carry, x,
                                    calibrate=False)
    errors = train_errors(tmodel, jmodel, v, inverse, x, float64)
    print(name, 'float64' if float64 else 'float32',
          '(outputs, statistics, gradients) / scale', errors)
    assert max(errors) <= 1e-4


@pytest.mark.parametrize('cls', ['DetrDecoder', 'SpatialAggregateTR'])
def test_detr_train_mode_matches_jax(cls):
    """Train mode at dropout 0, two layers, float32: outputs and
    gradients within 1e-4 of scale; the first layer's gradients are 0
    on both sides (its output is never used)."""
    tmodel, jmodel, carry, x = detr_case(cls, layers=2, dropout=0.0)
    tmodel, v, _, inverse = carried(tmodel, jmodel, carry, x,
                                    calibrate=False)
    outs, _, grads = train_errors(tmodel, jmodel, v, inverse, x, False)
    print(cls, 'train (outputs, gradients) / scale', outs, grads)
    assert max(outs, grads) <= 1e-4
    assert all(p.grad is None for k, p in tmodel.named_parameters()
               if k.endswith('_0.weight') or k.startswith('layer_0.'))
