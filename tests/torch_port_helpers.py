"""Shared helpers of the port parity tests (tests/test_torch_port_*.py)
and of tests/torch_port_parity_report.py."""

import contextlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch


def cpu_reference_convs():
    """Run torch's CPU convolutions without oneDNN. oneDNN's float32
    kernels sum a 3x3x256 window with about 5x the rounding error of
    XLA's CPU convolution (1.5e-5 against 3.1e-6 on outputs of 7, both
    against float64); PyTorch's own im2col + GEMM path matches XLA's, so
    the backbones compare at float32 rounding and not at oneDNN's."""
    return torch.backends.mkldnn.flags(enabled=False)


def perturb_batch_stats(tree, seed=0):
    """Running means ~N(0, 0.1) and variances ~U(0.5, 1.5), so that eval
    BatchNorm (and its folding) is not the identity."""
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict) and set(t) == {'mean', 'var'}:
            shape = np.shape(t['mean'])
            return {'mean': rng.normal(0, 0.1, shape).astype(np.float32),
                    'var': rng.uniform(0.5, 1.5, shape).astype(np.float32)}
        return {k: walk(v) for k, v in t.items()}
    return walk(jax.tree_util.tree_map(np.asarray, tree))


@torch.no_grad()
def calibrate_batch_norms(module: torch.nn.Module, *inputs) -> None:
    """Set every BatchNorm's running statistics to those of its input on
    one forward pass, as training leaves them: eval activations are then
    of unit scale, as in a trained network, instead of growing layer by
    layer under random weights (which would turn float32 rounding into
    errors of 1e-3 on values of 1e2)."""
    norms = [m for m in module.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None           # cumulative average: one batch = its stats
    module.train()
    module(*inputs)
    module.eval()
    for m in norms:
        m.momentum = 0.1


def init_jax_kpfusion(batch, seed=7):
    """The JAX KPFusion (21 joints) and its variables from one jitted init
    on `batch`, as numpy."""
    from keypointfusion_tpu.config import Config
    from keypointfusion_tpu.models.kpfusion import KPFusion
    from keypointfusion_tpu.training.train_step import frame_from_batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = KPFusion(joint_num=21)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jb['rgb'],
                            jb['depth'], jb['pcl'],
                            frame_from_batch(jb, Config()))
    return model, {'params': jax.tree_util.tree_map(np.asarray, v['params']),
                   'batch_stats': jax.tree_util.tree_map(
                       np.asarray, v['batch_stats'])}


def shared_kpfusion_weights(variables, batch):
    """(port state_dict, JAX variables) holding the same weights: the
    variables' BatchNorm statistics perturbed, carried into the port, the
    backbones' statistics set to those of `batch`'s images there, and
    carried back by the JAX package's own converter."""
    from keypointfusion_tpu.utils.torch_convert import \
        convert_kpfusion_checkpoint
    from keypointfusion_torch.models.kpfusion import KPFusion
    from keypointfusion_torch.utils.weights import jax_kpfusion_to_state_dict
    v = {'params': variables['params'],
         'batch_stats': perturb_batch_stats(variables['batch_stats'], 1)}
    port = KPFusion()
    port.load_state_dict(jax_kpfusion_to_state_dict(v), strict=True)
    with cpu_reference_convs():
        calibrate_batch_norms(port.backbone_d,
                              torch.from_numpy(batch['depth']))
        calibrate_batch_norms(port.backbone_rgb,
                              torch.from_numpy(batch['rgb']))
    sd = {k: t.clone() for k, t in port.state_dict().items()}
    return sd, convert_kpfusion_checkpoint(sd)


def train_weights(seed=0):
    """(port state_dict, JAX variables) holding the same weights for the
    train tests: the port's KPFusion drawn from `seed`, its BatchNorm
    statistics perturbed, carried to JAX by the JAX package's converter
    and back by utils/weights.py:jax_kpfusion_to_state_dict."""
    from keypointfusion_tpu.utils.torch_convert import \
        convert_kpfusion_checkpoint
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.models.kpfusion import build_kpfusion
    from keypointfusion_torch.utils.weights import jax_kpfusion_to_state_dict
    port = build_kpfusion(Config(), device='cpu', seed=seed)
    v = jax.tree_util.tree_map(
        np.asarray, convert_kpfusion_checkpoint(port.state_dict()))
    v['batch_stats'] = perturb_batch_stats(v['batch_stats'], seed + 1)
    return jax_kpfusion_to_state_dict(v), v


def port_to_jax_tree(model: torch.nn.Module, grads: bool = False):
    """The port model's parameters (or their gradients, zeros where none
    reached) and BatchNorm statistics as JAX variables, numpy leaves."""
    from keypointfusion_tpu.utils.torch_convert import \
        convert_kpfusion_checkpoint
    sd = {k: v.detach().float() for k, v in model.state_dict().items()}
    if grads:
        for k, p in model.named_parameters():
            sd[k] = (torch.zeros_like(p) if p.grad is None
                     else p.grad.detach().float())
    return jax.tree_util.tree_map(np.asarray,
                                  convert_kpfusion_checkpoint(sd))


def leaf_errors(got, want):
    """{path: (max abs error, max |want|)} over the leaves of two trees
    of the same structure."""
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    out = {}
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        w = np.asarray(w, np.float64)
        g = np.asarray(flat_got[path], np.float64)
        assert g.shape == w.shape, (jax.tree_util.keystr(path), g.shape)
        out[jax.tree_util.keystr(path)] = (float(np.abs(g - w).max()),
                                           float(np.abs(w).max()))
    return out


def _leaves(tree: dict, pre: tuple = ()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), np.asarray(v)


def _fill(tree: dict, values: dict, pre: tuple = ()) -> dict:
    return {k: (_fill(v, values, pre + (k,)) if isinstance(v, dict)
                else values[pre + (k,)]) for k, v in tree.items()}


def carry_inverse(carry, template: dict):
    """The inverse of `carry` (one of utils/weights.py's
    jax_*_to_state_dict functions, with its other arguments bound) on
    trees shaped like `template`: a function of a state_dict (the port's
    tensors, or their gradients) that returns the JAX tree, numpy float32
    leaves. It carries `template`'s shape twice, once with each leaf
    holding its number and once with each element holding its position
    in its leaf (both exact in float32), and so learns where every
    element went; a JAX element that reaches no tensor raises. Every
    carry only moves, transposes and packs the JAX leaves, so this tells
    where each value went; the tests build a port module's JAX variables
    with it, without a JAX init."""
    paths = [(path, leaf.shape) for path, leaf in _leaves(template)]
    offsets = np.cumsum([0] + [int(np.prod(s)) for _, s in paths])
    ids = {path: np.full(shape, i, np.float32)
           for i, (path, shape) in enumerate(paths)}
    pos = {path: np.arange(int(np.prod(shape)), dtype=np.float32
                           ).reshape(shape) for path, shape in paths}
    by_id, by_pos = carry(_fill(template, ids)), carry(_fill(template, pos))
    keys = [k for k, t in by_id.items() if t.is_floating_point()]
    # for every JAX element (leaves in `paths` order, flattened), its
    # index in the state_dict's floating tensors flattened in `keys` order
    source = np.full(offsets[-1], -1, np.int64)
    start = 0
    for key in keys:
        leaf = by_id[key].numpy().reshape(-1).astype(np.int64)
        where = by_pos[key].numpy().reshape(-1).astype(np.int64)
        source[offsets[leaf] + where] = start + np.arange(leaf.size)
        start += leaf.size
    for i, (path, _) in enumerate(paths):
        if (source[offsets[i]:offsets[i + 1]] < 0).any():
            raise ValueError(f'{"/".join(path)}: not every element is '
                             f'carried')

    def inverse(sd: dict) -> dict:
        flat = np.concatenate([sd[k].detach().float().cpu().numpy()
                               .reshape(-1) for k in keys])
        return _fill(template, {
            path: flat[source[offsets[i]:offsets[i + 1]]].reshape(shape)
            for i, (path, shape) in enumerate(paths)})
    return inverse


def _two_pass_batch_norm(original):
    def batch_norm(input, running_mean, running_var, weight=None, bias=None,
                   training=False, momentum=0.1, eps=1e-5):
        if not training:
            return original(input, running_mean, running_var, weight, bias,
                            training, momentum, eps)
        dims = [d for d in range(input.dim()) if d != 1]
        shape = [1] * input.dim()
        shape[1] = input.shape[1]
        x = input.to(weight.dtype if weight is not None else input.dtype)
        mean = x.mean(dims)
        var = (x - mean.reshape(shape)).square().mean(dims)
        if running_mean is not None:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(
                    momentum * var * n / max(n - 1, 1))
        y = (x - mean.reshape(shape)) * torch.rsqrt(var + eps).reshape(shape)
        if weight is not None:
            y = y * weight.reshape(shape) + bias.reshape(shape)
        return y.to(input.dtype)
    return batch_norm


@contextlib.contextmanager
def cpu_reference_batch_norms():
    """Train-mode BatchNorm with its statistics taken in two passes of
    torch's cascade sums. torch's CPU batch_norm sums each channel's
    8192-32768 terms in one sequential pass: on the depth backbone's
    first layer its output lies 1.6e-4 from float64 statistics, where two
    passes lie 1.4e-6 (and XLA's CPU reduction 1.0e-4). As with
    cpu_reference_convs, the parity tests then compare the port at
    float32 rounding and not at that summation's."""
    import torch.nn.functional as F
    original = F.batch_norm
    F.batch_norm = _two_pass_batch_norm(original)
    try:
        yield
    finally:
        F.batch_norm = original


@contextlib.contextmanager
def jax_float64():
    """JAX with 64-bit types, and the JAX package computing in float64
    where it names jnp.float32 (its BatchNorm, the pixel sampler, the
    grouped features, the smooth-L1 loss, the codecs' masks) while the
    context lasts, through a `jnp` whose float32 is float64 in each of its
    loaded modules. ops/pairwise.py keeps float32: the squared distances
    that pick each point's pixels and each ball's members are float32 in
    the model, and in the port's float64 run too, so that both sides pick
    the same neighbours. The model itself takes dtype=jnp.float64."""
    proxy = types.SimpleNamespace(**vars(jnp))
    proxy.float32 = jnp.float64
    patched = [m for name, m in list(sys.modules.items())
               if name.startswith('keypointfusion_tpu.')
               and not name.endswith('.pairwise')
               and getattr(m, 'jnp', None) is jnp]
    for m in patched:
        m.jnp = proxy
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for m in patched:
            m.jnp = jnp


@torch.no_grad()
def set_layer_scales(module: torch.nn.Module, seed: int) -> None:
    """ConvNeXt's layer scales (gamma, 1e-6 at init, which leaves every
    block an identity) drawn from U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith('gamma'):
            p.copy_(torch.rand(p.shape, generator=g) + 0.5)


def backbone_net_weights(net: str, batch, seed: int = 0):
    """(port state_dict, JAX variables) of KPFusion `net` holding the same
    weights: the port's model from `seed`, its layer scales set, its
    backbones' BatchNorm statistics set to those of `batch`'s images, and
    carried to JAX by the JAX package's converter."""
    from keypointfusion_tpu.utils.torch_convert import \
        convert_kpfusion_checkpoint
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.models.kpfusion import build_kpfusion
    model = build_kpfusion(Config(net=net), device='cpu', seed=seed)
    set_layer_scales(model, seed + 1)
    with cpu_reference_convs():
        calibrate_batch_norms(model.backbone_d,
                              torch.from_numpy(batch['depth']))
        calibrate_batch_norms(model.backbone_rgb,
                              torch.from_numpy(batch['rgb']))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return sd, jax.tree_util.tree_map(
        np.asarray, convert_kpfusion_checkpoint(sd, net=net))


def kpfusion_outputs(net: str, variables, batch, dtype=jnp.float32):
    """JAX KPFusion `net`'s eval forward op by op (the plain path), its
    six results and two spatial weights as float64 numpy."""
    from keypointfusion_tpu.config import Config
    from keypointfusion_tpu.models.kpfusion import KPFusion
    from keypointfusion_tpu.training.train_step import frame_from_batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    res, sw = KPFusion(net=net, joint_num=21, dtype=dtype).apply(
        variables, jb['rgb'], jb['depth'], jb['pcl'],
        frame_from_batch(jb, Config()))
    return [np.asarray(t, np.float64) for t in res + sw]


def port_kpfusion_outputs(net: str, sd, batch, dtype=torch.float32):
    """The port's KPFusion `net` with `sd`, eval forward on the CPU (the
    kernels' plain versions, convolutions without oneDNN): its eight
    outputs as float64 numpy, and their dtypes."""
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.geometry.camera import CropFrame
    from keypointfusion_torch.models.kpfusion import build_kpfusion
    model = build_kpfusion(Config(net=net), device='cpu', dtype=dtype)
    model.load_state_dict(sd, strict=True)
    frame = CropFrame.from_batch(batch['cam_para'], batch['center'],
                                 batch['M'], batch['cube'])
    t = lambda k: torch.from_numpy(batch[k])
    with torch.no_grad(), cpu_reference_convs():
        res, sw = model(t('rgb'), t('depth'), t('pcl'), frame)
    out = res + sw
    return [x.double().numpy() for x in out], [x.dtype for x in out]


KPFUSION_OUTPUTS = ['img_offset', 'img_offset_rgb', 'b1_3d', 'b1_2d',
                    'b2_3d', 'b2_2d', 'spatial_weight_1', 'spatial_weight_2']


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


def check_kpfusion_float32(net, sd, variables, batch, want):
    """The port's float32 eval forward of `net` against JAX's op-by-op
    outputs `want`: each output within 1e-4 of its scale (at least 1),
    or, where JAX's own float32 run lies further than that from its
    float64 run (one jit of the whole model in float64, whose reordered
    sums move nothing at that limit), within twice that distance.
    Returns {output: (error / scale, JAX's own distance or None)}."""
    from keypointfusion_tpu.config import Config
    from keypointfusion_tpu.models.kpfusion import KPFusion
    from keypointfusion_tpu.training.train_step import frame_from_batch
    got, dtypes = port_kpfusion_outputs(net, sd, batch)
    assert dtypes == [torch.float32] * 8
    measured = {n: (_err(g, w) / _scale(w), None)
                for n, g, w in zip(KPFUSION_OUTPUTS, got, want)}
    over = [i for i, n in enumerate(KPFUSION_OUTPUTS)
            if measured[n][0] > 1e-4]
    if over:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with jax_float64():
            v64 = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables)
            model = KPFusion(net=net, joint_num=21, dtype=jnp.float64)
            res, sw = jax.jit(model.apply)(
                v64, jb['rgb'], jb['depth'], jb['pcl'],
                frame_from_batch(jb, Config()))
            want64 = [np.asarray(t, np.float64) for t in res + sw]
        for i in over:
            name = KPFUSION_OUTPUTS[i]
            jax_own = _err(want[i], want64[i])
            measured[name] = (measured[name][0], jax_own)
            assert _err(got[i], want[i]) <= 2 * jax_own, (name, measured)
    return measured


def check_kpfusion_bfloat16(net, sd, variables, batch, want):
    """The port's bfloat16 eval forward of `net` against JAX's float32
    outputs `want`, within the bfloat16 slice's budget: per output,
    max|port_bf16 - jax_f32| <= 2 max|jax_bf16 - jax_f32| + 2^-8 of its
    scale, JAX's bfloat16 forward running op by op. Returns {output:
    (port gap, JAX gap)}."""
    want_bf = kpfusion_outputs(net, variables, batch, jnp.bfloat16)
    got, dtypes = port_kpfusion_outputs(net, sd, batch, torch.bfloat16)
    assert dtypes == [torch.bfloat16] * 8
    gaps = {}
    for name, g, w, wbf in zip(KPFUSION_OUTPUTS, got, want, want_bf):
        gaps[name] = (_err(g, w), _err(wbf, w))
        assert gaps[name][0] <= 2 * gaps[name][1] + 2 ** -8 * _scale(w), \
            (name, gaps)
    return gaps
