"""Port parity of the whole serving slice: the KPFusion-resnet-18 eval
forward, the engine's per-batch pipeline (on-device preprocessing, forward
and packing), the streaming contract, the weight carry-over and the
package's import boundary.

Inputs are synthetic_batch(batch_size=2, point_num=256, seed=42), the
inputs of tests/test_numeric_regression.py, at the model's own widths. The
JAX variables come from one jitted init; BatchNorm running statistics are
perturbed, and the backbones' are then set to their input's statistics in
the port (tests/torch_port_helpers.py:calibrate_batch_norms), so that
activations have the scale of a trained network. Both sides then run the
same weights: JAX gets them back from the port's state_dict through the
JAX package's own converter.

Tolerances: 1e-4 absolute on every model output (float32 throughout;
convolutions, matmuls and softmaxes sum in another order in XLA and in
PyTorch). The packed engine output holds world millimetres, which carry
the normalized-space tolerance times cube/2 = 125 mm.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.data.synthetic import synthetic_batch
from keypointfusion_tpu.serving import StreamingEngine as JEngine
from keypointfusion_tpu.training.train_step import frame_from_batch
from keypointfusion_tpu.utils.torch_convert import \
    convert_kpfusion_checkpoint

import keypointfusion_torch
from keypointfusion_torch.config import Config
from keypointfusion_torch.data.synthetic import synthetic_frames
from keypointfusion_torch.demo import ModelRGBD
from keypointfusion_torch.geometry.camera import CropFrame
from keypointfusion_torch.mano.assets import synthetic_mano_model
from keypointfusion_torch.mano.mano_head import ManoRegHead
from keypointfusion_torch.mano.manolayer import ManoLayer
from keypointfusion_torch.models.kpfusion import KPFusion, build_kpfusion
from keypointfusion_torch.serving import StreamingEngine
from keypointfusion_torch.utils.weights import jax_kpfusion_to_state_dict

from tests.torch_port_helpers import (
    cpu_reference_convs, init_jax_kpfusion, perturb_batch_stats,
    shared_kpfusion_weights,
)

torch.set_num_threads(2)
ATOL = 1e-4
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def batch():
    return synthetic_batch(batch_size=2, point_num=256, seed=42)


@pytest.fixture(scope='module')
def jax_init(batch):
    """The JAX model and its freshly initialized variables (numpy)."""
    return init_jax_kpfusion(batch)


@pytest.fixture(scope='module')
def shared_weights(batch, jax_init):
    """(port state_dict, JAX variables) holding the same weights."""
    return shared_kpfusion_weights(jax_init[1], batch)


def test_weight_carry_over_round_trip(jax_init):
    """JAX init -> port state_dict -> strict load -> the JAX package's
    converter gives back every JAX leaf, bit for bit."""
    _, v = jax_init
    v = {'params': v['params'],
         'batch_stats': perturb_batch_stats(v['batch_stats'], seed=1)}
    sd = jax_kpfusion_to_state_dict(v)
    port = KPFusion()
    port.load_state_dict(sd, strict=True)
    back = convert_kpfusion_checkpoint(port.state_dict())
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_kpfusion_forward_matches_jax(batch, jax_init, shared_weights):
    """All six results and both spatial weights of the eval forward.

    JAX runs op by op here, not under one jit of the whole model: on this
    batch JAX's own jitted run differs from its op-by-op run by 4.1e-4 in
    b1_3d and 1.4e-4 in spatial_weight_1, far more than rounding, while
    the port is within 1.24e-6 of the op-by-op run on the six results and
    6.44e-5 on the spatial weights (whose 1x1 convolution reads features
    of up to ~40). Measured by tests/torch_port_parity_report.py."""
    model, _ = jax_init
    sd, variables = shared_weights
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_res, want_sw = model.apply(
        variables, jb['rgb'], jb['depth'], jb['pcl'],
        frame_from_batch(jb, JConfig()))
    port = build_kpfusion(Config(), device='cpu')
    port.load_state_dict(sd, strict=True)
    frame = CropFrame.from_batch(batch['cam_para'], batch['center'],
                                 batch['M'], batch['cube'])
    t = lambda k: torch.from_numpy(batch[k])
    with torch.no_grad(), cpu_reference_convs():
        got_res, got_sw = port(t('rgb'), t('depth'), t('pcl'), frame)
    assert port.use_kernels        # the wrappers' CPU branch
    assert len(got_res) == 6 and len(got_sw) == 2
    for i, (g, w) in enumerate(zip(got_res + got_sw, want_res + want_sw)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=f'output {i}')


def _full_frames(bs, seed=0):
    """120x160 frames (tests/test_serving.py's size), made as bench.py
    makes them."""
    return synthetic_frames(bs, 120, 160, np.random.RandomState(seed))


def test_engine_pipeline_matches_jax(shared_weights):
    """JAX device_preprocess + forward + packing (the JAX engine's own
    per-batch program) against the port engine's, with the JAX key's
    uniform point draws injected into the port."""
    sd, variables = shared_weights
    frames = _full_frames(2)
    frames['centers'][1] = (76, 64, 620)
    key = jax.random.PRNGKey(3)
    jeng = JEngine(JConfig(point_num=256), variables, batch_size=2,
                   img_hw=(120, 160), dtype=jnp.float32)
    want = np.asarray(jeng._pipeline(
        variables, *[jnp.asarray(frames[k]) for k in
                     ('depth', 'rgb', 'centers', 'cube', 'cam')], key))
    uniform = torch.from_numpy(np.array(jax.random.uniform(key, (2, 256))))
    eng = StreamingEngine(Config(point_num=256), state_dict=sd,
                          batch_size=2, img_hw=(120, 160),
                          dtype=torch.float32, device='cpu')
    with cpu_reference_convs():
        got = eng.pipeline(
            torch.from_numpy(frames['depth'].astype(np.int32)),
            *[torch.from_numpy(frames[k]) for k in
              ('rgb', 'centers', 'cube', 'cam')], uniform=uniform).numpy()
    assert got.shape == want.shape == (2, 2 * 3 * 21 + 9)
    np.testing.assert_allclose(got[:, :63], want[:, :63], rtol=0,
                               atol=ATOL * 125.0)         # world mm
    np.testing.assert_allclose(got[:, 63:126], want[:, 63:126], rtol=0,
                               atol=ATOL)                 # normalized uvd
    np.testing.assert_allclose(got[:, 126:], want[:, 126:], rtol=1e-6,
                               atol=1e-6)                 # crop matrix M


def test_streaming_engine_contract():
    """process_stream yields one result per batch, in submission order,
    with the shapes of the JAX engine and finite joints."""
    eng = StreamingEngine(Config(point_num=128), batch_size=2,
                          img_hw=(120, 160), dtype=torch.float32,
                          device='cpu')
    batches = []
    for i in range(3):
        f = _full_frames(2, seed=i)
        f['centers'][:, 0] += 4 * i       # a distinct crop per batch
        batches.append(f)
    outs = list(eng.process_stream(iter(batches), depth=2))
    assert len(outs) == 3
    for i, o in enumerate(outs):
        assert o['joint_xyz_mm'].shape == (2, 21, 3)
        assert o['joint_uvd'].shape == (2, 21, 3)
        assert o['M'].shape == (2, 3, 3)
        assert np.isfinite(o['joint_xyz_mm']).all()
        assert np.isfinite(o['joint_uvd']).all()
        # M's translation follows the batch's crop centre: in order
        want_tx = outs[0]['M'][:, 0, 2] - 4 * i * outs[0]['M'][:, 0, 0]
        np.testing.assert_allclose(o['M'][:, 0, 2], want_tx, atol=1e-3)
    with pytest.raises(ValueError, match='uint16'):
        eng.submit(batches[0]['depth'].astype(np.float32),
                   *[batches[0][k] for k in ('rgb', 'centers', 'cube',
                                             'cam')])


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    """Without a CUDA device, the entry points raise unless the caller
    asks for the CPU by name; train mode's dropout draws only from a
    generator the caller passes, never from the global RNG."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_kpfusion(Config())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        StreamingEngine(Config(point_num=128), batch_size=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ModelRGBD(Config(), (600.0, 600.0, 320.0, 240.0))
    asset = synthetic_mano_model()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ManoLayer(asset)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ManoRegHead(asset, feature_size=16, neurons=(8,))
    assert ManoLayer(asset, device='cpu').v_template.device.type == 'cpu'
    model = build_kpfusion(Config(), device='cpu')
    assert not model.training
    with pytest.raises(ValueError, match='Generator'):
        model.block1.init_TR.train()(torch.zeros(1, 21, 128))
    with pytest.raises(ValueError, match='Generator'):
        model.block1.crossTR.train()(torch.zeros(1, 21, 128),
                                     torch.zeros(1, 21, 128))


FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'keypointfusion_tpu', 'cv2',
             'PIL', 'imageio')


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX
    package, nor an image library (cv2, PIL, imageio: the card's machine
    has none), and no source of the port, of its card scripts or of the
    test cases chip_smoke.py loads imports them. The ranks that
    parallel/dryrun.py spawns check their own modules
    (tests/test_torch_port_parallel.py:test_dryrun_two_ranks)."""
    names = [m.name for m in pkgutil.walk_packages(
        keypointfusion_torch.__path__, 'keypointfusion_torch.')]
    assert {'keypointfusion_torch.serving',
            'keypointfusion_torch.training.trainer',
            'keypointfusion_torch.training.metrics',
            'keypointfusion_torch.data.pipeline',
            'keypointfusion_torch.utils.pretrain',
            'keypointfusion_torch.utils.provenance',
            'keypointfusion_torch.data.image_io',
            'keypointfusion_torch.data.cv_ops',
            'keypointfusion_torch.data.preprocessing',
            'keypointfusion_torch.data.datasets',
            'keypointfusion_torch.train',
            'keypointfusion_torch.demo',
            'keypointfusion_torch.utils.vis',
            'keypointfusion_torch.utils.raster',
            'keypointfusion_torch.models.convnext',
            'keypointfusion_torch.ops.codecs_extra',
            'keypointfusion_torch.geometry.sampling',
            'keypointfusion_torch.mano.assets',
            'keypointfusion_torch.mano.manolayer',
            'keypointfusion_torch.mano.mano_head',
            'keypointfusion_torch.utils.rotations',
            'keypointfusion_torch.utils.graph',
            'keypointfusion_torch.models.legacy',
            'keypointfusion_torch.models.rgbd_fusion',
            'keypointfusion_torch.models.transformer_extra',
            'keypointfusion_torch.data.patch_warp',
            'keypointfusion_torch.data.occlusion',
            'keypointfusion_torch.data.extra_datasets',
            'keypointfusion_torch.parallel.mesh',
            'keypointfusion_torch.parallel.dryrun',
            'keypointfusion_torch.data.native',
            'keypointfusion_torch.utils.profiling'} <= set(names)
    code = ('import sys\n'
            f'for name in {names!r}:\n'
            '    __import__(name)\n'
            f'bad = [m for m in sys.modules if m.split(".")[0] in '
            f'{FORBIDDEN!r}]\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=300)
    sources = sorted((REPO / 'keypointfusion_torch').rglob('*.py'))
    sources += [REPO / 'chip_smoke.py',
                *sorted((REPO / 'scripts').glob('torch_*.py')),
                # the numpy-only cases that chip_smoke.py loads on the card
                REPO / 'tests' / 'torch_port_extra_cases.py',
                REPO / 'tests' / 'torch_port_vis_cases.py']
    for path in sources:
        for mod in _imported_modules(path):
            assert mod.split('.')[0] not in FORBIDDEN, (path, mod)
