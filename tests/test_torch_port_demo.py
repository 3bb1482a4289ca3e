"""Port parity of the RGB-D demo (keypointfusion_torch/demo.py) against
the JAX package's ModelRGBD (keypointfusion_tpu/demo.py) and root
demo_RGBD.py's CLI.

Both run KPFusion-resnet-18 at full width (1024 points) on the same
weights: the port's model from seed 0, its backbones' BatchNorm
statistics set to the test batch's (tests/torch_port_helpers.py:
shared_kpfusion_weights' recipe), carried to JAX by the JAX package's
converter. JAX's demo jits its forward; a jit of the whole model lies
4e-4 from its op-by-op run (ROADMAP.md §3), so the JAX instance runs
`_forward_impl` op by op. Frames: the JAX demo's synthetic smoke frame
(demo.smoke_frame) and the first test frame of the committed
DexYCB-layout fixture, read by the port's imread, with a bbox around its
annotated joints (chip_smoke.py:demo_frame). Tolerances:
  * the crops, crop transforms and centres: bit for bit (the same numpy
    steps);
  * the normalized joints (stage 2's uvd, which the overlays draw, and
    the last stage's world joints, in cube units): 1e-4;
  * the port's overlays drawn from JAX's joints: JAX's bit for bit.
"""

import argparse

import numpy as np
import pytest
import torch

from keypointfusion_tpu import demo as jdemo
from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.utils.torch_convert import \
    convert_kpfusion_checkpoint

import demo_RGBD
from chip_smoke import demo_frame
from keypointfusion_torch import demo
from keypointfusion_torch.config import Config
from keypointfusion_torch.data.image_io import imread
from keypointfusion_torch.data.synthetic import synthetic_batch
from keypointfusion_torch.models.kpfusion import build_kpfusion
from keypointfusion_torch.training.train_step import create_train_state
from keypointfusion_torch.training.trainer import Checkpointer

from tests.torch_port_helpers import calibrate_batch_norms, cpu_reference_convs

torch.set_num_threads(2)
HALF_CUBE_M = 0.125


@pytest.fixture(scope='module')
def weights():
    """(port state_dict, JAX variables) of KPFusion-resnet-18."""
    model = build_kpfusion(Config(), device='cpu', seed=0)
    batch = synthetic_batch(batch_size=2, point_num=256, seed=42)
    with cpu_reference_convs():
        calibrate_batch_norms(model.backbone_d,
                              torch.from_numpy(batch['depth']))
        calibrate_batch_norms(model.backbone_rgb,
                              torch.from_numpy(batch['rgb']))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return sd, convert_kpfusion_checkpoint(sd)


def recorded(module, monkeypatch):
    """Record the (image, joints) that module's demo passes to
    draw_2d_pose and draw_2d_pose_rgb, by frame."""
    calls = []

    def wrap(name):
        real = getattr(module, name)

        def wrapped(img, joints, dataset='dexycb'):
            if name == 'draw_2d_pose':
                calls.append({})
            calls[-1][name] = (np.array(img), np.array(joints))
            return real(img, joints, dataset)
        monkeypatch.setattr(module, name, wrapped)
    wrap('draw_2d_pose')
    wrap('draw_2d_pose_rgb')
    return calls


@pytest.fixture(scope='module')
def runs(weights):
    """Both demos on the smoke frame and the fixture frame: (JAX meta,
    JAX outputs, JAX's overlay inputs), the same for the port."""
    sd, variables = weights
    frames = [demo.smoke_frame(), demo_frame(0)]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jcalls, pcalls = recorded(jdemo, mp), recorded(demo, mp)
        for side in ('jax', 'port'):
            results = []
            for inp, cam in frames:
                if side == 'jax':
                    model = jdemo.ModelRGBD(JConfig(phase='test'), cam,
                                            variables=variables)
                    model._forward = model._forward_impl
                    results.append(model.estimate_pose_rgbd([inp]))
                else:
                    model = demo.ModelRGBD(Config(phase='test'), cam,
                                           state_dict=sd, device='cpu')
                    with cpu_reference_convs():
                        results.append(model.estimate_pose_rgbd([inp]))
            out[side] = results
    out['jax_calls'], out['port_calls'] = jcalls, pcalls
    return out


def test_crops_match_jax(runs):
    for (jm, _), (pm, _) in zip(runs['jax'], runs['port']):
        for key in ('crop_img', 'crop_img_d', 'img2bb_trans',
                    'bb2img_trans', 'center'):
            assert np.array_equal(pm[0][key], jm[0][key]), key
            assert pm[0][key].dtype == jm[0][key].dtype, key


def test_joints_match_jax(runs):
    """Stage 2's normalized uvd (the overlays' joints) and the world
    joints in cube units, within 1e-4; the output dicts' keys, shapes and
    meshes as JAX's."""
    worst = [0.0, 0.0]
    for (_, jo), (_, po), jc, pc in zip(runs['jax'], runs['port'],
                                        runs['jax_calls'],
                                        runs['port_calls']):
        assert po[0].keys() == jo[0].keys()
        assert po[0]['mesh_uvd'] is None and po[0]['mesh_xyz'] is None
        assert po[0]['joint_uvd'].shape == jo[0]['joint_uvd'].shape \
            == (21, 3)
        worst[0] = max(worst[0], float(np.abs(
            pc['draw_2d_pose'][1] - jc['draw_2d_pose'][1]).max()))
        worst[1] = max(worst[1], float(np.abs(
            po[0]['joint_xyz'] - jo[0]['joint_xyz']).max()) / HALF_CUBE_M)
    print('normalized uvd, xyz', worst)
    assert max(worst) <= 1e-4


def test_overlays_from_jax_joints_match_jax(runs):
    """The port's vis on the crops and joints JAX drew with gives JAX's
    pose_d and pose_rgb bit for bit."""
    for (jm, _), calls in zip(runs['jax'], runs['jax_calls']):
        for name, key in (('draw_2d_pose', 'pose_d'),
                          ('draw_2d_pose_rgb', 'pose_rgb')):
            got = getattr(demo, name)(*calls[name])
            assert got.dtype == np.uint8
            assert np.array_equal(got, jm[0][key]), key
    for (pm, _) in runs['port']:
        assert pm[0]['pose_d'].shape == pm[0]['pose_rgb'].shape \
            == (128, 128, 3)


def test_loaded_weights_take_effect(weights, tmp_path):
    """load_state_dict after a first call changes the next answer to the
    new weights' (the cached casts and K1 packs follow the parameters),
    and cfg.load_model loads a reference-named .pth and a port trainer
    checkpoint to the same weights."""
    sd, _ = weights
    inp, cam = demo.smoke_frame()
    model = demo.ModelRGBD(Config(phase='test'), cam, state_dict=sd,
                           device='cpu')

    def answer(m):
        m.np_rng = np.random.RandomState(3)
        return m.estimate_pose_rgbd([inp])[1][0]['joint_xyz']
    first = answer(model)
    other = build_kpfusion(Config(), device='cpu', seed=5).state_dict()
    model.model.load_state_dict(other)
    swapped = answer(model)
    fresh = answer(demo.ModelRGBD(Config(phase='test'), cam,
                                  state_dict=other, device='cpu'))
    assert not np.allclose(first, swapped)
    assert np.array_equal(swapped, fresh)

    ref = str(tmp_path / 'released.pth')
    torch.save({'model': {f'module.{k}': v for k, v in sd.items()}}, ref)
    state = create_train_state(Config(), synthetic_batch(2, point_num=32),
                               device='cpu', seed=1)
    state.model.load_state_dict(sd)
    Checkpointer(str(tmp_path)).save('best', state, epoch=3)
    for path in (ref, str(tmp_path / 'best.pth')):
        loaded = demo.ModelRGBD(Config(phase='test', load_model=path), cam,
                                device='cpu')
        for k, v in loaded.model.state_dict().items():
            assert torch.equal(v, sd[k]), (path, k)


def _parser_of(main, monkeypatch):
    """The ArgumentParser that `main` builds, stopped at parse_args."""
    seen = []

    class Stop(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        seen.append(self)
        raise Stop
    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', parse_args)
    with pytest.raises(Stop):
        main()
    monkeypatch.undo()
    return seen[0]


def test_cli_flags_match_demo_rgbd(monkeypatch):
    def actions(parser):
        return [(a.option_strings, a.dest, a.default, a.nargs, a.type,
                 a.help) for a in parser._actions]
    assert actions(demo.build_parser()) == actions(
        _parser_of(demo_RGBD.main, monkeypatch))


def test_cli_writes_the_four_pngs(tmp_path):
    """main(device='cpu') on the synthetic fallback frame writes the four
    PNGs, which read back as the meta arrays."""
    meta, result = demo.main(['--rgb', str(tmp_path / 'missing.png'),
                              '--out_dir', str(tmp_path / 'out')],
                             device='cpu')
    assert result[0]['joint_xyz'].shape == (21, 3)
    assert np.isfinite(result[0]['joint_xyz']).all()
    for key, name in demo.OUTPUT_FILES.items():
        path = str(tmp_path / 'out' / name)
        want = meta[0][key]
        got = imread(path, anydepth=True) if want.ndim == 2 \
            else imread(path)
        assert np.array_equal(got, want), name
