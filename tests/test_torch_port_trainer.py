"""Port parity of the trainer (keypointfusion_torch/training/trainer.py)
and its contract.

JAX against the port, on one `.pth`: the port's KPFusion from seed 0, its
backbones' BatchNorm statistics set to a test batch's (so that eval
activations stay of unit scale), saved as {'model': state_dict}. The JAX
Trainer loads it through its converter, the port's Trainer as it is
(load_model). Both run at batch 4 and 128 points on a test set of 6
synthetic samples (a full batch, then 2 padded to 4); the port's
convolutions run without oneDNN (tests/torch_port_helpers.py:
cpu_reference_convs). The JAX Trainer's eval step runs its model op by
op: a jit of the whole model lies 2.3e-3 from JAX's own op-by-op apply on
b1_3d on this batch (the port 1.3e-6), as ROADMAP.md §3 records for the
train forward.
  * test(): each stage's error and Procrustes-aligned error of every
    real sample and joint (recorded from the metric calls of each
    trainer), within 1e-4 of the half cube (0.0125 mm): the float32
    forward agrees to 1e-4 of scale; the printed [mean_Error] and
    [PA_mean_Error] lines within that plus one unit of their 3 decimals;
    the test_{i}.txt dumps value for value within 0.0125 mm plus one unit
    of their 3 decimals; id.txt line for line.
  * evaluation(): pred.json's joints within 1.25e-5 m (the same limit in
    metres), its meshes equal.
The port alone, on one CPU thread (torch's multithreaded CPU reductions
are not deterministic), at batch 2 and 128 points, exact: train() against
make_train_step driven by hand with the loader's batch order and the
trainer's generators; steps_per_dispatch=2 against single steps; a run
resumed at epoch 1 against the straight run; the 'auto' plateau through
a checkpoint. Then the warm starts and the guards. Measured values are
printed.
"""

import contextlib
import copy
import dataclasses
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.training import trainer as jtrainer
from keypointfusion_tpu.training.train_step import \
    frame_from_batch as j_frame

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.pipeline import BatchLoader
from keypointfusion_torch.data.synthetic import synthetic_dataset
from keypointfusion_torch.models.kpfusion import build_kpfusion
from keypointfusion_torch.models.resnet import ResNet
from keypointfusion_torch.training import trainer as ptrainer
from keypointfusion_torch.training.train_step import (
    batch_to_device, create_train_state, make_train_step,
)
from keypointfusion_torch.training.trainer import Trainer, epoch_seed
from keypointfusion_torch.utils.provenance import snapshot_sources
from keypointfusion_torch.utils.weights import (
    load_torch_checkpoint, merge_partial,
)

from tests.torch_port_helpers import calibrate_batch_norms, cpu_reference_convs

HALF_CUBE_MM = 125.0
MM_TOL = 1e-4 * HALF_CUBE_MM
PRINT_UNIT = 1e-3


@dataclasses.dataclass(frozen=True)
class TinyConfig(Config):
    """A Config whose epoch budget is a field (max_epoch is otherwise the
    dataset's), as tests/test_resume_equivalence.py sets it."""
    epochs: int = 2

    @property
    def max_epoch(self) -> int:
        return self.epochs


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def test_set():
    return synthetic_dataset(6, point_num=128, seed=100)


@pytest.fixture(scope='module')
def pth(tmp_path_factory, test_set):
    model = build_kpfusion(Config(), device='cpu', seed=0)
    batch = {k: np.stack([s[k] for s in test_set]) for k in test_set[0]}
    with cpu_reference_convs():
        calibrate_batch_norms(model.backbone_d,
                              torch.from_numpy(batch['depth']))
        calibrate_batch_norms(model.backbone_rgb,
                              torch.from_numpy(batch['rgb']))
    path = str(tmp_path_factory.mktemp('weights') / 'kpfusion.pth')
    torch.save({'model': model.state_dict()}, path)
    return path


def record(module, name, calls, monkeypatch):
    """Wrap module.name so that each call's result lands in calls."""
    real = getattr(module, name)

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        calls.append(np.asarray(out))
        return out
    monkeypatch.setattr(module, name, wrapped)


class ImageRecorder:
    """A tensorboard writer that keeps what add_image is given."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, img, global_step=None):
        self.images.append((tag, global_step, np.asarray(img)))

    def add_scalar(self, tag, value, global_step=None):
        pass


def run_test_and_evaluation(trainer, jax_side):
    """test() and evaluation() of one trainer: the printed text, each
    stage's per-sample errors and PA errors [stage][sample, joint], the
    dump files, pred.json and the images evaluation() logs to a
    tensorboard writer."""
    calls = {'err': [], 'pa': []}
    out = io.StringIO()
    module = jtrainer if jax_side else ptrainer
    with pytest.MonkeyPatch.context() as mp:
        record(module, 'xyz_to_error_mm', calls['err'], mp)
        record(module, 'pa_error_mm', calls['pa'], mp)
        with contextlib.redirect_stdout(out):
            if jax_side:
                trainer.test(epoch=0)
            else:
                with cpu_reference_convs():
                    trainer.test(epoch=0)
    n_stage, n_real = 6, (4, 2)
    per_stage = {}
    for key, arrays in calls.items():
        if jax_side:        # one call per batch and stage: [B, J]
            arrays = [np.stack(arrays[i * n_stage:(i + 1) * n_stage])
                      for i in range(len(n_real))]
        per_stage[key] = np.concatenate(
            [a[:, :n] for a, n in zip(arrays, n_real)], axis=1)
    files = {name: open(os.path.join(trainer.model_dir, name)).read()
             for name in [f'test_{i}.txt' for i in range(n_stage)]
             + ['id.txt']}
    trainer.logger.tb = ImageRecorder()
    with cpu_reference_convs():
        pred = json.load(open(trainer.evaluation()))
    return out.getvalue(), per_stage, files, pred, trainer.logger.tb.images


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory, pth, test_set):
    cfg = JConfig(batch_size=4, point_num=128, load_model=pth, pretrain='',
                  phase='test')
    trainer = jtrainer.Trainer(
        cfg, test_data=test_set, use_mesh=False,
        model_dir=str(tmp_path_factory.mktemp('jax_trainer')))

    def eval_step(state, batch):         # make_eval_step's, without jit
        return state.model.apply(
            {'params': state.params, 'batch_stats': state.batch_stats},
            batch['rgb'], batch['depth'], batch['pcl'], j_frame(batch, cfg),
            cfg.feature_para[0], False)
    trainer.eval_step = eval_step
    return run_test_and_evaluation(trainer, jax_side=True)


@pytest.fixture(scope='module')
def port_run(tmp_path_factory, pth, test_set):
    cfg = Config(batch_size=4, point_num=128, load_model=pth, pretrain='',
                 phase='test')
    trainer = Trainer(cfg, test_data=test_set, device='cpu',
                      model_dir=str(tmp_path_factory.mktemp('port_trainer')))
    return run_test_and_evaluation(trainer, jax_side=False)


def printed(text, label):
    return np.array([float(x) for x in re.findall(
        rf'\[{label} ([\d.]+)\]', text)])


# ----------------------------------------------------- JAX against port --

def test_test_matches_jax(jax_run, port_run):
    """Per-stage errors and PA errors of every sample and joint, the
    printed means and AUCs, the dumps and id.txt (module docstring)."""
    j_text, j_stage, j_files, _, _ = jax_run
    p_text, p_stage, p_files, _, _ = port_run
    measured = {}
    for key in ('err', 'pa'):
        assert p_stage[key].shape == j_stage[key].shape == (6, 6, 21)
        measured[key] = float(np.abs(p_stage[key] - j_stage[key]).max())
        assert measured[key] <= MM_TOL, (key, measured[key])
    for label in ('mean_Error', 'PA_mean_Error'):
        got, want = printed(p_text, label), printed(j_text, label)
        assert got.shape == want.shape == (6,)
        assert np.abs(got - want).max() <= MM_TOL + PRINT_UNIT, label
    aucs = [re.findall(r'Area under curve.*: ([\d.]+)', t)
            for t in (p_text, j_text)]
    assert len(aucs[0]) == 4
    assert np.abs(np.array(aucs[0], float)
                  - np.array(aucs[1], float)).max() <= PRINT_UNIT
    assert p_files['id.txt'] == j_files['id.txt'] == ''.join(
        f'{i}\n' for i in range(6))
    worst = 0.0
    for i in range(6):
        got = np.loadtxt(io.StringIO(p_files[f'test_{i}.txt']))
        want = np.loadtxt(io.StringIO(j_files[f'test_{i}.txt']))
        assert got.shape == want.shape == (6, 63)
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= MM_TOL + PRINT_UNIT
    print('measured (mm):', measured, 'dumps', worst)


def test_evaluation_matches_jax(jax_run, port_run):
    """pred.json: [joints [6, 21, 3], meshes [6, 778, 3]] in metres,
    the joints within 1.25e-5 m, the meshes zero on both sides."""
    want, got = jax_run[3], port_run[3]
    gj, gm = (np.array(x) for x in got)
    wj, wm = (np.array(x) for x in want)
    assert gj.shape == wj.shape == (6, 21, 3)
    assert gm.shape == wm.shape == (6, 778, 3)
    assert not gm.any() and not wm.any()
    err = float(np.abs(gj - wj).max())
    assert err <= MM_TOL / 1000, err
    print('measured (m):', err)


def test_evaluation_logs_eval_images_as_jax(jax_run, port_run):
    """With a tensorboard writer, evaluation() logs 'eval_img' (BGR) and
    'eval_img_rgb' (RGB), CHW in [0, 1], the first sample of each batch
    with its last-stage skeleton, as the JAX trainer does: equal to
    JAX's bit for bit."""
    want, got = jax_run[4], port_run[4]
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want] == [
        ('eval_img', 0), ('eval_img_rgb', 0), ('eval_img', 1),
        ('eval_img_rgb', 1)]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert g.shape == w.shape == (3, 128, 128)
        assert np.array_equal(g, w)


# ------------------------------------------------------------ the loop --

def train_cfg(**kw):
    base = dict(batch_size=2, point_num=128, epochs=2, seed=3, pretrain='')
    base.update(kw)
    return TinyConfig(**base)


def state_of(state):
    """Everything a run carries: weights and statistics, the optimizer's
    state, step and lr_scale."""
    return {'model': {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            'optimizer': copy.deepcopy(state.optimizer.state_dict()),
            'step': state.step, 'lr_scale': state.lr_scale}


def assert_states_equal(a, b):
    assert a['step'] == b['step'] and a['lr_scale'] == b['lr_scale']
    assert a['model'].keys() == b['model'].keys()
    for k, v in a['model'].items():
        assert torch.equal(v, b['model'][k]), k
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(v, sb[i][k]), (i, k)


@pytest.fixture(scope='module')
def train_set():
    return synthetic_dataset(4, point_num=128, seed=0)


@pytest.fixture(scope='module')
def straight(tmp_path_factory, train_set):
    """Two epochs (2 steps each) in one Trainer, no test split (the
    epoch's last loss is its test error)."""
    with one_thread():
        t = Trainer(train_cfg(), train_set, device='cpu',
                    model_dir=str(tmp_path_factory.mktemp('straight')))
        start = state_of(t.state)
        t.train()
    return start, state_of(t.state), t


def test_train_matches_steps_driven_by_hand(straight, train_set):
    """train() is make_train_step over BatchLoader(seed + epoch) batches
    with the epoch's generator: the same weights, statistics, optimizer
    state and step, bit for bit."""
    start, end, trainer = straight
    cfg = train_cfg()
    with one_thread():
        state = create_train_state(cfg, batch_to_device(train_set[0], 'cpu'),
                                   device='cpu', seed=cfg.seed,
                                   steps_per_epoch=2)
        assert all(torch.equal(v, start['model'][k])
                   for k, v in state.model.state_dict().items())
        step = make_train_step(cfg)
        for epoch in range(2):
            gen = torch.Generator().manual_seed(epoch_seed(cfg.seed + 1,
                                                           epoch))
            for b in BatchLoader(train_set, 2, shuffle=True,
                                 seed=cfg.seed + epoch):
                state, _ = step(state, batch_to_device(b, 'cpu'), gen, epoch)
    assert state.step == 4
    assert_states_equal(state_of(state), end)
    assert os.path.isfile(trainer.ckpt.path('best'))
    assert os.path.isfile(trainer.ckpt.path('latest'))
    lines = open(os.path.join(trainer.model_dir, 'runs',
                              'metrics.jsonl')).read().splitlines()
    assert len(lines) == 2 and 'loss' in json.loads(lines[0])


def test_steps_per_dispatch_gives_single_steps(tmp_path):
    """An epoch of 3 steps with steps_per_dispatch=2 (one scan of 2, one
    single step) equals 3 single steps, bit for bit."""
    data = synthetic_dataset(6, point_num=128, seed=20)
    runs = []
    with one_thread():
        for g in (1, 2):
            t = Trainer(train_cfg(epochs=1, steps_per_dispatch=g), data,
                        device='cpu', model_dir=str(tmp_path / f'g{g}'))
            assert (t.train_scan is None) == (g == 1)
            t.train()
            runs.append(state_of(t.state))
    assert runs[0]['step'] == 3
    assert_states_equal(*runs)


def test_resume_equals_straight_run(straight, train_set, tmp_path):
    """One epoch, then a new Trainer with resume=True and its second
    epoch: weights, statistics, optimizer state, step, lr_scale, best
    error and plateau count equal the straight run's, bit for bit."""
    _, end, full = straight
    with one_thread():
        first = Trainer(train_cfg(epochs=1), train_set, device='cpu',
                        model_dir=str(tmp_path))
        first.train()
        resumed = Trainer(train_cfg(resume=True), train_set, device='cpu',
                          model_dir=str(tmp_path))
        assert resumed.start_epoch == 1 and resumed.state.step == 2
        assert resumed.state.schedule == first.state.schedule
        resumed.train()
    assert_states_equal(state_of(resumed.state), end)
    assert (resumed.min_error, resumed._plateau) \
        == (full.min_error, full._plateau)


def test_auto_plateau_fires_and_persists(train_set, tmp_path):
    """scheduler='auto' (tests/test_resume_equivalence.py:215): with
    worsening test errors the decay fires inside train() after 2 epochs
    without improvement, survives a resume into a new Trainer, and the
    decayed scale shrinks the applied update."""
    data = train_set[:2]
    cfg = train_cfg(epochs=3, scheduler='auto')
    t = Trainer(cfg, data, test_data=data, device='cpu',
                model_dir=str(tmp_path))
    t.plateau_patience = 2
    t.test = lambda epoch=-1: 100.0 + epoch
    t.train()
    gamma = cfg.step_gamma
    assert t.state.lr_scale == pytest.approx(gamma)
    assert t._plateau == 0 and t.min_error == 100.0

    t2 = Trainer(dataclasses.replace(cfg, resume=True), data, test_data=data,
                 device='cpu', model_dir=str(tmp_path))
    assert t2.start_epoch == 3 and t2._plateau == 0
    assert t2.state.lr_scale == pytest.approx(gamma)
    assert t2.min_error == 100.0

    batch = batch_to_device({k: np.stack([s[k] for s in data])
                             for k in data[0]}, 'cpu')
    moved = []
    for lr_scale in (t2.state.lr_scale, 1.0):
        state = copy.deepcopy(t2.state)
        state.lr_scale = lr_scale
        p0 = next(state.model.parameters()).detach().clone()
        state, _ = t2.train_step(state, batch,
                                 torch.Generator().manual_seed(0), 3)
        moved.append(float((next(state.model.parameters()).detach() - p0)
                           .abs().max()))
    assert 0 < moved[0] < moved[1]
    print('measured: update with lr_scale gamma / 1:', moved)


# ------------------------------------------------------- warm starts --

def test_merge_partial_shape_gate(pth, tmp_path):
    """A 14-joint (NYU) model warm-started from the 21-joint .pth: every
    tensor of the same name and shape is the file's, the joint-count
    heads keep their init."""
    loaded = load_torch_checkpoint(pth)
    cfg = Config(dataset='nyu', batch_size=2, point_num=128,
                 load_model=pth, pretrain='', phase='test')
    t = Trainer(cfg, device='cpu', model_dir=str(tmp_path))
    fresh = build_kpfusion(cfg, device='cpu', seed=cfg.seed).state_dict()
    _, used, skipped = merge_partial(fresh, loaded)
    assert len(skipped) > 0 and len(used) > 0.9 * len(fresh)
    assert 'backbone_d.finals.0.weight' in skipped
    got = t.state.model.state_dict()
    for k in used:
        assert torch.equal(got[k], loaded[k]), k
    for k in skipped:
        assert torch.equal(got[k], fresh[k]), k
    print('merged', len(used), 'skipped', len(skipped))


def test_imagenet_pretrain_stem_gate(tmp_path):
    """A torchvision-named resnet18 file at pretrain_dir: both encoders
    take it, but the depth encoder's one-channel stem keeps its init;
    the decoders keep theirs. A pretrain_dir that holds no checkpoint
    raises."""
    torch.manual_seed(11)
    sd = ResNet(18, 3).state_dict()
    sd['fc.weight'] = torch.randn(1000, 512)
    sd['fc.bias'] = torch.randn(1000)
    torch.save(sd, tmp_path / 'resnet18-f37072fd.pth')
    cfg = Config(batch_size=2, point_num=128, phase='test',
                 pretrain_dir=str(tmp_path))
    got = Trainer(cfg, device='cpu',
                  model_dir=str(tmp_path / 'run')).state.model.state_dict()
    fresh = build_kpfusion(cfg, device='cpu', seed=cfg.seed).state_dict()
    for k, v in sd.items():
        if k.startswith('fc.'):
            continue
        assert torch.equal(got[f'backbone_rgb.backbone.{k}'], v), k
        d = got[f'backbone_d.backbone.{k}']
        want = fresh[f'backbone_d.backbone.{k}'] if k == 'conv1.weight' \
            else v
        assert torch.equal(d, want), k
    assert torch.equal(got['backbone_rgb.up4.0.conv1.conv.weight'],
                       fresh['backbone_rgb.up4.0.conv1.conv.weight'])
    with pytest.raises(FileNotFoundError, match='pretrain_dir'):
        Trainer(dataclasses.replace(cfg, pretrain_dir=str(tmp_path / 'run')),
                device='cpu', model_dir=str(tmp_path / 'run2'))


# ------------------------------------------------------------ guards --

def test_snapshot_sources_and_guards(tmp_path):
    """snapshot_sources copies the port's sources and entry script, not
    `_build/`, with a MANIFEST of the versions; train_data=None in the
    train phase loads cfg.dataset from cfg.root_dir, and raises naming the
    missing annotation file where the root holds none."""
    pkg = tmp_path / 'pkg'
    (pkg / '_build').mkdir(parents=True)
    (pkg / 'csrc').mkdir()
    (pkg / '_build' / 'kernel.py').write_text('built\n')
    (pkg / 'csrc' / 'k.cu').write_text('// kernel\n')
    (pkg / 'mod.py').write_text('x = 1\n')
    snapshot_sources(str(tmp_path / 'fake'), pkg_dir=str(pkg))
    fake = tmp_path / 'fake' / 'keypointfusion_torch'
    assert (fake / 'mod.py').is_file() and (fake / 'csrc' / 'k.cu').is_file()
    assert not (fake / '_build').exists()

    snapshot_sources(str(tmp_path / 'real'))
    real = tmp_path / 'real'
    assert (real / 'keypointfusion_torch' / 'training' / 'trainer.py') \
        .is_file()
    assert (real / 'keypointfusion_torch' / 'csrc' / 'desa_dense.cu') \
        .is_file()
    assert (real / 'chip_smoke.py').is_file()
    assert not (real / 'keypointfusion_torch' / '_build').exists()
    manifest = json.loads((real / 'MANIFEST.json').read_text())
    assert {'torch', 'cuda', 'numpy'} <= set(manifest['versions'])

    with pytest.raises(FileNotFoundError, match='DEX_YCB_s0_train_data'):
        Trainer(Config(root_dir=str(tmp_path / 'no_data')), device='cpu',
                model_dir=str(tmp_path / 'run'))
