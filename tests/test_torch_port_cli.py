"""The port's command line (keypointfusion_torch/train.py) and the
trainer's dataset loading, on the CPU.

  * parse_config takes every flag that the repository's train.py takes
    for the fields both Configs have, and parses the same values.
  * Trainer(cfg, device='cpu') with no data loads cfg.dataset's splits
    from cfg.root_dir through make_dataset, as the JAX trainer does; a
    test split that does not load leaves test_data None and says so.
  * main([...], device='cpu') trains one step of KPFusion-resnet-18 on a
    fabricated DexYCB tree (batch 2, 64 points, one epoch), then tests
    (with one loader thread, twice: the same errors) and evaluates the
    checkpoint it saved.
"""

import dataclasses
import json
import logging
import sys

import numpy as np
import pytest
import torch

import train as jax_train
from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_torch import train as cli
from keypointfusion_torch.config import Config
from keypointfusion_torch.data.datasets import DexYCBDataset
from keypointfusion_torch.training.trainer import Trainer

from tests.test_datasets import _write_fake_dexycb

torch.set_num_threads(2)


@dataclasses.dataclass(frozen=True)
class OneEpochConfig(Config):
    """The port's Config with its epoch budget as a field, so that a
    test trains one epoch (max_epoch is otherwise the dataset's)."""
    epochs: int = 1

    @property
    def max_epoch(self) -> int:
        return self.epochs


def _flag_fields(config):
    return {f.name: f for f in dataclasses.fields(config)
            if isinstance(f.default, (bool, str, int, float))}


def _other_value(default):
    if isinstance(default, bool):
        return not default, str(not default).lower()
    if isinstance(default, int):
        return default + 3, str(default + 3)
    if isinstance(default, float):
        return default * 2 + 0.5, repr(default * 2 + 0.5)
    return default + '_x', default + '_x'


def test_flags_match_train_py(monkeypatch):
    """For every field both Configs have, the port's flag exists with the
    root train.py flag's type and parses a non-default value the same
    way; the port has a flag for each of its own scalar fields."""
    ours, theirs = _flag_fields(Config), _flag_fields(JConfig)
    shared = sorted(set(ours) & set(theirs))
    assert set(Config.__dataclass_fields__) & set(theirs) == set(shared)
    assert {'phase', 'dataset', 'root_dir', 'dexycb_setup', 'ho3d_version',
            'center_type', 'color_factor', 'batch_size', 'load_model',
            'resume'} <= set(shared)
    argv = []
    for name in shared:
        assert type(ours[name].default) is type(theirs[name].default), name
        assert ours[name].default == theirs[name].default, name
        argv += [f'--{name}', _other_value(theirs[name].default)[1]]
    monkeypatch.setattr(sys, 'argv', ['train.py', *argv])
    want = jax_train.parse_config()
    got = cli.parse_config(argv)
    for name in shared:
        assert getattr(got, name) == getattr(want, name), name
        assert getattr(got, name) == _other_value(ours[name].default)[0]
    for spelling in ('1', 'yes', 'Y', 'True'):
        assert cli.parse_config(['--resume', spelling]).resume is True
    assert cli.parse_config(['--resume', 'no']).resume is False
    assert cli.parse_config([]) == Config()
    with pytest.raises(SystemExit):
        cli.parse_config(['--no_such_flag', '1'])
    assert cli.parse_config(['--epochs', '2'], OneEpochConfig).max_epoch == 2
    assert cli.parse_config(['--loader_threads', '1']) == Config()


@pytest.fixture(scope='module')
def dexycb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dexycb'))
    _write_fake_dexycb(root, n=2)
    return root


def test_trainer_loads_the_dataset(dexycb_root, tmp_path, capsys):
    """phase 'train' loads both splits, 'test' the test split only; a
    missing train split raises; a test split that does not load is
    logged and printed, and test() then says there is none."""
    cfg = Config(root_dir=dexycb_root, batch_size=2, point_num=64,
                 pretrain='')
    trainer = Trainer(cfg, device='cpu', model_dir=str(tmp_path / 'a'))
    for data in (trainer.train_data, trainer.test_data):
        assert isinstance(data, DexYCBDataset) and len(data) == 2
    assert trainer.train_data.split == 'train'
    assert trainer.test_data.split == 'test'
    trainer = Trainer(dataclasses.replace(cfg, phase='test'), device='cpu',
                      model_dir=str(tmp_path / 'b'))
    assert trainer.train_data is None and len(trainer.test_data) == 2
    with pytest.raises(FileNotFoundError, match='DEX_YCB_s1_train'):
        Trainer(dataclasses.replace(cfg, dexycb_setup='s1'), device='cpu',
                model_dir=str(tmp_path / 'c'))

    test_file = f'{dexycb_root}/DexYCB/annotations/DEX_YCB_s0_test_data.json'
    with open(test_file) as f:
        saved = f.read()
    try:
        with open(test_file, 'w') as f:
            f.write('{')
        logging.getLogger().handlers.clear()   # train.log of this run
        trainer = Trainer(Config(root_dir=dexycb_root, batch_size=2,
                                 point_num=64, pretrain='', phase='test'),
                          device='cpu', model_dir=str(tmp_path / 'e'))
    finally:
        with open(test_file, 'w') as f:
            f.write(saved)
    assert trainer.test_data is None
    assert 'the test split of dexycb did not load' in capsys.readouterr().out
    log = (tmp_path / 'e' / 'train.log').read_text()
    assert 'did not load' in log and 'JSONDecodeError' in log
    with pytest.raises(RuntimeError, match='no test split'):
        trainer.test()


def test_main_train_test_eval(dexycb_root, tmp_path, capsys):
    """One epoch of one step at batch 2 through main(), then --phase test
    and --phase eval on the best checkpoint: the summary line of each,
    finite errors, the dumps and pred.json."""
    common = ['--dataset', 'dexycb', '--root_dir', dexycb_root,
              '--batch_size', '2', '--point_num', '64', '--pretrain', '',
              '--save_dir', str(tmp_path), '--model_save', 'cli']
    trainer, result = cli.main(['--phase', 'train', *common], device='cpu',
                               config=OneEpochConfig)
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary['phase'] == 'train' and summary['train_samples'] == 2
    assert summary['test_samples'] == 2 and np.isfinite(result)
    assert summary['result'] == result
    assert trainer.state.step == 1
    assert set(summary['kernel_launches']) == {
        'pixel_sampler', 'desa_dense', 'pixel_sampler_serving',
        'desa_dense_serving', 'grouped_mlp_pool'}
    assert all(v == 0 for v in summary['kernel_launches'].values())
    model_dir = trainer.model_dir
    assert model_dir == f'{tmp_path}/checkpoint/dexycb/' \
        'KPFusion-resnet-18_cli'
    want = trainer.state.model.state_dict()

    test_args = ['--phase', 'test', '--load_model', 'best', *common,
                 '--loader_threads', '1']
    tested, error = cli.main(test_args, device='cpu')
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary == {'phase': 'test', 'train_samples': None,
                       'test_samples': 2, 'result': error,
                       'kernel_launches': summary['kernel_launches']}
    assert '[mean_Error' in out and np.isfinite(error)
    got = tested.state.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    dump = np.loadtxt(f'{model_dir}/test_5.txt')
    assert dump.shape == (2, 63) and np.isfinite(dump).all()
    # one loader thread: the same point samples, the same errors
    again = Trainer(cli.parse_config(test_args), device='cpu',
                    loader_threads=1)
    assert tested.loader_threads == again.loader_threads == 1
    assert abs(again.test() - error) <= 1e-4
    capsys.readouterr()

    _, pred = cli.main(['--phase', 'eval', '--load_model', 'best', *common],
                       device='cpu')
    with open(pred) as f:
        joints, meshes = json.load(f)
    assert np.asarray(joints).shape == (2, 21, 3)
    with pytest.raises(ValueError, match='unknown phase'):
        cli.main(['--phase', 'serve', *common], device='cpu')
