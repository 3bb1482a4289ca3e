"""A later cell comes as files only: a throwaway configuration (one of
them with a plain reference of its own), traffic mix, traffic kind,
limits and per-layer metric, in a checkout of their own, run through the
harness without an existing file being edited."""

import hashlib
import json
import os
import shutil

import pytest

from portbench import harness
from portbench.tests.helpers import config, run_small

# what harness.run_cell calls of a kind's run
RUN_METHODS = ('set_up', 'window', 'traced', 'check', 'free')


def _digest(root):
    h = hashlib.sha256()
    for base, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            if name.endswith('.pyc'):
                continue
            with open(os.path.join(base, name), 'rb') as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def assert_complete_run(cell, root=harness.ROOT):
    """The cell's kind is a file, portbench/kinds/<kind>.py, whose `Run`
    has what harness.run_cell calls."""
    kind = cell.traffic['kind']
    run = harness.run_class(kind, root)(cell, 0, 'cpu', {})
    for name in RUN_METHODS:
        assert callable(getattr(run, name, None)), (kind, name)
    assert hasattr(run, 'attempted'), (kind, 'attempted')


# the reference file of a configuration of its own: model.py, and a note
# beside it of each time it is loaded and each KPFusion it builds
MARKED = '''

import os

with open(os.path.join(os.path.dirname(__file__), 'built'), 'a') as f:
    f.write('loaded\\n')

_Plain = KPFusion


class KPFusion(_Plain):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        with open(os.path.join(os.path.dirname(__file__), 'built'),
                  'a') as f:
            f.write('KPFusion\\n')
'''


def test_a_cell_added_as_files_runs(tmp_path):
    before = _digest(os.path.join(harness.ROOT, 'portbench'))
    root = tmp_path / 'checkout'
    pb = root / 'portbench'
    for sub in ('configs', 'traffic', 'limits', 'metrics', 'reference'):
        (pb / sub).mkdir(parents=True)
    # the checkout's kinds are files, as its metrics are
    shutil.copytree(os.path.join(harness.ROOT, 'portbench', 'kinds'),
                    pb / 'kinds')
    with open(os.path.join(harness.ROOT, 'portbench', 'reference',
                           'model.py')) as f:
        plain = f.read()
    (pb / 'reference' / 'model.py').write_text(plain)
    (pb / 'reference' / 'model_marked.py').write_text(plain + MARKED)
    for name, extra in (('tiny-r18', {}),
                        ('tiny-r18-own', {'reference': 'model_marked.py'})):
        (pb / 'configs' / f'{name}.json').write_text(json.dumps(
            {**config('kpfusion-resnet18'), 'name': name, **extra}))
    (pb / 'traffic' / 'eval.tiny.json').write_text(json.dumps(
        {'kind': 'eval', 'batch': 3, 'ring': 2, 'warmup_steps': 1,
         'trace_steps': 2}))
    for cell in ('tiny.eval', 'tiny.eval.own'):
        (pb / 'limits' / f'{cell}.json').write_text(json.dumps(
            {'limits': {'b1_mm_gap': 0.01, 'dense_gap': 1e-4}}))
    (pb / 'metrics' / 'frames_seen.eval.py').write_text(
        'def read(view):\n    return view.units * view.frames_per_unit\n')
    (pb / 'metrics' / 'nothing.eval.py').write_text(
        'def read(view):\n    return None\n')
    bench = {
        'configs': [{'name': name, 'source': 'x', 'reduced': [],
                     'file': f'portbench/configs/{name}.json', 'why': 'x'}
                    for name in ('tiny-r18', 'tiny-r18-own')],
        'workloads': [{'name': 'tiny.eval', 'config': 'tiny-r18',
                       'traffic': 'eval.tiny', 'chips': 1, 'why': 'x'},
                      {'name': 'tiny.eval.own', 'config': 'tiny-r18-own',
                       'traffic': 'eval.tiny', 'chips': 1, 'why': 'x'}],
        'end_to_end': [{'name': 'eval_frames_per_s', 'unit': 'frames/s'},
                       {'name': 'setup_s', 'unit': 's'}],
        'per_layer': [{'name': 'frames_seen.eval', 'unit': 'count'},
                      {'name': 'nothing.eval', 'unit': 'count'}]}
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    result, rows = run_small('tiny.eval', trace=True, root=str(root))
    assert result['metrics'] == {'frames_seen.eval': {
        'value': 1 * 2, 'unit': 'count'}}
    assert result['correct'], rows
    result, _ = run_small('tiny.eval', trace=False, root=str(root))
    assert set(result['metrics']) == {'eval_frames_per_s', 'setup_s'}
    assert not (pb / 'reference' / 'built').exists()
    # the configuration's own reference, loaded once by the run: its
    # weights' names, the FLOPs of the traced run and the model the check
    # compares with
    result, rows = run_small('tiny.eval.own', trace=True, root=str(root))
    assert result['correct'], rows
    assert (pb / 'reference' / 'built').read_text() == \
        'loaded\n' + 'KPFusion\n' * 3
    assert _digest(os.path.join(harness.ROOT, 'portbench')) == before
    shutil.rmtree(root)


def test_every_name_in_the_benchmark_has_its_files():
    bench = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
    for w in bench['workloads']:
        cell = harness.Cell(bench, w['name'])
        assert cell.limits, w['name']
        assert_complete_run(cell)
    for m in bench['per_layer']:
        assert callable(harness.reader(m['name']))


WHOLE = '''
class Run:
    def __init__(self, cell, seed, device, small):
        self.attempted = 0

    def set_up(self):
        pass

    def window(self, seconds):
        self.attempted = 1
        return {'answers_per_s': 1.0}

    def traced(self):
        return None

    def check(self):
        return {'gap': 0.0}, 0

    def free(self):
        pass
'''


KINDS = {'whole': WHOLE,
         'no_free': WHOLE.split('    def free')[0],
         'no_attempted': WHOLE.replace('self.attempted = 0', 'pass'),
         'missing': None}


@pytest.mark.parametrize('kind', list(KINDS))
def test_a_traffic_kind_is_a_file(tmp_path, kind):
    source = KINDS[kind]
    pb = tmp_path / 'portbench'
    for sub in ('configs', 'traffic', 'limits', 'kinds'):
        (pb / sub).mkdir(parents=True)
    if source is not None:
        (pb / 'kinds' / f'{kind}.py').write_text(source)
    (pb / 'configs' / 'c.json').write_text(json.dumps({'name': 'c'}))
    (pb / 'traffic' / 't.json').write_text(json.dumps({'kind': kind}))
    (pb / 'limits' / 'c.t.json').write_text(json.dumps(
        {'limits': {'gap': 0.0}}))
    bench = {
        'configs': [{'name': 'c', 'file': 'portbench/configs/c.json'}],
        'workloads': [{'name': 'c.t', 'config': 'c', 'traffic': 't',
                       'chips': 1}],
        'end_to_end': [{'name': 'answers_per_s', 'unit': '1/s'},
                       {'name': 'setup_s', 'unit': 's'}],
        'per_layer': []}
    cell = harness.Cell(bench, 'c.t', str(tmp_path))
    if kind != 'whole':
        with pytest.raises((AssertionError, FileNotFoundError)):
            assert_complete_run(cell, str(tmp_path))
        return
    assert_complete_run(cell, str(tmp_path))
    result, rows = harness.run_cell(bench, 'c.t', 1, 0.0, False,
                                    device='cpu', root=str(tmp_path))
    assert result['correct'] and result['attempted'] == 1, rows
    assert set(result['metrics']) == {'answers_per_s', 'setup_s'}
