"""A later cell comes as files only: a throwaway configuration, traffic
mix, limits and per-layer metric, in a checkout of their own, run
through the harness without an existing file being edited."""

import hashlib
import json
import os
import shutil

from portbench import harness
from portbench.tests.helpers import run_small


def _digest(root):
    h = hashlib.sha256()
    for base, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            if name.endswith('.pyc'):
                continue
            with open(os.path.join(base, name), 'rb') as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def test_a_cell_added_as_files_runs(tmp_path):
    before = _digest(os.path.join(harness.ROOT, 'portbench'))
    root = tmp_path / 'checkout'
    pb = root / 'portbench'
    for sub in ('configs', 'traffic', 'limits', 'metrics'):
        (pb / sub).mkdir(parents=True)
    config = harness.load_json(os.path.join(
        harness.ROOT, 'portbench', 'configs', 'kpfusion-resnet18.json'))
    config['name'] = 'tiny-r18'
    (pb / 'configs' / 'tiny-r18.json').write_text(json.dumps(config))
    (pb / 'traffic' / 'eval.tiny.json').write_text(json.dumps(
        {'kind': 'eval', 'batch': 3, 'ring': 2, 'warmup_steps': 1,
         'trace_steps': 2}))
    (pb / 'limits' / 'tiny.eval.json').write_text(json.dumps(
        {'limits': {'b1_mm_gap': 0.01, 'dense_gap': 1e-4}}))
    (pb / 'metrics' / 'frames_seen.eval.py').write_text(
        'def read(view):\n    return view.units * view.frames_per_unit\n')
    (pb / 'metrics' / 'nothing.eval.py').write_text(
        'def read(view):\n    return None\n')
    bench = {
        'configs': [{'name': 'tiny-r18', 'source': 'x', 'reduced': [],
                     'file': 'portbench/configs/tiny-r18.json', 'why': 'x'}],
        'workloads': [{'name': 'tiny.eval', 'config': 'tiny-r18',
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
    assert _digest(os.path.join(harness.ROOT, 'portbench')) == before
    shutil.rmtree(root)


def test_every_name_in_the_benchmark_has_its_files():
    bench = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
    for w in bench['workloads']:
        cell = harness.Cell(bench, w['name'])
        assert cell.limits, w['name']
        assert cell.traffic['kind'] in ('serve', 'train', 'eval')
        harness.run_class(cell.traffic['kind'])
    for m in bench['per_layer']:
        assert callable(harness.reader(m['name']))
