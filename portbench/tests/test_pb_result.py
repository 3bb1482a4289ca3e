"""The result line's keys, and a run with no card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import EVAL, SERVE, run_small


@pytest.mark.parametrize('trace', [False, True])
def test_result_keys(trace):
    result, rows = run_small(SERVE, trace=trace)
    keys = ['correct', 'attempted', 'failed', 'metrics', 'device'] \
        + ['breakdown'] * trace + ['compared']
    assert list(result) == keys
    assert set(result['device']) >= {'platform', 'kind', 'count',
                                      'memory_peak_bytes'}
    assert result['attempted'] > 0 and result['failed'] == 0
    assert [r[0] for r in rows] == list(result['compared'])
    for name, entry in result['compared'].items():
        assert set(entry) == {'value', 'limit'}
    if trace:
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert set(result['metrics']) == {'frames_per_s', 'request_p95_ms',
                                          'setup_s'}
    json.dumps(result)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    out = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, 'portbench', 'run.py'),
         '--workload', EVAL, '--seed', str(2 ** 31 + 5), '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ''
    assert 'CUDA' in out.stderr
