"""The control on the card: the plain reference computed with TF32
products and convolutions in the program's place must come out outside
the cell's limits, while the program itself stays inside them. At a
reduced batch here; calibrate.py reads both at each cell's own size."""

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.helpers import BENCH, EVAL, SERVE, TRAIN


@pytest.mark.cuda
@pytest.mark.parametrize('workload', [SERVE, TRAIN, EVAL])
def test_the_control_fails_the_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (TF32 exists only there)')
    limits = harness.Cell(BENCH, workload).limits
    row = calibrate.readings(BENCH, workload, 2 ** 31 + 77, 2, True,
                             small={'batch': 64, 'check_requests': 2})
    assert all(row['program'][k] <= v for k, v in limits.items()), row
    assert any(row['control'][k] > v for k, v in limits.items()), row
