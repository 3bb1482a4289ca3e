"""The yardstick's work counters against hand counts at the kernel
table's shapes (PERF.md: batch 64, 1024 points, 21 joints, 32x32 maps,
C = 128 for K1 and 277 for K2)."""

import pytest
import torch

from portbench import work
from portbench.shared import reference, work_info
from portbench.tests.helpers import config, net_config


def test_k2_bytes_at_the_table_shapes():
    nbytes, flops = work.k2_work(64, 1024, 1024, 277)
    # pcl and img_xyz [64,1024,3], feat and out [64,1024,277], float32
    assert nbytes == 4 * (2 * 64 * 1024 * 3 + 2 * 64 * 1024 * 277)
    assert round(nbytes / 1e6, 1) == 146.8
    assert flops == 64 * 1024 * 1024 * 9 + 64 * 1024 * 277 * 7
    # bytes bound it: 0.0438 ms
    assert round(work.bound_s(nbytes, fp32_flops=flops) * 1e3, 4) == 0.0438


def test_k1_counts_full_groups_by_hand():
    # every point and joint at the origin: every ball holds every support
    # point, so each group is its first 64, the same for every joint
    b, n, j, c = 2, 100, 3, 128
    nbytes, products, rest = work.k1_work(
        torch.zeros(b, n, 3), torch.zeros(b, j, 3), c, (0.1, 0.2, 0.4),
        (64, 64, 64))
    slots = b * j * 3 * 64
    points = 3 * b * 64
    fusion = b * j * 2 * 4 * c * c
    assert products == (points + slots) * 2 * c * c + fusion == 51118080
    assert rest == points * 2 * 3 * c + b * j * (n + j) * 9 \
        + b * j * 3 * 2 * c * c


def test_k1_bytes_at_the_table_shapes():
    nbytes, _, _ = work.k1_work(torch.zeros(64, 1024, 3),
                                torch.zeros(64, 21, 3), 128,
                                (0.1, 0.2, 0.4), (64, 64, 64))
    features = 64 * 1024 * 128 + 2 * 64 * 21 * 128
    points = 64 * 1024 * 3 + 64 * 21 * 3
    weights = 3 * (2 * 128 * 128 + 5 * 128) + 4 * 128 * 128 + 128
    assert nbytes == 4 * (features + points + weights)
    # the table's 0.011 ms of bytes
    assert round(nbytes / work.HBM_BYTES_PER_S * 1e3, 3) == 0.011


def test_a_bound_is_the_largest_time_not_the_sum():
    assert work.bound_s(3.35e12, 495e12, 67e12) == 1.0
    assert work.bound_s(0, 2 * 495e12, 0) == 2.0


def test_model_flops_count_products_and_convolutions():
    kpfusion = reference({}).KPFusion
    r18 = work.model_flops(kpfusion, net_config('KPFusion-resnet-18'))
    cnxt = work.model_flops(kpfusion, net_config('KPFusion-convnext-T'))
    # the ResNet-18 encoder alone at 128x128 is 2 x 0.58 GFLOP
    assert 3.0e9 < r18 < 6.0e9
    assert cnxt > r18


@pytest.mark.parametrize('name,flops', [
    ('kpfusion-resnet18', 4107797236.0),
    ('kpfusion-convnext-t', 8609252084.0)])
def test_the_cells_divide_by_the_same_work(name, flops):
    # pinned: what the cells' rooflines and mfu readers divide by, so a
    # change to the reference or its resolution that moves their
    # readings fails here
    kpfusion = reference(config(name)).KPFusion
    assert work.model_flops(kpfusion, config(name)) == flops
    gen = torch.Generator().manual_seed(5)
    calls = [(torch.rand(2, 1024, 3, generator=gen) * 0.6 - 0.3,
              torch.rand(2, 21, 3, generator=gen) * 0.6 - 0.3)]
    assert work_info(kpfusion, config(name), 1024, 256, calls) == {
        'flops_per_unit': flops * 256,
        'k1_bounds': [5.572545939393939e-07],
        'k2_bound': 0.0001752843462686567}
