"""K2 'default' (the bfloat16 serving sampler) by its CUDA kernel's steps,
on the CPU.

csrc/pixel_sampler_serving.cu finds the threshold and the selection
otherwise than the plain version: each lane of a point's warp holds d2 of
its own pixels, the threshold is a min over the warp and then three times
the least value above it (on the values' bits, one warp reduction each),
ballots by chunk give the selected pixels in index order, and their rows
are added a few at a time. `_serving_plain_lanes` runs those steps in
plain PyTorch; here it must give the plain version's bits exactly, on a
random case, a flat background (whole tied rings selected), every pixel
selected (pixel centres at 3 positions: no 4th distinct distance, so the
threshold is 1e30), and HW = 256 with N = 100, not a multiple of the
kernel's points per block. The plain version is held to JAX's
interpret-mode kernel in tests/test_torch_port_serving_bf16.py; the kernel
to the plain version on the card in tests/test_torch_port_cuda.py, on the
same kinds of case (sampler_case).
"""

import pytest
import torch

from keypointfusion_torch.kernels import pixel_sampler as k2

from tests.test_torch_port_cuda import sampler_case

torch.set_num_threads(2)

CASES = {
    'random': dict(kind='random'),
    'flat_background': dict(kind='flat_background'),
    'all_selected': dict(kind='three_positions'),
    'hw_256_n_100': dict(kind='flat_background', hw=256, n=100),
}


def _inputs(**case):
    pcl, img_xyz, feat = (torch.from_numpy(x)
                          for x in sampler_case(**case))
    return pcl, img_xyz, feat.to(torch.bfloat16)


@pytest.mark.parametrize('case', sorted(CASES))
def test_serving_lanes_match_plain_bit_for_bit(case):
    pcl, img_xyz, feat = _inputs(**CASES[case])
    want = k2.sample_pixel_features_plain(pcl, img_xyz, feat, mode='default')
    got = k2._serving_plain_lanes(pcl, img_xyz, feat)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)

    d2 = k2.serving_sqdist(pcl, img_xyz)
    thresh = k2.serving_threshold(d2)
    counts = (d2 <= thresh).sum(-1)
    if case == 'random':
        assert bool((counts == 4).all())
    elif case == 'all_selected':
        assert bool((thresh == k2.NO_THRESHOLD).all())
        assert bool((counts == img_xyz.shape[1]).all())
    else:
        assert int(counts.max()) > 4 and int((counts > 4).sum()) > 50


@pytest.mark.parametrize('lanes,rows', [(32, 1), (32, 3), (16, 8)])
def test_serving_lanes_any_lanes_and_rows(lanes, rows):
    """The merge and the sum order do not depend on the lanes per point or
    the rows taken at a time."""
    pcl, img_xyz, feat = _inputs(kind='flat_background', n=64)
    want = k2.sample_pixel_features_plain(pcl, img_xyz, feat, mode='default')
    got = k2._serving_plain_lanes(pcl, img_xyz, feat, lanes=lanes,
                                  rows_in_flight=rows)
    assert torch.equal(got, want)


def test_least_above_is_the_least_value_above_t():
    """The kernel's step on the values' bits (values at or below t wrap
    past 2^31 as unsigned) against the float rule min{x > t}, on rows with
    repeats, zeros and +inf padding, and t = +inf (nothing above)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 6, (400, 4, 8), generator=gen).float() / 4
    x[:100, :, -2:] = float('inf')
    x[100:200] = 0.0
    t = x.flatten(1)[:, torch.randint(0, 32, (1,), generator=gen)][:, 0]
    t[:50] = float('inf')
    bits = x.view(torch.int32).long()
    got = k2._least_above(bits, t.view(torch.int32).long())
    got = got.int().view(torch.float32)
    flat = x.flatten(1)
    want = torch.where(flat > t[:, None], flat,
                       torch.full_like(flat, float('inf'))).amin(-1)
    assert torch.equal(got, want)
