"""K2 'highest' (the float32 sampler) by its CUDA kernel's steps, on the CPU.

csrc/pixel_sampler.cu finds the 4 nearest pixels otherwise than the plain
version's stable sort: each lane of a point's warp holds d2 of its own
pixels (padded with the origin at |x|^2 = +inf), the 4 smallest distinct
values come from warp reductions on the values' bits, and the candidates
at or below the 4th enter a 4-slot list in index order on a strictly
smaller d2. `_highest_plain_lanes` runs those steps in plain PyTorch;
here it must give the plain version's bits exactly on six cases: random;
a flat background with 4th/5th-nearest ties; every slot tied (pixel
centres at 3 positions, so the lowest indices must win); HW = 256 with
N = 100, not a multiple of the kernel's points per block; HW = 100, not a
multiple of 32, with points on the axes (px = 0), where a padded centre
at +inf would give NaN; HW = 2048, the 64-chunk build. The plain version
is held to JAX's interpret-mode kernel in tests/test_torch_port_kernels.py;
the kernel to the plain version on the card in
tests/test_torch_port_cuda.py, on the same cases (HIGHEST_SAMPLER_CASES).
"""

import pytest
import torch

from keypointfusion_torch.kernels import pixel_sampler as k2
from keypointfusion_torch.ops.pairwise import pairwise_sqdist

from tests.test_torch_port_cuda import HIGHEST_SAMPLER_CASES, sampler_case

torch.set_num_threads(2)


def _inputs(**case):
    return [torch.from_numpy(x) for x in sampler_case(**case)]


@pytest.mark.parametrize('case', sorted(HIGHEST_SAMPLER_CASES))
def test_highest_lanes_match_plain_bit_for_bit(case):
    pcl, img_xyz, feat = _inputs(**HIGHEST_SAMPLER_CASES[case])
    want = k2.sample_pixel_features_plain(pcl, img_xyz, feat)
    got = k2._highest_plain_lanes(pcl, img_xyz, feat)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)

    # each case is what its name says
    d2 = torch.sort(pairwise_sqdist(pcl, img_xyz), -1)[0]
    ties = d2[..., 3] == d2[..., 4]
    if case == 'all_tied':
        assert bool((d2[..., 0] == d2[..., 4]).all())
    elif case == 'random':
        assert not bool(ties.any())
    elif case == 'hw_100_axes':
        assert img_xyz.shape[1] % 32 != 0
        assert int((pcl[..., 0] == 0).sum()) > pcl.shape[1]
    else:
        assert int(ties.sum()) > 10


@pytest.mark.parametrize('lanes', [8, 16])
def test_highest_lanes_any_lane_count(lanes):
    """The reductions and the walk do not depend on the lanes per point."""
    for case in ('flat_background', 'all_tied'):
        pcl, img_xyz, feat = _inputs(n=64, **HIGHEST_SAMPLER_CASES[case])
        want = k2.sample_pixel_features_plain(pcl, img_xyz, feat)
        assert torch.equal(k2._highest_plain_lanes(pcl, img_xyz, feat,
                                                   lanes=lanes), want)
