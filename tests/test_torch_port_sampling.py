"""Port parity of geometry/sampling.py and utils/graph.py against the JAX
package on the same numpy inputs.

The host functions (calculate_com, pca_orient, farthest_point_sample,
the adjacency matrices) bit for bit. The torch FPS from JAX's start
indices: indices equal. The two correspondence functions on random
clouds and on grid-aligned clouds, where the camera, the crop and the
points are dyadic so that equidistant pixels tie exactly (asserted) and
the top-k must take the lower pixel index first: indices equal, weights
within 1e-6 (float32 sums of up to 64 terms in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from keypointfusion_tpu.geometry import sampling as jsamp
from keypointfusion_tpu.geometry.camera import CropFrame as JFrame
from keypointfusion_tpu.utils import graph as jgraph

from keypointfusion_torch.geometry import sampling
from keypointfusion_torch.geometry.camera import CropFrame
from keypointfusion_torch.ops.pairwise import pairwise_sqdist
from keypointfusion_torch.utils import graph

torch.set_num_threads(2)
WTOL = 1e-6
t = torch.from_numpy


def test_host_functions_match_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    depth = rng.uniform(300, 900, (60, 80)).astype(np.float32)
    depth[rng.rand(60, 80) < 0.3] = 0
    for band in ((400, 700), (2000, 3000)):
        np.testing.assert_array_equal(sampling.calculate_com(depth, *band),
                                      jsamp.calculate_com(depth, *band))
    pcl = rng.randn(500, 3).astype(np.float32) * [3, 2, 1]
    joint = rng.randn(21, 3).astype(np.float32)
    for got, want in zip(sampling.pca_orient(pcl, joint),
                         jsamp.pca_orient(pcl, joint)):
        np.testing.assert_array_equal(got, want)
    for n, npoint in ((500, 64), (40, 64), (20, 64)):
        got = sampling.farthest_point_sample(pcl[:n], npoint,
                                             np.random.RandomState(n))
        want = jsamp.farthest_point_sample(pcl[:n], npoint,
                                           np.random.RandomState(n))
        np.testing.assert_array_equal(got, want)


def test_torch_fps_matches_jax_from_its_starts():
    """farthest_point_steps from the start indices JAX draws from its key
    gives JAX's indices; farthest_point_sample_torch draws its starts from
    the generator."""
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-1, 1, (3, 300, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax.jit(jsamp.farthest_point_sample_jax, static_argnums=1)(
        xyz, 32, key)
    start = jax.random.randint(key, (3,), 0, 300)
    got = sampling.farthest_point_steps(t(xyz), t(np.array(start)), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = sampling.farthest_point_sample_torch(
        t(xyz), 32, torch.Generator().manual_seed(0))
    first = torch.randint(0, 300, (3,), generator=torch.Generator()
                          .manual_seed(0))
    assert idx.shape == (3, 32) and torch.equal(idx[:, 0], first)
    assert torch.equal(idx, sampling.farthest_point_steps(t(xyz), first, 32))


def _frames(cam, center, M, cube):
    return (JFrame.from_batch(*(jnp.asarray(a) for a in (cam, center, M,
                                                         cube))),
            CropFrame.from_batch(cam, center, M, cube))


def random_case(rng):
    """A cloud near a random crop of a random depth map."""
    b = 2
    cam = np.tile(np.array([[475., 475., 320., 240.]], np.float32), (b, 1))
    center = np.array([[10., -20., 500.], [-30., 15., 620.]], np.float32)
    M = np.tile(np.array([[[0.6, 0.05, -100.], [-0.05, 0.6, -80.],
                           [0., 0., 1.]]], np.float32), (b, 1, 1))
    cube = np.full((b, 3), 250.0, np.float32)
    depth = rng.uniform(-1, 1, (b, 32, 32, 1)).astype(np.float32)
    pcl = rng.uniform(-0.8, 0.8, (b, 64, 3)).astype(np.float32)
    return pcl, depth, _frames(cam, center, M, cube)


def grid_case():
    """A dyadic camera and crop (fx = fy = the crop's depth of 512 mm, the
    identity crop matrix, cube 256 mm), a flat depth map at the crop's
    centre and cloud points on pixel corners and centres: every pixel
    position and every squared distance is exact in float32."""
    b = 2
    cam = np.tile(np.array([[512., 512., 64., 64.]], np.float32), (b, 1))
    center = np.tile(np.array([[0., 0., 512.]], np.float32), (b, 1))
    M = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    cube = np.full((b, 3), 256.0, np.float32)
    depth = np.zeros((b, 32, 32, 1), np.float32)
    k = np.arange(-12, 13, 3, dtype=np.float32)
    corners = np.stack(np.meshgrid(k, k, indexing='ij'), -1).reshape(-1, 2)
    xy = np.concatenate([corners / 32.0, (corners + 0.5) / 32.0])
    pcl = np.concatenate([xy, np.zeros((len(xy), 1))], -1).astype(
        np.float32)
    return np.stack([pcl, pcl[::-1]]), depth, _frames(cam, center, M, cube)


def _cut_is_tied(d2, k):
    """Whether some row's k-th and (k+1)-th smallest values are equal."""
    s = np.sort(d2, -1)
    return bool((s[..., k - 1] == s[..., k]).any())


@pytest.mark.parametrize('case', ['random', 'grid'])
def test_correspondences_match_jax(case):
    pcl, depth, (jframe, frame) = random_case(np.random.RandomState(2)) \
        if case == 'random' else grid_case()
    jp, jd = jnp.asarray(pcl), jnp.asarray(depth)
    # JAX op by op: a jit of the whole function rounds the pixels' xyz
    # differently (5.4e-7), which the softmax of 30 x closeness amplifies
    # to 5.6e-5 in the weights
    want_c, want_i = jsamp.img_to_pcl_index_softmax(jp, jd, jframe,
                                                    select_num=10)
    got_c, got_i = sampling.img_to_pcl_index_softmax(t(pcl), t(depth),
                                                     frame, select_num=10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=WTOL)
    want_c, want_i = jsamp.pcl_to_img_index(jp, 32, jframe, select_num=9)
    got_c, got_i = sampling.pcl_to_img_index(t(pcl), 32, frame,
                                             select_num=9)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=WTOL)
    if case == 'grid':
        from keypointfusion_torch.geometry.camera import (
            uvd_nl_to_xyz_nl, xyz_nl_to_uvd_nl)
        from keypointfusion_torch.geometry.grid import img_uvd_points
        img_xyz = uvd_nl_to_xyz_nl(img_uvd_points(t(depth)), frame)
        assert _cut_is_tied(pairwise_sqdist(t(pcl), img_xyz).numpy(), 10)
        uv = (xyz_nl_to_uvd_nl(t(pcl), frame)[..., :2] + 1) / 2 * 32
        px = torch.arange(32, dtype=torch.float32) + 0.5
        coords = torch.stack([px[None, :].expand(32, 32).reshape(-1),
                              px[:, None].expand(32, 32).reshape(-1)], -1)
        d2 = pairwise_sqdist(uv, coords[None].expand(2, -1, -1)).numpy()
        assert _cut_is_tied(d2, 9)


def test_pairwise_sqdist_in_two_dimensions_matches_jax():
    """The squared distances of pixel coordinates (C = 2) as the JAX
    function computes them op by op on the CPU, bit for bit."""
    from keypointfusion_tpu.ops.pairwise import pairwise_sqdist as jdist
    rng = np.random.RandomState(3)
    a = rng.uniform(0, 32, (2, 50, 2)).astype(np.float32)
    b = rng.uniform(0, 32, (2, 70, 2)).astype(np.float32)
    np.testing.assert_array_equal(pairwise_sqdist(t(a), t(b)).numpy(),
                                  np.asarray(jdist(a, b)))


def test_graph_matches_jax():
    edges = [(0, 1), (1, 2), (2, 0), (3, 4)]
    np.testing.assert_array_equal(graph.adj_matrix_from_edges(6, edges),
                                  jgraph.adj_matrix_from_edges(6, edges))
    got = graph.adj_matrix_from_edges(6, edges, sparse=True)
    want = jgraph.adj_matrix_from_edges(6, edges, sparse=True)
    assert sp.isspmatrix_csr(got)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    np.testing.assert_array_equal(graph.hand_adjacency(),
                                  jgraph.hand_adjacency())


def test_fast_topk_is_exact_off_the_tpu():
    """JAX's approx_min_k (Config.fast_topk) gives top_k's values on the
    CPU, and its indices where no two distances tie at the k-th; where
    they tie (the grid case: 162 rows) it may take other, equidistant
    pixels, and top_k the lower indices. The port keeps top_k's selection
    whatever the flag: it takes the flag through build_kpfusion, the
    engine and the train state, and its forward is the same either way."""
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import synthetic_batch
    from keypointfusion_torch.geometry.camera import uvd_nl_to_xyz_nl
    from keypointfusion_torch.geometry.grid import img_uvd_points
    from keypointfusion_torch.models.kpfusion import build_kpfusion
    from keypointfusion_torch.serving import StreamingEngine
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, frame_from_batch,
    )
    for case in (random_case(np.random.RandomState(2)), grid_case()):
        pcl, depth, (_, frame) = case
        d2 = pairwise_sqdist(t(pcl), uvd_nl_to_xyz_nl(
            img_uvd_points(t(depth)), frame)).numpy()
        vals, idx = jax.lax.approx_min_k(jnp.asarray(d2), 4)
        neg, want = jax.lax.top_k(-jnp.asarray(d2), 4)
        np.testing.assert_array_equal(np.asarray(vals), -np.asarray(neg))
        np.testing.assert_array_equal(
            np.take_along_axis(d2, np.asarray(idx), -1), np.asarray(vals))
        same = (np.sort(np.asarray(idx), -1)
                == np.sort(np.asarray(want), -1)).all(-1)
        s = np.sort(d2, -1)
        np.testing.assert_array_equal(~same & (s[..., 3] != s[..., 4]),
                                      False)
        assert _cut_is_tied(d2, 4) == (case[1].max() == 0)

    cfg = Config(fast_topk=True, point_num=256)
    batch = batch_to_device(synthetic_batch(batch_size=2, point_num=256,
                                            seed=42), 'cpu')
    assert create_train_state(cfg, batch, device='cpu').model.fast_topk
    assert StreamingEngine(cfg, batch_size=2, device='cpu').model.fast_topk
    frame = frame_from_batch(batch, cfg)
    outs = []
    for fast in (True, False):
        model = build_kpfusion(Config(fast_topk=fast), device='cpu')
        assert model.fast_topk == fast
        with torch.no_grad():
            outs.append(model(batch['rgb'], batch['depth'], batch['pcl'],
                              frame)[0])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
