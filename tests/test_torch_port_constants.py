"""The forward's per-device constants (utils/device.py:device_constant):
`geometry/grid.py:uv_grid` and `ops/codecs.py:_kernel_arr` build their
tensor once per key and device and hand the same tensor back after, so a
forward on the card enqueues no host-to-device copy and makes its host
wait on nothing. On the CPU: the values are unchanged (the grid equals
the JAX package's bit for bit), a second call returns the cached tensor,
a tensor kernel is not cached, a cache first filled under
`torch.inference_mode()` serves autograd, and threads that miss together
keep one tensor. The card's side (no host wait in the eval forward, the
serving pipeline and the train step's spans) is in
tests/test_torch_tracing.py."""

import threading

import numpy as np
import pytest
import torch

from keypointfusion_tpu.geometry import grid as jgrid
from keypointfusion_tpu.ops import codecs as jcodecs
from keypointfusion_torch.geometry import grid as tgrid
from keypointfusion_torch.ops import codecs as tcodecs
from keypointfusion_torch.utils import device as tdevice


@pytest.fixture
def cold(monkeypatch):
    """An empty cache for the test, the process's own restored after."""
    cache = {}
    monkeypatch.setattr(tdevice, '_CONSTANTS', cache)
    return cache


@pytest.mark.parametrize('size', [1, 16, 32, 33])
def test_uv_grid_is_the_jax_grid_and_cached(cold, size):
    first = tgrid.uv_grid(size)
    np.testing.assert_array_equal(first.numpy(), jgrid.uv_grid(size))
    assert first.dtype == torch.float32 and first.shape == (size, size, 2)
    for device in (None, 'cpu', torch.device('cpu')):
        assert tgrid.uv_grid(size, device) is first
    assert list(cold) == [(('uv_grid', size), torch.device('cpu'))]


def test_uv_grid_sizes_are_separate_entries(cold):
    a, b = tgrid.uv_grid(8), tgrid.uv_grid(9)
    assert a.shape == (8, 8, 2) and b.shape == (9, 9, 2)
    assert tgrid.uv_grid(8) is a and tgrid.uv_grid(9) is b
    assert len(cold) == 2


def old_kernel_arr(kernel_size, joint_num):
    """_kernel_arr as it was before the cache: converted on every call."""
    k = torch.as_tensor(kernel_size, dtype=torch.float32)
    if k.ndim == 0:
        k = k.expand(joint_num)
    return k[None, :]


PER_JOINT = [0.8 + 0.01 * i for i in range(21)]


@pytest.mark.parametrize('kernel', [
    0.8, 1, np.float32(0.4), np.float64(0.8), PER_JOINT, tuple(PER_JOINT),
    np.asarray(PER_JOINT, np.float32)],
    ids=['float', 'int', 'np_float32', 'np_float64', 'list', 'tuple',
         'array'])
def test_kernel_arr_values_unchanged_and_cached(cold, kernel):
    got = tcodecs._kernel_arr(kernel, 21, 'cpu')
    want = old_kernel_arr(kernel, 21)
    assert got.dtype == torch.float32 and got.shape == (1, 21)
    assert torch.equal(got, want)
    assert tcodecs._kernel_arr(kernel, 21, 'cpu') is got
    assert len(cold) == 1
    # another joint count is another entry
    if np.ndim(kernel) == 0:
        assert tcodecs._kernel_arr(kernel, 14, 'cpu').shape == (1, 14)
        assert len(cold) == 2


def test_kernel_arr_tensor_is_converted_every_call(cold):
    for kernel in (torch.tensor(0.8), torch.tensor(PER_JOINT,
                                                   dtype=torch.float64)):
        got = tcodecs._kernel_arr(kernel, 21, 'cpu')
        assert torch.equal(got, old_kernel_arr(kernel, 21))
        assert got.dtype == torch.float32
    assert cold == {}


def test_kernel_arr_matches_the_jax_codecs(cold):
    for kernel in (0.8, PER_JOINT):
        np.testing.assert_array_equal(
            tcodecs._kernel_arr(kernel, 21, 'cpu').numpy(),
            np.asarray(jcodecs._kernel_arr(kernel, 21)))


def codec_grads(kernel):
    """joint_to_offset's and pcl_joint_to_offset's outputs and their
    gradients with respect to the joints and the cloud, through a fixed
    weighting of the outputs."""
    rng = np.random.RandomState(0)
    joint = torch.tensor(rng.uniform(-0.6, 0.6, (2, 21, 3)),
                         dtype=torch.float32, requires_grad=True)
    depth = torch.tensor(rng.uniform(-0.9, 1.0, (2, 32, 32, 1)),
                         dtype=torch.float32)
    pcl = torch.tensor(rng.uniform(-0.9, 0.9, (2, 64, 3)),
                       dtype=torch.float32, requires_grad=True)
    dense = tcodecs.joint_to_offset(joint, depth, kernel, 16)
    cloud = tcodecs.pcl_joint_to_offset(joint, pcl, kernel)
    loss = (dense * torch.linspace(-1, 1, dense.shape[-1])).sum() \
        + (cloud * torch.linspace(1, -1, cloud.shape[-1])).sum()
    loss.backward()
    return dense.detach(), cloud.detach(), joint.grad, pcl.grad


@pytest.mark.parametrize('kernel', [0.8, PER_JOINT], ids=['float', 'list'])
def test_cache_filled_under_inference_mode_serves_autograd(monkeypatch,
                                                           kernel):
    """A serving or eval call first (under inference_mode) fills the
    cache; a training forward and backward after it in the same process
    then save the cached kernel row and read the cached grid, and give
    what a cold cache gives."""
    monkeypatch.setattr(tdevice, '_CONSTANTS', {})
    depth = torch.zeros(2, 32, 32, 1)
    joint = torch.zeros(2, 21, 3)
    with torch.inference_mode():
        tcodecs.joint_to_offset(joint, depth, kernel, 16)
        tcodecs.pcl_joint_to_offset(joint, depth.reshape(2, -1, 1)
                                    .expand(2, 1024, 3), kernel)
        tcodecs.offset_to_joint_weight(torch.zeros(2, 16, 16, 105), depth,
                                       kernel)
    filled = dict(tdevice._CONSTANTS)
    assert {key[0] for key, _ in filled} == {'uv_grid', 'kernel_row'}
    assert not any(t.is_inference() for t in filled.values())
    warm = codec_grads(kernel)
    # nothing rebuilt
    assert tdevice._CONSTANTS.keys() == filled.keys()
    assert all(tdevice._CONSTANTS[k] is v for k, v in filled.items())
    monkeypatch.setattr(tdevice, '_CONSTANTS', {})
    for got, want in zip(warm, codec_grads(kernel)):
        assert torch.equal(got, want)


def test_threads_that_miss_together_keep_one_tensor(cold):
    start = threading.Barrier(8)
    got = [None] * 8

    def call(i):
        start.wait()
        got[i] = (tgrid.uv_grid(24), tcodecs._kernel_arr(0.8, 21, 'cpu'))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(cold) == 2
    grid, row = tgrid.uv_grid(24), tcodecs._kernel_arr(0.8, 21, 'cpu')
    for g, r in got:
        assert torch.equal(g, grid) and torch.equal(r, row)
    np.testing.assert_array_equal(grid.numpy(), jgrid.uv_grid(24))
