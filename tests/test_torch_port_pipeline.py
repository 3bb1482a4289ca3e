"""Port parity of the host input pipeline (keypointfusion_torch/data/
pipeline.py) against keypointfusion_tpu/data/pipeline.py: the same
dataset and seed give the same batches, element for element and in the
same order (exact: both sides shuffle with numpy and stack the same
arrays). device_prefetch on the CPU hands out the same tensors in the
same order; its pinned-memory path is held on the card by
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

from keypointfusion_tpu.data.pipeline import BatchLoader as JBatchLoader
from keypointfusion_torch.data.pipeline import BatchLoader, device_prefetch


class IndexedDataset:
    """Sample i holds arrays that name i, in two dtypes."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return {'x': rng.normal(size=(3, 2)).astype(np.float32),
                'i': np.array(i, np.int64)}


def batches(loader, epochs):
    return [b for _ in range(epochs) for b in loader]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize('shuffle,drop_last,process', [
    (True, True, (0, 1)), (True, False, (0, 1)), (False, False, (0, 1)),
    (True, True, (0, 2)), (True, False, (1, 2))])
def test_batch_loader_matches_jax(shuffle, drop_last, process):
    """11 samples at batch 3, two epochs through one loader (the shuffle
    takes seed + epoch), with and without drop_last, alone and as each
    of 2 processes."""
    ds = IndexedDataset(11)
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=3,
              drop_last=drop_last, seed=5, process_index=process[0],
              process_count=process[1])
    port, jax_loader = BatchLoader(ds, **kw), JBatchLoader(ds, **kw)
    assert len(port) == len(jax_loader)
    got, want = batches(port, 2), batches(jax_loader, 2)
    assert_same(got, want)
    order = [int(i) for b in got for i in b['i']]
    if shuffle:
        assert order[:len(order) // 2] != order[len(order) // 2:]
    print('order', order)


def test_device_prefetch_on_cpu_is_a_plain_move():
    """device_prefetch(device='cpu') gives every batch, in order, as CPU
    tensors equal to the loader's arrays; without a card and without
    device='cpu' it raises."""
    ds = IndexedDataset(10)
    want = list(BatchLoader(ds, 3, shuffle=True, seed=1, drop_last=False))
    got = list(device_prefetch(
        iter(BatchLoader(ds, 3, shuffle=True, seed=1, drop_last=False)),
        'cpu', depth=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in w:
            assert g[k].device.type == 'cpu'
            assert np.array_equal(g[k].numpy(), w[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            next(device_prefetch(iter(want)))
