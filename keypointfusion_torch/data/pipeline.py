"""Host input pipeline (port of keypointfusion_tpu/data/pipeline.py):
threaded sample loading and collation, and batches copied to the card
ahead of the step that takes them.

`BatchLoader` gives the JAX loader's batches in the JAX loader's order
for the same dataset and seed: a thread pool, np.random.RandomState(seed
+ epoch) shuffles, drop_last, and each of process_count processes taking
every process_count-th index of the shuffled order. With `shard=(rank,
world)` it loads only the rows that rank holds of each global batch
(parallel/mesh.py:shard_bounds), from the one shuffled order every rank
draws alike. `device_prefetch`
copies each batch from pinned host memory on a side CUDA stream `depth`
batches ahead of the consumer.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import itertools
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from keypointfusion_torch.parallel.mesh import shard_bounds
from keypointfusion_torch.utils.device import resolve_device


def collate(samples) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    """Iterable over collated numpy batches, loaded by background
    threads."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = True,
                 seed: int = 0, max_prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 shard: Tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.max_prefetch = max_prefetch
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.shard = shard
        self._epoch = 0

    def _local_len(self):
        return len(self.dataset) // self.process_count

    def __len__(self):
        n = self._local_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count][
                :self._local_len()]
        self._epoch += 1
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.shard[1] > 1:
            batches = [b[slice(*shard_bounds(len(b), *self.shard))]
                       for b in batches]

        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()

            def submit(idxs):
                pending.append([pool.submit(self.dataset.__getitem__, i)
                                for i in idxs])

            it = iter(batches)
            for idxs in itertools.islice(it, self.max_prefetch):
                submit(idxs)
            for idxs in it:
                ready = pending.popleft()
                submit(idxs)
                yield collate([f.result() for f in ready])
            while pending:
                yield collate([f.result() for f in pending.popleft()])


def device_prefetch(batch_iter: Iterable[Dict[str, np.ndarray]],
                    device=None, depth: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """The batches of `batch_iter` (dicts of numpy arrays) as tensors on
    `device` (the CUDA card unless another is named), `depth` batches
    ahead.

    On the card each batch is copied into pinned host memory and from
    there, without blocking, on a side stream. The consuming stream waits
    on the copy's event before the batch is handed out, and every tensor
    is marked used by it (record_stream), so the caching allocator does
    not hand its memory on while the consumer still reads it. Each pinned
    buffer is held until its copy's event has completed, and no buffer is
    reused: a buffer freed early would be overwritten under the copy. On
    the CPU each batch is a plain move."""
    device = resolve_device(device)
    if device.type != 'cuda':
        for batch in batch_iter:
            yield {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        return

    side = torch.cuda.Stream(device)
    ahead = collections.deque()     # (tensors on the card, copy event)
    held = collections.deque()      # (copy event, pinned buffers)

    def put(batch):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(side):
            out = {k: t.to(device, non_blocking=True)
                   for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(side)
        ahead.append((out, done))
        held.append((done, pinned))
        while held and held[0][0].query():
            held.popleft()

    try:
        it = iter(batch_iter)
        for batch in itertools.islice(it, depth):
            put(batch)
        while ahead:
            out, done = ahead.popleft()
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in out.values():
                t.record_stream(consumer)
            batch = next(it, None)
            if batch is not None:
                put(batch)
            yield out
    finally:
        for done, _ in held:
            if not done.query():
                done.synchronize()
        held.clear()
