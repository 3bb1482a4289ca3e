"""Process groups and batch slices for multi-card training (port of
keypointfusion_tpu/parallel/mesh.py, the counterpart of the reference's
torch.nn.DataParallel).

The JAX package runs one controller over a 1-D device mesh: the batch is
sharded over the mesh's axis (P('data')), the parameters replicated, and
XLA inserts the collectives. The port runs in torch's idiom instead: one
process (a rank) per card under torch.distributed, each holding the whole
model and its contiguous slice of every global batch, with the
collectives written out (training/train_step.py). A torch process group
has no axis names, so the JAX package's `mesh_axis` has no counterpart.

Everything here takes `group=None` to mean no process group: one process,
a world of 1, which runs the single-process code paths unchanged.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')


def auto_world(batch_size: int, world: int) -> int:
    """The largest size <= `world` that divides batch_size: the JAX
    package's auto_mesh, which keeps batch sharding legal for any
    configured batch."""
    if batch_size < 1 or world < 1:
        raise ValueError(f'batch_size {batch_size} and world {world} must '
                         f'be positive')
    return max(d for d in range(1, world + 1) if batch_size % d == 0)


def shard_bounds(batch_size: int, rank: int, world: int) -> Tuple[int, int]:
    """Rows [lo, hi) of a global batch that `rank` of `world` holds:
    contiguous equal slices in rank order, as P('data') places a batch
    over a mesh."""
    if batch_size % world:
        raise ValueError(f'batch_size {batch_size} is not divisible by the '
                         f'world size {world}')
    if not 0 <= rank < world:
        raise ValueError(f'rank {rank} is outside a world of {world}')
    per = batch_size // world
    return rank * per, (rank + 1) * per


def shard_batch(batch: Dict, rank: int, world: int, axis: int = 0) -> Dict:
    """`rank`'s rows of every array (numpy or torch) of `batch` along
    `axis`: 0 for [B, ...] batches, 1 for the [G, B, ...] step-stacked
    batches of make_train_step_scan (the JAX package's
    stacked_batch_sharding)."""
    sizes = {v.shape[axis] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f'the batch mixes sizes {sorted(sizes)} on axis '
                         f'{axis}')
    lo, hi = shard_bounds(sizes.pop(), rank, world)
    index = (slice(None),) * axis + (slice(lo, hi),)
    return {k: v[index] for k, v in batch.items()}


def world_size(group) -> int:
    """The number of ranks of `group` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    """This process's rank within `group` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def init_process_group(backend: str, rank: Optional[int] = None,
                       world: Optional[int] = None,
                       store: Optional[dist.Store] = None,
                       init_method: Optional[str] = None,
                       timeout_s: float = 600.0):
    """Join the default process group and return it.

    With rank and world both None, they come from the environment that
    `python -m torch.distributed.run` sets (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT). Otherwise they are given, with either a
    `store` (a torch.distributed.FileStore under a test's temporary
    directory needs no port) or an `init_method` such as
    'tcp://localhost:PORT'. `backend` is 'nccl' (CUDA tensors) or 'gloo'
    (CPU tensors, and CUDA ones through the host) and is used as named:
    nothing picks another for the caller."""
    if backend not in BACKENDS:
        raise ValueError(f'unknown backend {backend!r}; expected one of '
                         f'{BACKENDS}')
    timeout = datetime.timedelta(seconds=timeout_s)
    if rank is None and world is None:
        if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
            raise RuntimeError('RANK and WORLD_SIZE are not set: launch with '
                               'python -m torch.distributed.run, or pass '
                               'rank and world')
        dist.init_process_group(backend, init_method='env://',
                                timeout=timeout)
    elif rank is None or world is None:
        raise ValueError('pass rank and world together')
    else:
        if (store is None) == (init_method is None):
            raise ValueError('pass exactly one of store and init_method')
        dist.init_process_group(backend, store=store,
                                init_method=init_method, rank=rank,
                                world_size=world, timeout=timeout)
    return dist.group.WORLD


def subgroup(group, world: int):
    """The first `world` ranks of `group` as a group of their own (the
    whole group when `world` is its size). Every rank of the default group
    must call this, members or not; a non-member gets None."""
    if world == world_size(group):
        return group
    ranks = [dist.get_global_rank(group, r) for r in range(world)]
    sub = dist.new_group(ranks)
    return sub if dist.get_rank() in ranks else None


def _flat_apply(tensors: Iterable[torch.Tensor],
                fn: Callable[[torch.Tensor], None]) -> None:
    """Run the in-place collective `fn` once per (device, dtype) on one
    flat buffer holding every tensor of that kind, then copy the results
    back into the tensors."""
    kinds: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        kinds.setdefault((t.device, t.dtype), []).append(t)
    for ts in kinds.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        fn(flat)
        offset = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def all_mean(tensors: Iterable[torch.Tensor], group) -> None:
    """Replace each floating tensor by its mean over the ranks of `group`
    (in place; one all_reduce per device and dtype)."""
    world = world_size(group)
    if world == 1:
        return

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)
    _flat_apply(tensors, mean)


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over the ranks of `group`, without
    gradient (`t` itself at a world of 1)."""
    if world_size(group) == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def broadcast_module(module: torch.nn.Module, group, src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers (BatchNorm statistics and
    counters) into every rank's `module` of `group`: the counterpart of
    the JAX package's replicated_sharding for a state built apart on each
    rank."""
    if world_size(group) == 1:
        return
    root = dist.get_global_rank(group, src)
    _flat_apply(list(module.parameters()) + list(module.buffers()),
                lambda flat: dist.broadcast(flat, root, group=group))


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order: the rows
    of the global batch in order, as out_shardings=P('data') returns
    them."""
    world = world_size(group)
    if world == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)
