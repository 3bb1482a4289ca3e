"""Multi-process dry run of the port's multi-device paths, and the rank
runner it shares with the tests and chip_smoke.py (port of
keypointfusion_tpu/parallel/dryrun.py).

    python -m keypointfusion_torch.parallel.dryrun N

spawns N ranks on the CPU under one gloo process group (a FileStore in a
temporary directory, so no port is opened) and runs, on tiny shapes,
one section after another, each ending in a mark line printed by rank 0:
  * the train step under both BatchNorm policies (global-batch
    statistics, and per-shard statistics averaged over the ranks);
  * the streaming engine with N replicas at img_hw=(120, 160), on rank
    0 alone (serving is single-controller);
  * the sharded eval step, its results gathered in row order, through
    xyz_to_error_mm, pa_error_mm and the dense stage's decode;
  * a checkpoint written by rank 0 and restored by every rank.
It exits non-zero when a section fails. The JAX dry run uses N virtual
CPU devices of one process; here each rank is a process, as each card's
rank is under torch.distributed.run.

`run_ranks(world, fn, *args)` runs fn(rank, world, group, *args) in
`world` spawned processes: fn must be a module-level function of the
port, so that a child imports torch and the port only (the dry run's
ranks check that no JAX module was loaded). Each child takes one CPU
thread. `train_ranks` is the rank worker of the multi-rank checks.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from keypointfusion_torch.parallel.mesh import init_process_group


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    group = init_process_group(backend, rank, world, store=store)
    try:
        fn(rank, world, group, *args)
        dist.barrier(group)
    finally:
        dist.destroy_process_group()


def _child(rank, world, store_path, backend, fn, args, errors):
    try:
        _rank_main(rank, world, store_path, backend, fn, args)
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise


def run_ranks(world: int, fn: Callable, *args, backend: str = 'gloo',
              timeout_s: float = 600.0) -> None:
    """fn(rank, world, group, *args) in `world` spawned processes joined
    in one `backend` process group. Raises with the failing ranks'
    tracebacks when one fails or the run outlasts timeout_s; every child
    is ended before it returns."""
    ctx = multiprocessing.get_context('spawn')
    tmp = tempfile.mkdtemp(prefix='kpf_ranks_')
    errors = ctx.SimpleQueue()
    procs = [ctx.Process(target=_child, args=(
        r, world, os.path.join(tmp, 'store'), backend, fn, args, errors))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if not p.is_alive() and p.exitcode != 0]
        if late or failed:
            report = []
            while not errors.empty():
                r, tb = errors.get()
                report.append(f'rank {r}:\n{tb}')
            raise RuntimeError(
                f'{fn.__name__} on {world} ranks: still running after '
                f'{timeout_s} s {late}, failed (rank, exit code) {failed}\n'
                + '\n'.join(report))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------- the checks' worker --

def _check_replicas(model: torch.nn.Module, group) -> None:
    """Raise unless this rank's parameters and statistics equal the
    group's rank 0's bit for bit."""
    mine = torch.cat([t.detach().reshape(-1).double() for t in
                      list(model.parameters()) + list(model.buffers())])
    theirs = mine.clone()
    dist.broadcast(theirs, dist.get_global_rank(group, 0), group=group)
    if not torch.equal(mine, theirs):
        raise AssertionError(f'rank {dist.get_rank(group)} left rank 0\'s '
                             f'state: max difference '
                             f'{float((mine - theirs).abs().max())}')


def train_ranks(rank: int, world: int, group, workdir: str) -> None:
    """The rank worker of the multi-rank checks
    (tests/test_torch_port_parallel.py, chip_smoke.py's [parallel]
    phase). Reads workdir/in.pt (torch.save of a dict) and writes
    workdir/out_{rank}.pt:
      * 'steps': for each entry {'config', 'float64'} of the input's
        'steps', one make_train_step(Config(**config), group) step from
        'weights' (dropout 0, no generator; float64 arithmetic when
        'float64') on this rank's rows of 'batch': the metrics, and on
        rank 0 the state_dict after it (and with 'grads' the averaged
        gradients) on the CPU; every other rank checks that it holds
        rank 0's state bit for bit (the ranks stay replicas);
      * 'eval' [results..., spatial weights...]: with 'eval_config', the
        eval step's outputs gathered from every rank;
      * 'trainer_error': with 'trainer' {'config', 'test_data',
        'model_dir'}, Trainer(...).test() under the group, one loader
        thread.
    'device' names the rank's device."""
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.models.layers import set_compute_dtype
    from keypointfusion_torch.parallel.mesh import shard_batch
    from keypointfusion_torch.training.train_step import (
        create_train_state, make_eval_step, make_train_step,
    )
    from keypointfusion_torch.training.trainer import Trainer

    spec = torch.load(os.path.join(workdir, 'in.pt'), weights_only=True)
    device = torch.device(spec['device'])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    batch = {k: v.to(device) for k, v in spec['batch'].items()}
    rows = shard_batch(batch, rank, world)
    host = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}

    def state_for(cfg, float64=False):
        state = create_train_state(cfg, batch, device=device, seed=0,
                                   dropout=0.0)
        state.model.load_state_dict(spec['weights'])
        if float64:
            set_compute_dtype(state.model.double(), torch.float64)
        return state

    out = {'steps': []}
    for run in spec.get('steps', ()):
        cfg = Config(**run['config'])
        state, metrics = make_train_step(cfg, group)(
            state_for(cfg, run.get('float64', False)), rows, None, 0)
        model = state.model
        _check_replicas(model, group)
        done = {'metrics': {k: float(v) for k, v in metrics.items()}}
        if rank == 0:
            done['state'] = host(model.state_dict())
            if spec.get('grads'):
                done['grads'] = host({k: p.grad for k, p in
                                      model.named_parameters()
                                      if p.grad is not None})
        out['steps'].append(done)
    if 'eval_config' in spec:
        cfg = Config(**spec['eval_config'])
        results, sw = make_eval_step(cfg, group)(state_for(cfg), rows)
        if rank == 0:
            out['eval'] = [t.cpu() for t in results + sw]
    if 'trainer' in spec:
        t = spec['trainer']
        data = [{k: v.numpy() for k, v in s.items()} for s in t['test_data']]
        trainer = Trainer(Config(**t['config']), test_data=data,
                          device=device, model_dir=t['model_dir'],
                          loader_threads=1, group=group)
        out['trainer_error'] = trainer.test()
    torch.save(out, os.path.join(workdir, f'out_{rank}.pt'))


# ------------------------------------------------------------ the run --

def _dryrun_rank(rank: int, world: int, group, t_start: float,
                 ckpt_dir: str) -> None:
    from keypointfusion_torch.config import Config
    from keypointfusion_torch.data.synthetic import (
        synthetic_batch, synthetic_frames,
    )
    from keypointfusion_torch.geometry.camera import uvd_nl_to_xyz_nl
    from keypointfusion_torch.ops.codecs_extra import feature_to_joint
    from keypointfusion_torch.parallel.mesh import (
        broadcast_module, shard_batch,
    )
    from keypointfusion_torch.serving import StreamingEngine
    from keypointfusion_torch.training.metrics import (
        pa_error_mm, xyz_to_error_mm,
    )
    from keypointfusion_torch.training.train_step import (
        batch_to_device, create_train_state, frame_from_batch,
        make_eval_step, make_train_step,
    )
    from keypointfusion_torch.training.trainer import Checkpointer

    def mark(section, extra=''):
        if rank == 0:
            print(f'dryrun({world}) [{section}]: ok{extra} '
                  f'(t+{time.time() - t_start:.0f}s)', flush=True)

    batch = batch_to_device(synthetic_batch(batch_size=world, point_num=128),
                            'cpu')
    rows = shard_batch(batch, rank, world)

    def fresh_state(cfg):
        state = create_train_state(cfg, batch, device='cpu', seed=0)
        broadcast_module(state.model, group)
        return state

    mark('init', f', world={world}')
    for sync in (True, False):
        cfg = Config(sync_batchnorm=sync)
        state = fresh_state(cfg)
        gen = torch.Generator().manual_seed(1000 + rank)
        state, metrics = make_train_step(cfg, group)(state, rows, gen, 0)
        loss = float(metrics['loss'])
        if not np.isfinite(loss):
            raise AssertionError(f'non-finite loss {loss}')
        mark('sync-BN' if sync else 'per-shard-BN', f', loss={loss:.4f}')

    if rank == 0:
        bs = max(world, 2)
        engine = StreamingEngine(Config(phase='test', point_num=128),
                                 batch_size=bs, img_hw=(120, 160),
                                 device='cpu', devices=['cpu'] * world)
        frames = synthetic_frames(bs, 120, 160, np.random.RandomState(0))
        packed = engine.submit(frames['depth'], frames['rgb'],
                               frames['centers'], frames['cube'],
                               frames['cam'])
        if not torch.isfinite(packed).all():
            raise AssertionError('non-finite serving output')
        mark('serving/replicas', f', out={tuple(packed.shape)}')
    dist.barrier(group)

    cfg = Config()
    state = fresh_state(cfg)
    results, _ = make_eval_step(cfg, group)(state, rows)
    frame = frame_from_batch(batch, cfg)
    err = xyz_to_error_mm(results[-1], batch['xyz_gt'], batch['center'],
                          batch['cube'])
    pa = pa_error_mm(results[-1], batch['xyz_gt'], batch['center'],
                     batch['cube'])
    joint_uvd = feature_to_joint(batch['depth'], results[0],
                                 cfg.feature_type, cfg.feature_para,
                                 joint_num=cfg.joint_num)
    xyz0 = uvd_nl_to_xyz_nl(joint_uvd, frame)
    if not (err.shape[0] == world and torch.isfinite(err).all()
            and torch.isfinite(pa).all() and torch.isfinite(xyz0).all()):
        raise AssertionError('sharded eval gave non-finite or short results')

    ck = Checkpointer(ckpt_dir)
    if rank == 0:
        ck.save('latest', state, epoch=1, min_error=float(err.mean()))
    dist.barrier(group)
    restored, epoch, _, plateau = ck.restore('latest', fresh_state(cfg))
    if epoch != 1 or plateau != 0:
        raise AssertionError((epoch, plateau))
    for a, b in zip(state.model.state_dict().values(),
                    restored.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError('the restored state differs')
    mark('eval+ckpt', f', err={float(err.mean()):.2f}mm '
         f'pa={float(pa.mean()):.2f}mm')
    jax = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                        'keypointfusion_tpu'))
    if jax:
        raise AssertionError(f'a rank imported JAX modules: {jax[:5]}')


def run(world: int) -> None:
    """The dry run on `world` gloo CPU ranks."""
    t_start = time.time()
    print(f'dryrun({world}): starting {world} gloo ranks on the CPU',
          flush=True)
    ckpt_dir = tempfile.mkdtemp(prefix='kpf_dryrun_ckpt_')
    try:
        run_ranks(world, _dryrun_rank, t_start, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f'dryrun({world}): done (t+{time.time() - t_start:.0f}s)',
          flush=True)


if __name__ == '__main__':
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
