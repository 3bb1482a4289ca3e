"""The port's multi-device paths on the CPU: parallel/mesh.py, the train
and eval steps under a world-2 gloo process group, the engine's
replicas, the trainer's test() at world 2, the dry run, and
utils/profiling.py.

The world-2 runs are two spawned ranks (parallel/dryrun.py:run_ranks,
one CPU thread each, a FileStore under the test's temporary directory)
running parallel/dryrun.py:train_ranks once for every case below (rank
1 checks that it holds rank 0's state after each step, bit for bit);
the references run in this process. All steps start from the same weights
(tests/torch_port_helpers.py:train_weights), take SGD with momentum at
dropout 0 on synthetic_batch(batch_size=2, point_num=64, seed=42), one
row a rank.

Tolerances:
  * global-batch BatchNorm (sync) at world 2 against the world-1 step on
    the whole batch: in float64 every parameter and every
    running statistic within 1e-9 of its scale (at least the step's
    largest update: a bias before a BatchNorm starts at 0 and holds only
    its own update), and the update over all
    of them at once (L2) within 1e-9 of its norm; in float32 (lr 1e-5)
    within 1e-5; lr 1e-5 in both. The world-1 step runs on one CPU
    thread, as each rank
    does (the model's float32 parts, the pixel sampling and the loss,
    sum in another order on more threads: 2.3e-8 on the first conv's
    weights in float64), under cpu_reference_batch_norms, the two-pass
    statistics the world-2 step takes (torch's one-pass CPU statistics
    lie 1e-4 of scale away in float32, ROADMAP.md §3).
  * per-shard BatchNorm at world 2 against the world-1 steps on each
    half (torch's own BatchNorm, as the ranks take their own
    statistics): their mean gradient applied to the start (SGD's first
    step, in float64) and the mean of their statistics, at the same
    limits. The metrics, the whole batch's, within 1e-5 of themselves in
    both (the loss is taken in float32 in both, ops/loss.py).
  * both policies against the JAX package's make_train_step(cfg,
    make_mesh(2)) on two of tests/conftest.py's virtual CPU devices, both
    sides in float64 (JAX under tests/torch_port_helpers.py:jax_float64),
    at tests/test_torch_port_train_step.py's one-step limits: each
    parameter within max(5% of how far it moved, 5e-6 of its scale, 3
    learning rates), each statistic within 1e-2 of its scale, the loss
    within 1e-4 of itself (measured: the losses 2.7e-7 and 1.8e-7 apart,
    the statistics 4.2e-6 and 4.8e-6 of scale). In float32 the per-shard
    step's row 1 (a batch of 1) puts a point on the other side of a
    ball's edge in block 2 than JAX's float32 does, and JAX's own float32
    per-shard loss lies 2.5e-3 from its float64 one: the float32 losses
    lay 1.6e-3 apart, the global-batch ones 2.2e-6.
  * the eval step's outputs gathered from two ranks against the world-1
    eval of each row, in row order: bit for bit (the whole batch at once
    differs by float32 rounding and, at a ball's edge, by 1.5e-4).
  * two CPU engine replicas against one engine within 1e-5 of each
    packed column group's scale (float32).
  * Trainer.test() at world 2 against world 1 (batch 4, 6 samples, the
    last batch padded): the error within 1e-4 mm, id.txt equal, each
    test_{i}.txt value within 1e-3 mm plus one unit of its 3 decimals.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keypointfusion_tpu.config import Config as JConfig
from keypointfusion_tpu.models.kpfusion import KPFusion as JKPFusion
from keypointfusion_tpu.parallel.mesh import (
    make_mesh, replicated_sharding, shard_batch as j_shard_batch,
)
from keypointfusion_tpu.training.train_step import (
    TrainState as JTrainState, make_optimizer as j_optimizer,
    make_train_step as j_make_train_step,
)
from keypointfusion_tpu.utils.torch_convert import convert_kpfusion_checkpoint

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.synthetic import (
    synthetic_batch, synthetic_dataset, synthetic_frames,
)
from keypointfusion_torch.models import norm
from keypointfusion_torch.models.layers import set_compute_dtype
from keypointfusion_torch.parallel import mesh
from keypointfusion_torch.parallel.dryrun import run_ranks, train_ranks
from keypointfusion_torch.serving import StreamingEngine
from keypointfusion_torch.training.train_step import (
    batch_to_device, create_train_state, make_eval_step, make_train_step,
)
from keypointfusion_torch.training.trainer import Trainer
from keypointfusion_torch.utils import profiling

from tests.torch_port_helpers import (
    cpu_reference_batch_norms, jax_float64, leaf_errors, train_weights,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-5
TOL = {True: 1e-9, False: 1e-5}       # float64: limit of scale
METRIC_TOL = 1e-5    # the loss is float32 in both (ops/loss.py)
MM_TOL = 1e-4
PRINT_UNIT = 1e-3
STEPS = [(f64, sync) for f64 in (True, False) for sync in (True, False)]


def step_config(float64, sync):
    return {'opt': 'sgd', 'lr': LR, 'sync_batchnorm': sync,
            'point_num': 64}


@pytest.fixture(scope='module')
def batch():
    return synthetic_batch(batch_size=2, point_num=64, seed=42)


@pytest.fixture(scope='module')
def weights():
    return train_weights(0)


@pytest.fixture(scope='module')
def trainer_setup(tmp_path_factory, weights):
    """(config fields, test set, model_dir factory) of the trainer case:
    the weights saved as a .pth that load_model reads."""
    root = tmp_path_factory.mktemp('trainer')
    pth = str(root / 'weights.pth')
    torch.save({'model': weights[0]}, pth)
    fields = {'batch_size': 4, 'point_num': 64, 'load_model': pth,
              'pretrain': '', 'phase': 'test'}
    return fields, synthetic_dataset(6, 64, seed=20), root


@pytest.fixture(scope='module')
def world2(tmp_path_factory, batch, weights, trainer_setup):
    """The outputs of the two ranks of one run of train_ranks: each of
    STEPS, the gathered eval, and Trainer.test()."""
    workdir = tmp_path_factory.mktemp('world2')
    fields, test_set, root = trainer_setup
    torch.save({
        'device': 'cpu', 'weights': weights[0],
        'batch': {k: torch.from_numpy(v) for k, v in batch.items()},
        'steps': [{'config': step_config(f64, sync), 'float64': f64}
                  for f64, sync in STEPS],
        'eval_config': {'point_num': 64},
        'trainer': {'config': fields, 'model_dir': str(root / 'world2'),
                    'test_data': [{k: torch.from_numpy(v) for k, v in
                                   s.items()} for s in test_set]},
    }, workdir / 'in.pt')
    run_ranks(2, train_ranks, str(workdir), timeout_s=300)
    return [torch.load(workdir / f'out_{r}.pt', weights_only=True)
            for r in range(2)]


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread, as each rank runs: the float32 parts of
    the model (the pixel sampling, the loss) sum in another order with
    more threads, 2.3e-8 away on the first conv's weights in float64."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def world1_step(weights, batch, float64, two_pass=True):
    """The port's single-process step on `batch` (numpy), its BatchNorm
    statistics taken in two passes (cpu_reference_batch_norms, as the
    global-batch statistics take them) or torch's own way: (state_dict
    before, after, metrics, gradients)."""
    cfg = Config(**step_config(float64, True))
    b = batch_to_device(batch, 'cpu')
    state = create_train_state(cfg, b, device='cpu', seed=0, dropout=0.0)
    state.model.load_state_dict(weights[0])
    if float64:
        set_compute_dtype(state.model.double(), torch.float64)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with (cpu_reference_batch_norms() if two_pass
          else contextlib.nullcontext()), one_thread():
        state, metrics = make_train_step(cfg)(state, b, None, 0)
    grads = {k: p.grad for k, p in state.model.named_parameters()
             if p.grad is not None}
    return before, state.model.state_dict(), metrics, grads


def half(batch, i):
    return {k: v[i:i + 1] for k, v in batch.items()}


def check_state(got, want, before, tol):
    """Every parameter and statistic within `tol` of its scale, the
    scale at least the step's largest update of any parameter (a bias
    before a BatchNorm starts at 0 and holds only its own update, whose
    gradient train-mode BatchNorm makes as noisy as the first layers'),
    and the update over every tensor at once (L2) within `tol` of its
    norm. Returns (the worst tensor's error over its limit, the update's
    relative error)."""
    floats = [k for k, w in want.items() if w.is_floating_point()]
    step = max(float((want[k].double() - before[k].double()).abs().max())
               for k in floats)
    worst, diff, norm = 0.0, 0.0, 0.0
    for k, w in want.items():
        if k not in floats:
            assert torch.equal(got[k], w), k
            continue
        g, w, b = got[k].double(), w.double(), before[k].double()
        scale = max(float(w.abs().max()), step)
        err = float((g - w).abs().max())
        assert err <= tol * scale, (k, err, scale)
        worst = max(worst, err / (tol * scale))
        diff += float((g - w).square().sum())
        norm += float((w - b).square().sum())
    update = (diff / norm) ** 0.5
    assert update <= tol, update
    return worst, update


# -------------------------------------------------------------- mesh --

def test_auto_world_and_shard_bounds():
    assert mesh.auto_world(64, 8) == 8
    assert mesh.auto_world(6, 4) == 3
    assert mesh.auto_world(7, 4) == 1
    assert [mesh.shard_bounds(6, r, 3) for r in range(3)] == [
        (0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError, match='not divisible'):
        mesh.shard_bounds(5, 0, 2)
    b = {'x': np.arange(12).reshape(2, 6), 'y': torch.arange(6)[None]
         .expand(2, 6)}
    stacked = mesh.shard_batch(b, 1, 3, axis=1)
    np.testing.assert_array_equal(stacked['x'], [[2, 3], [8, 9]])
    assert stacked['y'].tolist() == [[2, 3], [2, 3]]
    with pytest.raises(ValueError, match='mixes sizes'):
        mesh.shard_batch({'a': np.zeros(2), 'b': np.zeros(3)}, 0, 1)
    with pytest.raises(ValueError, match='unknown backend'):
        mesh.init_process_group('mpi', 0, 1, init_method='tcp://x:1')


@pytest.mark.parametrize('kind', ['nchw', 'channels_last', 'weighted'])
def test_global_batch_norm_matches_local_at_world1(tmp_path, kind):
    """models/norm.py:global_batch_norm called on a gloo group of one rank
    (its all-reduces then sum one rank's terms) against the local forms
    (BatchNorm2d, TorchBatchNorm, weighted_batch_norm), float64: the
    outputs, the input gradients and the running statistics within
    1e-12 of scale."""
    import torch.distributed as dist
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 5, 8, generator=gen, dtype=torch.float64) * 2 + 1
    w = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    weights = torch.randint(0, 4, (2, 3, 5), generator=gen).double()
    if kind == 'nchw':
        local = norm.BatchNorm2d(3)
    else:
        local = norm.WeightedTorchBatchNorm(8)
    local = local.double().train()
    set_compute_dtype(local, torch.float64)
    with torch.no_grad():
        local.running_mean.uniform_(-1, 1, generator=gen)
        local.weight.uniform_(0.5, 1.5, generator=gen)
        local.bias.uniform_(-1, 1, generator=gen)
    synced = copy.deepcopy(local)
    group = mesh.init_process_group(
        'gloo', 0, 1, store=dist.FileStore(str(tmp_path / 'store'), 1))
    try:
        xs = [x.clone().requires_grad_() for _ in range(2)]
        if kind == 'weighted':
            want = norm.weighted_batch_norm(xs[0], weights, local)
            got = norm.global_batch_norm(xs[1], synced, group, weights)
        else:
            want = local(xs[0])
            got = norm.global_batch_norm(
                xs[1], synced, group, channel_dim=1 if kind == 'nchw'
                else -1)
        grads = [torch.autograd.grad((y * w).sum(), xi)[0]
                 for y, xi in ((want, xs[0]), (got, xs[1]))]
    finally:
        dist.destroy_process_group()
    for a, b in ((got, want), (grads[1], grads[0]),
                 (synced.running_mean, local.running_mean),
                 (synced.running_var, local.running_var)):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    assert int(synced.num_batches_tracked) == 1


# ---------------------------------------------------- world-2 steps --

@pytest.mark.parametrize('float64', [True, False])
def test_sync_batchnorm_step_matches_world1(world2, weights, batch,
                                            float64):
    """Both ranks end with the world-1 step's state on the whole batch;
    the metrics are the whole batch's."""
    i = STEPS.index((float64, True))
    before, want, metrics, _ = world1_step(weights, batch, float64)
    worst = check_state(world2[0]['steps'][i]['state'], want, before,
                        TOL[float64])
    for k, v in metrics.items():
        got = world2[0]['steps'][i]['metrics'][k]
        assert abs(got - float(v)) <= METRIC_TOL * max(1.0, abs(float(v))), \
            k
    print('worst over the limit', worst)


@pytest.mark.parametrize('float64', [True, False])
def test_per_shard_step_matches_mean_of_halves(world2, weights, batch,
                                               float64):
    """Per-shard statistics: the world-1 steps on each row, their mean
    gradient applied to the start (SGD's first step, in float64) and
    their statistics' mean."""
    i = STEPS.index((float64, False))
    halves = [world1_step(weights, half(batch, r), float64, two_pass=False)
              for r in range(2)]
    before, lr = halves[0][0], step_config(float64, False)['lr']
    want = {k: (halves[0][1][k].double() + halves[1][1][k].double()) / 2
            if v.is_floating_point() else v
            for k, v in halves[0][1].items()}
    for k, g in halves[0][3].items():
        want[k] = before[k].double() - lr * (
            g.double() + halves[1][3][k].double()) / 2
    worst = check_state(world2[0]['steps'][i]['state'], want, before,
                        TOL[float64])
    loss = (float(halves[0][2]['loss']) + float(halves[1][2]['loss'])) / 2
    assert abs(world2[1]['steps'][i]['metrics']['loss'] - loss) <= \
        METRIC_TOL * abs(loss)
    print('worst over the limit', worst)


@pytest.fixture(scope='module')
def jax_mesh_steps(weights, batch):
    """JAX's 2-device mesh step under each BatchNorm policy, in float64
    (tests/torch_port_helpers.py:jax_float64, whose x64 switch holds for
    this thread only): {sync: (variables after, loss)}."""
    mesh2 = make_mesh(2)

    def step(sync):
        cfg = JConfig(opt='sgd', lr=LR, sync_batchnorm=sync)
        tx = j_optimizer(cfg, steps_per_epoch=1000)
        v = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                   weights[1])
        state = jax.device_put(JTrainState(
            step=jnp.zeros((), jnp.int32), params=v['params'],
            batch_stats=v['batch_stats'], opt_state=tx.init(v['params']),
            tx=tx, model=JKPFusion(joint_num=21, dropout=0.0,
                                   dtype=jnp.float64)),
            replicated_sharding(mesh2))
        jb = j_shard_batch({k: jnp.asarray(x) for k, x in batch.items()},
                           mesh2)
        state, metrics = j_make_train_step(cfg, mesh2)(
            state, jb, jax.random.PRNGKey(0), jnp.zeros((), jnp.int32))
        return (jax.tree_util.tree_map(np.asarray, {
            'params': state.params, 'batch_stats': state.batch_stats}),
            float(metrics['loss']))

    with jax_float64():
        return {sync: step(sync) for sync in (True, False)}


@pytest.mark.parametrize('sync', [True, False])
def test_steps_match_jax_mesh(world2, weights, jax_mesh_steps, sync):
    """Each policy's world-2 float64 step against JAX's mesh step."""
    want, want_loss = jax_mesh_steps[sync]
    run = world2[0]['steps'][STEPS.index((True, sync))]
    got = convert_kpfusion_checkpoint(run['state'])
    start = leaf_errors(got['params'], weights[1]['params'])
    worst = {'params': 0.0, 'stats': 0.0}
    for path, (e, s) in leaf_errors(got['params'],
                                    want['params']).items():
        tol = max(0.05 * start[path][0], 5e-6 * s, 3 * LR)
        worst['params'] = max(worst['params'], e / tol)
        assert e <= tol, (path, e, tol)
    for path, (e, s) in leaf_errors(got['batch_stats'],
                                    want['batch_stats']).items():
        worst['stats'] = max(worst['stats'], e / max(1.0, s))
        assert e <= 1e-2 * max(1.0, s), (path, e)
    loss = run['metrics']['loss']
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss), (loss, want_loss)
    print('measured', worst, loss, want_loss)


def test_eval_step_gathered_in_row_order(world2, weights, batch):
    """Every output of the gathered eval is the world-1 eval of each row,
    in row order, bit for bit (one CPU thread on both sides)."""
    cfg = Config(point_num=64)
    state = create_train_state(cfg, batch_to_device(batch, 'cpu'),
                               device='cpu', seed=0, dropout=0.0)
    state.model.load_state_dict(weights[0])
    rows = []
    with one_thread():
        for r in range(2):
            results, sw = make_eval_step(cfg)(
                state, batch_to_device(half(batch, r), 'cpu'))
            rows.append(results + sw)
    got = world2[0]['eval']
    assert len(got) == len(rows[0])
    for g, *w in zip(got, *rows):
        assert torch.equal(g, torch.cat(w))
    # the rows are not alike, so a swapped order would show
    assert not torch.equal(rows[0][-1], rows[1][-1])


def test_trainer_test_at_world2(world2, trainer_setup, tmp_path):
    """Trainer.test() at world 2 (rank 0 writes) against world 1."""
    fields, test_set, root = trainer_setup
    want = Trainer(Config(**fields), test_data=test_set, device='cpu',
                   model_dir=str(tmp_path), loader_threads=1).test()
    errors = [out['trainer_error'] for out in world2]
    assert all(abs(e - want) <= MM_TOL for e in errors), (errors, want)
    got_dir = root / 'world2'
    assert (got_dir / 'id.txt').read_text() == \
        (tmp_path / 'id.txt').read_text() == ''.join(
            f'{i}\n' for i in range(6))
    for i in range(len(Config().stage_type)):
        g = np.loadtxt(got_dir / f'test_{i}.txt')
        w = np.loadtxt(tmp_path / f'test_{i}.txt')
        assert g.shape == w.shape == (6, 63)
        assert np.abs(g - w).max() <= PRINT_UNIT + MM_TOL


def test_cli_under_torch_distributed_run(tmp_path, capsys):
    """python -m torch.distributed.run --nproc_per_node 3 runs the CLI's
    --phase test on gloo ranks (tests/torch_port_cli_cpu.py, the CPU asked
    for) at batch 2: the world is 2 and rank 2 stays idle; rank 0 alone
    prints the summary, whose error is the in-process world-1 run's (one
    loader thread both)."""
    import json
    fixture = os.path.join(REPO, 'tests', 'fixtures', 'torch_port_dexycb')
    args = ['--phase', 'test', '--dataset', 'dexycb', '--root_dir',
            fixture, '--batch_size', '2', '--point_num', '64',
            '--pretrain', '', '--loader_threads', '1']
    from keypointfusion_torch import train as cli
    _, want = cli.main(args + ['--save_dir', str(tmp_path / 'one')],
                       device='cpu')
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    done = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '3', '-m', 'tests.torch_port_cli_cpu', *args,
         '--save_dir', str(tmp_path / 'two')],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    lines = [json.loads(ln) for ln in done.stdout.splitlines()
             if ln.startswith('{')]
    assert len(lines) == 1, done.stdout
    assert 'rank 2 is outside the world of 2 ranks' in done.stdout
    assert lines[0]['phase'] == 'test' and lines[0]['test_samples'] == 4
    assert abs(lines[0]['result'] - want) <= MM_TOL, (lines[0], want)


# ------------------------------------------------------------ serving --

def test_engine_replicas_match_one_engine():
    """Two CPU replicas answer each batch as one engine does, row for
    row, and draw the same points."""
    cfg = Config(point_num=64)
    frames = synthetic_frames(4, 120, 160, np.random.RandomState(3))
    args = [frames[k] for k in ('depth', 'rgb', 'centers', 'cube', 'cam')]
    one = StreamingEngine(cfg, batch_size=4, img_hw=(120, 160),
                          dtype=torch.float32, device='cpu')
    two = StreamingEngine(cfg, batch_size=4, img_hw=(120, 160),
                          dtype=torch.float32, device='cpu',
                          devices=['cpu', 'cpu'])
    assert len(two.replicas) == 2
    assert two.replicas[1].model is not two.model
    for _ in range(2):
        want, got = one.submit(*args), two.submit(*args)
        assert got.shape == want.shape == (4, 135)
        for lo, hi in ((0, 63), (63, 126), (126, 135)):
            scale = max(1.0, float(want[:, lo:hi].abs().max()))
            assert float((got[:, lo:hi] - want[:, lo:hi]).abs().max()) \
                <= 1e-5 * scale


def test_engine_indivisible_batch_raises():
    with pytest.raises(ValueError, match='not divisible'):
        StreamingEngine(Config(point_num=64), batch_size=3,
                        img_hw=(120, 160), device='cpu',
                        devices=['cpu', 'cpu'])


# ------------------------------------------------------------ dry run --

def test_dryrun_two_ranks():
    """python -m keypointfusion_torch.parallel.dryrun 2: every section's
    mark line, exit 0 (the ranks check that they loaded no JAX module)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run(
        [sys.executable, '-m', 'keypointfusion_torch.parallel.dryrun', '2'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    for section in ('init', 'sync-BN', 'per-shard-BN', 'serving/replicas',
                    'eval+ckpt'):
        assert f'dryrun(2) [{section}]: ok' in done.stdout, done.stdout


# ---------------------------------------------------------- profiling --

def test_profiling_trace_and_step_timer(tmp_path):
    """trace() writes a Chrome trace holding the port's spans nested as
    they were opened, around the operators they ran (the step timer,
    which nothing read, is gone)."""
    with profiling.trace(str(tmp_path)):
        with profiling.span('kpf.outer'):
            with profiling.span('kpf.inner'):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = [e for e in json.loads((tmp_path / 'trace.json').read_text())[
        'traceEvents'] if e.get('ph') == 'X']
    spans = {e['name']: (e['ts'], e['ts'] + e['dur']) for e in events
             if e['name'].startswith('kpf.')}
    assert set(spans) == {'kpf.outer', 'kpf.inner'}
    (o0, o1), (i0, i1) = spans['kpf.outer'], spans['kpf.inner']
    assert o0 <= i0 <= i1 <= o1
    (mm,) = [e for e in events if e['name'] == 'aten::mm']
    assert i0 <= mm['ts'] <= mm['ts'] + mm['dur'] <= i1
    assert not hasattr(profiling, 'StepTimer')
