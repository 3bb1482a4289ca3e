"""The port's spans and host-wait counter (utils/profiling.py), and the
per-layer metrics of portbench/metrics/ that read them.

On the CPU: a span with the profiler off is the shared no-op; under
torch.profiler a small StreamingEngine and one train step open each span
once a request or a step, the registry holding one traced window; the
profiler changes no output; and each new metric reads, through the
benchmark's small runs, a positive host time, 0 host waits, and no
device time. The tests marked `cuda` count host waits on the card, find
the kernels' spans in the device trace, hold the float32 eval forward and
the serving pipeline to no host wait at all (torch's sync debug mode set
to 'error'), and find none counted in the train step's forward and loss:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tracing.py
"""

import contextlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from keypointfusion_torch.config import Config
from keypointfusion_torch.data.synthetic import (
    synthetic_batch, synthetic_frames,
)
from keypointfusion_torch.serving import StreamingEngine
from keypointfusion_torch.training.train_step import (
    batch_to_device, create_train_state, make_eval_step, make_train_step,
)
from keypointfusion_torch.utils import profiling
from portbench import harness, trace
from portbench.tests.helpers import BENCH, run_small

ENGINE_SPANS = ('kpf.engine.submit', 'kpf.engine.stage',
                'kpf.engine.preprocess', 'kpf.model', 'kpf.model.backbones')
TRAIN_SPANS = ('kpf.train.step', 'kpf.train.forward', 'kpf.train.loss',
               'kpf.model', 'kpf.model.backbones')
# the per-layer metrics that read the port's spans and its registry
SPAN_METRICS = [m for m in BENCH['per_layer'] if m['name'].split('.')[0] in (
    'engine_submit_ms', 'engine_stage_ms', 'engine_preprocess_ms',
    'model_backbones_ms', 'model_head_ms', 'model_host_ms',
    'train_forward_ms', 'train_loss_ms', 'host_waits')]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def off():
    """A span seen with the profiler off: the next traced window starts
    an empty registry."""
    with profiling.span('kpf.off'):
        pass


@pytest.fixture(scope='module')
def engine():
    cfg = Config(point_num=128)
    return StreamingEngine(cfg, batch_size=2, img_hw=(120, 160),
                           dtype=torch.float32, device='cpu')


@pytest.fixture(scope='module')
def frames():
    return synthetic_frames(2, 120, 160)


def submit(engine, frames, seed=None):
    if seed is not None:
        engine._generator.manual_seed(seed)
    return engine.submit(frames['depth'], frames['rgb'], frames['centers'],
                         frames['cube'], frames['cam'])


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two threads: these small CPU runs take several times longer on a
    shared machine with more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def train_runs():
    """One train step from the same state and draws with the profiler off
    and on: {'plain': loss, 'traced': loss, 'totals': the registry}."""
    cfg = Config(point_num=128)
    batch = batch_to_device(synthetic_batch(batch_size=2, point_num=128,
                                            seed=3), 'cpu')
    out = {}
    for name in ('plain', 'traced'):
        state = create_train_state(cfg, batch, device='cpu', seed=0)
        gen = torch.Generator().manual_seed(5)
        off()
        with cpu_profile() if name == 'traced' else contextlib.nullcontext():
            _, metrics = make_train_step(cfg)(state, batch, gen, 0)
        out[name] = metrics['loss']
    out['totals'] = profiling.totals()
    return out


def test_span_off_is_the_shared_noop(monkeypatch):
    off()
    with cpu_profile():
        with profiling.span('kpf.before'):
            pass
    before = profiling.totals()
    assert set(before) == {'kpf.before'}
    assert before['kpf.before']['calls'] == 1
    entered = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, 'record_function',
                        lambda name: entered.append(name) or real(name))
    first = profiling.span('kpf.a')
    assert first is profiling.span('kpf.b')
    with first:
        torch.ones(4) + 1
    assert entered == []
    assert profiling.totals() == before
    with cpu_profile():
        with profiling.span('kpf.on'):
            pass
    assert entered == ['kpf.on']
    assert set(profiling.totals()) == {'kpf.on'}


def test_engine_opens_each_span_once_a_request(engine, frames):
    submit(engine, frames)
    off()
    with cpu_profile():
        for _ in range(2):
            submit(engine, frames)
    totals = profiling.totals()
    assert set(totals) == set(ENGINE_SPANS)
    for name in ENGINE_SPANS:
        assert totals[name]['calls'] == 2, name
        assert totals[name]['host_s'] > 0 and totals[name]['waits'] == 0
    # one traced window on from another, with no span seen off between:
    # the registry goes on counting
    with cpu_profile():
        submit(engine, frames)
    assert profiling.totals()['kpf.engine.submit']['calls'] == 3


def test_train_step_opens_each_span_once(train_runs):
    totals = train_runs['totals']
    assert set(totals) == set(TRAIN_SPANS)
    assert all(totals[n]['calls'] == 1 for n in TRAIN_SPANS), totals


def test_profiler_changes_no_output(engine, frames, train_runs):
    plain = submit(engine, frames, seed=11)
    with cpu_profile():
        traced = submit(engine, frames, seed=11)
    assert torch.equal(plain, traced)
    assert torch.equal(train_runs['plain'], train_runs['traced'])


def test_readers_are_silent_without_the_registry(monkeypatch):
    monkeypatch.delattr(profiling, 'totals')
    view = trace.View([], 1.0, 2, 2)
    for m in SPAN_METRICS:
        assert harness.reader(m['name'])(view) is None, m['name']


@pytest.fixture(scope='module')
def traced_metrics():
    """The per-layer metrics of one small traced run of each cell, in a
    process of their own: a run refuses to report where JAX is loaded,
    and this suite's conftest loads it."""
    cells = sorted({m['workloads'][0] for m in SPAN_METRICS})
    code = ('import json, sys, torch\n'
            'torch.set_num_threads(2)\n'
            f'sys.path.insert(0, {harness.ROOT!r})\n'
            'from portbench.tests.helpers import run_small\n'
            f'print(json.dumps({{c: run_small(c, trace=True)[0]["metrics"] '
            f'for c in {cells!r}}}))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize('metric', SPAN_METRICS, ids=lambda m: m['name'])
def test_new_metric_reads_on_the_cpu(metric, traced_metrics):
    """Host times positive, host waits 0 (no card), device times absent
    (the CPU run has no device operations)."""
    (cell,) = metric['workloads']
    got = traced_metrics[cell].get(metric['name'])
    if metric['source'] == 'device_trace':
        assert got is None
    elif metric['source'] == 'program_counter':
        assert got == {'value': 0.0, 'unit': 'count'}
    else:
        assert got['unit'] == 'ms' and got['value'] > 0


def test_span_metrics_are_in_the_benchmark():
    assert len({m['name'] for m in SPAN_METRICS}) == 13
    for m in SPAN_METRICS:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter'), m['name']
        assert callable(harness.reader(m['name']))


# ------------------------------------------------------------- the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (host waits are CUDA calls) and '
                    'nvcc (the kernels are CUDA)')
    return torch.device('cuda')


def card_profile():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_host_waits_are_counted_exactly(cuda_device):
    x = torch.ones(1024, device=cuda_device)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    off()
    with card_profile():
        with profiling.span('kpf.test.item'):
            x.sum().item()
        with profiling.span('kpf.test.tensor'):
            torch.tensor([1.0, 2.0], device=cuda_device)
        with profiling.span('kpf.test.launch'):
            x * 2
        with profiling.span('kpf.test.outer'):
            with profiling.span('kpf.test.inner'):
                float(x[0])
            bool(x[1] > 0)
    totals = profiling.totals()
    assert {n: e['waits'] for n, e in totals.items()} == {
        'kpf.test.item': 1, 'kpf.test.tensor': 1, 'kpf.test.launch': 0,
        'kpf.test.outer': 1, 'kpf.test.inner': 1}
    # the file and line of the call (this file lies outside the port)
    with open(__file__) as f:
        line = [i + 1 for i, text in enumerate(f)
                if text.strip() == 'x.sum().item()']
    assert totals['kpf.test.item']['sites'] == {f'{__file__}:{line[0]}': 1}
    # the sync debug mode is back as it was once the spans closed
    assert torch.cuda.get_sync_debug_mode() == mode


@pytest.mark.cuda
def test_kernel_launch_ranges_end_with_its_span(cuda_device):
    from keypointfusion_torch.kernels import pixel_sampler as k2
    rng = np.random.RandomState(0)
    pcl, img_xyz, feat = (
        torch.from_numpy(rng.uniform(-0.9, 0.9, shape).astype(np.float32)
                         ).to(cuda_device)
        for shape in ((2, 256, 3), (2, 1024, 3), (2, 1024, 277)))

    def launch():
        k2.sample_pixel_features_fused(pcl, img_xyz, feat, mode='highest')
        return 1

    launch()
    view = trace.record(launch, 1)
    (kernel,) = view.kernels('pixel_sampler_kernel')
    assert kernel.ranges[-1] == 'kpf.kernel.pixel_sampler', kernel.ranges
    assert kernel.launcher == 'kpf.kernel.pixel_sampler'


@contextlib.contextmanager
def sync_errors():
    """Every synchronizing CUDA call raises inside the block."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_eval_forward_makes_no_host_wait(cuda_device):
    """The float32 eval forward at batch 2, K1 and K2 'highest' included,
    after one warm-up call: the grid and the codecs' kernel row are the
    device's constants by then, so nothing in it waits on the card."""
    cfg = Config(compute_dtype='float32')
    batch = batch_to_device(synthetic_batch(batch_size=2, seed=3),
                            cuda_device)
    state = create_train_state(cfg, batch, device=cuda_device, seed=0)
    step = make_eval_step(cfg)
    step(state, batch)
    with sync_errors():
        results, _ = step(state, batch)
    assert bool(torch.isfinite(results[-1]).all())


@pytest.mark.cuda
def test_serving_pipeline_makes_no_host_wait(cuda_device):
    """StreamingEngine.pipeline (float32, batch 2) on device-resident
    frames after one warm-up call: preprocessing, the forward and the
    packing wait on nothing."""
    engine = StreamingEngine(Config(), batch_size=2, img_hw=(120, 160),
                             dtype=torch.float32, device=cuda_device)
    f = synthetic_frames(2, 120, 160)
    args = [torch.from_numpy(f['depth'].astype(np.int32)).to(cuda_device),
            torch.from_numpy(f['rgb']).to(cuda_device)] + [
        torch.from_numpy(f[k].astype(np.float32)).to(cuda_device)
        for k in ('centers', 'cube', 'cam')]
    engine.pipeline(*args)
    with sync_errors():
        packed = engine.pipeline(*args)
    assert bool(torch.isfinite(packed).all())


@pytest.mark.cuda
def test_train_step_forward_and_loss_count_no_host_wait(cuda_device,
                                                        record_property):
    """One float32 train step at batch 2 under the profiler, after one
    warm-up step: spans `kpf.model` and `kpf.train.loss` count 0 host
    waits. Waits elsewhere in the step are recorded, not held."""
    cfg = Config(compute_dtype='float32')
    batch = batch_to_device(synthetic_batch(batch_size=2, seed=3),
                            cuda_device)
    state = create_train_state(cfg, batch, device=cuda_device, seed=0)
    step = make_train_step(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    state, _ = step(state, batch, gen, 0)
    torch.cuda.synchronize()
    off()
    with card_profile():
        state, metrics = step(state, batch, gen, 1)
    totals = profiling.totals()
    record_property('waits', {n: e['sites'] for n, e in totals.items()})
    assert set(TRAIN_SPANS) <= set(totals)
    assert totals['kpf.model']['waits'] == 0, totals['kpf.model']
    assert totals['kpf.train.loss']['waits'] == 0, totals['kpf.train.loss']
    assert bool(torch.isfinite(metrics['loss']))
