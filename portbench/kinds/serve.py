"""Serving traffic: full RGB-D frames streamed through the port's
StreamingEngine.process_stream, closed loop.

Parameters (the traffic file): `batch` frames a request, `img_hw` the
frames' size, `ring` distinct request batches made at set-up and sent in
turn, `in_flight` requests the engine keeps in flight, `warmup_requests`
sent before the window, `trace_requests` traced with --trace 1,
`check_requests` compared with the reference after the window.

The window sends requests until `seconds` have passed and closes when the
last one sent has returned: frames_per_s is every frame answered over the
window's whole length; request_p95_ms the 95th percentile, over every
request of the window, of the host time from the start of `submit`
(staging) to the request's joints on the host.

The check: `check_requests` requests drawn from the seed among those of
the window (or of the traced requests), each run again through the plain
reference (preprocessing, model, packing) on the same frames and the
same point draws, which the engine takes from its generator, seeded with
the configuration's seed, one [batch, points] draw a request in the
order the requests were submitted. Compared: the widest gap of the world
joints (mm) and of the uvd joints and crop matrices.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import inputs, trace, weights
from portbench.shared import (
    Tf32, reference, reference_model, release, sync, work_info,
)


def config_seed(seed: int) -> int:
    """The engine's point-draw seed for a run's seed."""
    return (seed * 7919 + 13) % 2 ** 62


class Run:
    def __init__(self, cell, seed: int, device: str, small: dict):
        t, c = cell.traffic, cell.config
        self.seed, self.device = seed, torch.device(device)
        self.batch = small.get('batch', t['batch'])
        self.hw = tuple(small.get('img_hw', t['img_hw']))
        self.ring = t['ring']
        self.in_flight = t['in_flight']
        self.warmup = small.get('warmup_requests', t['warmup_requests'])
        self.trace_requests = small.get('trace_requests', t['trace_requests'])
        self.check_requests = small.get('check_requests', t['check_requests'])
        self.config = c
        self.ref = reference(c, cell.root)
        self.net = c['net']
        self.points = small.get('point_num', c['point_num'])
        self.joints = c['joint_num']
        self.attempted = 0
        self.submits = []
        self.answers = {}

    def set_up(self):
        from keypointfusion_torch.config import Config
        from keypointfusion_torch.serving import StreamingEngine
        self.frames = inputs.frames(self.seed, self.ring, self.batch,
                                    *self.hw, self.device)
        self.weights = weights.state_dict(self.ref.KPFusion, self.config,
                                          self.seed, self.device)
        self.cfg = Config(net=self.net, point_num=self.points,
                          seed=config_seed(self.seed))
        self.engine = StreamingEngine(
            self.cfg, state_dict=self.weights, batch_size=self.batch,
            img_hw=self.hw, dtype=torch.float32, device=self.device)
        submit = self.engine.submit

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = submit(*args, **kwargs)
            self.submits.append((t0, time.perf_counter()))
            return out

        self.engine.submit = timed
        self.stream(count=self.warmup)
        sync(self.device)

    def stream(self, count=None, deadline=None):
        """Requests through process_stream; returns (index of the first,
        [(completion time, answer)])."""
        first = len(self.submits)

        def feed():
            k = 0
            while (count is None or k < count) and \
                    (deadline is None or time.perf_counter() < deadline):
                yield self.frames[(first + k) % self.ring]
                k += 1

        done = [(time.perf_counter(), out) for out in
                self.engine.process_stream(feed(), depth=self.in_flight)]
        self.answers = {first + i: out for i, (_, out) in enumerate(done)}
        self.attempted = len(done)
        return first, done

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        first, done = self.stream(deadline=t0 + seconds)
        latency = [t - self.submits[first + i][0]
                   for i, (t, _) in enumerate(done)]
        return {'frames_per_s': len(done) * self.batch / (done[-1][0] - t0),
                'request_p95_ms': float(np.percentile(latency, 95)) * 1e3}

    def traced(self) -> trace.View:
        from torch.autograd.profiler import record_function
        from keypointfusion_torch import serving
        model = self.engine.model
        desa = [model.block1.FA, model.block2.FA]
        calls = []
        hooks = [m.register_forward_pre_hook(
            lambda _m, a: calls.append((a[2], a[3]))) for m in desa]
        preprocess = serving.device_preprocess

        def wrapped(*args, **kwargs):
            with record_function('pb.preprocess'):
                return preprocess(*args, **kwargs)

        serving.device_preprocess = wrapped
        state = {}

        def run():
            state['first'], done = self.stream(count=self.trace_requests)
            return len(done)

        try:
            with trace.ranges_on(model, {
                    'pb.model': [model],
                    'pb.backbone': [model.backbone_d, model.backbone_rgb]}):
                view = trace.record(run, self.batch)
        finally:
            serving.device_preprocess = preprocess
            for h in hooks:
                h.remove()
        view.spans['submit'] = [e - s for s, e in
                                self.submits[state['first']:]]
        view.info.update(work_info(self.ref.KPFusion, self.config,
                                   self.points, self.batch, calls))
        return view

    def free(self):
        self.engine = None
        release(self.device)

    # ---------------------------------------------------------- the check

    def sample(self):
        """The requests compared: drawn from the seed among those
        answered."""
        rng = random.Random(self.seed * 31 + 7)
        done = sorted(self.answers)
        return sorted(rng.sample(done, min(self.check_requests, len(done))))

    def reference_answers(self, indices, tf32: bool = False):
        """Packed answers [B, 2*3J+9] of the plain reference for the
        requests `indices`, from the same frames, weights and draws."""
        from portbench.reference.preprocess import preprocess
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed)
        draws = {}
        for k in range(max(indices) + 1):
            u = torch.rand((self.batch, self.points), generator=gen,
                           device=self.device)
            if k in indices:
                draws[k] = u
        model = reference_model(self.ref.KPFusion, self.config,
                                self.weights, self.device).eval()
        out = {}
        with Tf32(tf32), torch.no_grad():
            for k in indices:
                f = self.frames[k % self.ring]
                t = lambda a: torch.from_numpy(a).to(self.device)
                rgb, depth, pcl, fr = preprocess(
                    t(f['depth'].astype(np.int32)), t(f['rgb']),
                    t(f['centers']), t(f['cube']), t(f['cam']), draws[k])
                results, _ = model(rgb, depth, pcl, fr, 0.8)
                out[k] = self.ref.pack(results, fr)
        return out

    def packed(self, k) -> torch.Tensor:
        a = self.answers[k]
        b = a['joint_xyz_mm'].shape[0]
        return torch.from_numpy(np.concatenate(
            [a['joint_xyz_mm'].reshape(b, -1), a['joint_uvd'].reshape(b, -1),
             a['M'].reshape(b, -1)], -1)).to(self.device)

    def compare(self, got: dict, want: dict) -> dict:
        """Per frame, the widest gap of its world joints (mm), and of its
        uvd joints and crop matrix; over the frames compared, the widest
        of each and their quantiles."""
        j3 = 3 * self.joints
        mm = torch.cat([(got[k][:, :j3] - want[k][:, :j3]).abs().amax(-1)
                        for k in want]).double()
        rest = torch.cat([(got[k][:, j3:] - want[k][:, j3:]).abs().amax(-1)
                          for k in want]).double()
        out = {}
        for name, gap in (('joints_mm', mm), ('uvd_M', rest)):
            out[name + '_gap'] = float(gap.max())
            for p in (99, 90, 50):
                out[f'{name}_p{p}'] = float(torch.quantile(gap, p / 100))
        return out

    def check(self):
        failed = sum(1 for a in self.answers.values()
                     if not all(np.isfinite(v).all() for v in a.values()))
        idx = self.sample()
        want = self.reference_answers(idx)
        return self.compare({k: self.packed(k) for k in idx}, want), failed

