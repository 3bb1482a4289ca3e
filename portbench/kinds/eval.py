"""Evaluation traffic: the port's eval step (training/train_step.py:
make_eval_step, the forward through K1 and K2 'highest' without
gradients) on device-resident synthetic crop batches, back to back.

Parameters (the traffic file): `batch` crops a step, `ring` distinct
batches made at set-up and fed in turn, `warmup_steps` before the
window, `trace_steps` traced with --trace 1.

eval_frames_per_s is every crop of the window's steps over the window's
length, which closes on a synchronize.

The check: every ring batch's last answer of the window (or of the
traced steps) in full, and the final joints of every step, against the
plain reference's forward on the same batch. Compared: the widest gap of
the joints of both blocks in mm (normalized xyz times cube / 2), and of
the dense maps and spatial weights.
"""

from __future__ import annotations

import time
import types

import torch

from portbench import inputs, trace, weights
from portbench.shared import (
    Tf32, reference, reference_model, release, sync, work_info,
)


class Run:
    def __init__(self, cell, seed: int, device: str, small: dict):
        t, c = cell.traffic, cell.config
        self.seed, self.device = seed, torch.device(device)
        self.batch = small.get('batch', t['batch'])
        self.ring = t['ring']
        self.warmup = t['warmup_steps']
        self.trace_steps = small.get('trace_steps', t['trace_steps'])
        self.config = c
        self.ref = reference(c, cell.root)
        self.net = c['net']
        self.points = small.get('point_num', c['point_num'])
        self.joints = c['joint_num']
        self.attempted = 0
        self.joints_by_step = []
        self.last = {}

    def set_up(self):
        from keypointfusion_torch.config import Config
        from keypointfusion_torch.models.kpfusion import build_kpfusion
        from keypointfusion_torch.training.train_step import make_eval_step
        self.batches = inputs.crops(self.seed, self.ring, self.batch,
                                    self.points, self.device, self.joints)
        self.weights = weights.state_dict(self.ref.KPFusion, self.config,
                                          self.seed, self.device)
        cfg = Config(net=self.net, point_num=self.points,
                     compute_dtype='float32')
        model = build_kpfusion(cfg, self.device, dtype=torch.float32)
        model.load_state_dict(self.weights)
        self.state = types.SimpleNamespace(model=model)
        self.step = make_eval_step(cfg)
        self.done = 0
        self.steps(count=self.warmup)
        sync(self.device)

    def steps(self, count=None, deadline=None) -> int:
        self.joints_by_step, self.last = [], {}
        k = 0
        while (count is None or k < count) and \
                (deadline is None or time.perf_counter() < deadline):
            slot = (self.done + k) % self.ring
            results, sw = self.step(self.state, self.batches[slot])
            self.joints_by_step.append((slot, results[-1]))
            self.last[slot] = (results, sw)
            k += 1
        self.done += k
        self.attempted = k
        return k

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        steps = self.steps(deadline=t0 + seconds)
        sync(self.device)
        return {'eval_frames_per_s':
                steps * self.batch / (time.perf_counter() - t0)}

    def traced(self) -> trace.View:
        model = self.state.model
        calls = []
        hooks = [m.register_forward_pre_hook(
            lambda _m, a: calls.append((a[2], a[3])))
            for m in (model.block1.FA, model.block2.FA)]
        try:
            with trace.ranges_on(model, {
                    'pb.model': [model],
                    'pb.backbone': [model.backbone_d, model.backbone_rgb]}):
                view = trace.record(
                    lambda: self.steps(count=self.trace_steps), self.batch)
        finally:
            for h in hooks:
                h.remove()
        view.info.update(work_info(self.ref.KPFusion, self.config,
                                   self.points, self.batch, calls))
        return view

    def free(self):
        self.state = self.step = None
        release(self.device)

    # ---------------------------------------------------------- the check

    def reference(self, tf32: bool = False) -> dict:
        """The reference's (results, spatial weights) of each ring batch
        answered in the window."""
        from portbench.reference import geometry as G
        model = reference_model(self.ref.KPFusion, self.config,
                                self.weights, self.device).eval()
        out = {}
        with Tf32(tf32), torch.no_grad():
            for slot in sorted(self.last):
                b = self.batches[slot]
                fr = G.Frame.make(b['cam_para'], b['center'], b['M'],
                                  b['cube'], b['depth'].shape[1])
                out[slot] = model(b['rgb'], b['depth'], b['pcl'], fr, 0.8)
        return out

    def compare(self, got: dict, steps, want: dict) -> dict:
        """got: slot -> (results, sw) in full; steps: [(slot, final
        joints)] of every step. The widest gap of block 1's joints (mm:
        normalized xyz times cube / 2), of the dense maps, of the spatial
        weights, and per frame of block 2's joints, with the quantiles of
        the last over every frame of every step."""
        b1 = dense = sw_gap = 0.0
        final = []
        for slot, (results, sw) in want.items():
            mm = self.batches[slot]['cube'][:, None, :] / 2.0
            g_res, g_sw = got[slot]
            for g, w in zip(g_res[2:4], results[2:4]):
                b1 = max(b1, float(((g - w) * mm).abs().max()))
            for g, w in zip(g_res[:2], results[:2]):
                dense = max(dense, float((g - w).abs().max()))
            for g, w in zip(g_sw, sw):
                sw_gap = max(sw_gap, float((g - w).abs().max()))
            final.append(((g_res[4] - results[4]) * mm).abs().amax((1, 2)))
        for slot, joints in steps:
            mm = self.batches[slot]['cube'][:, None, :] / 2.0
            final.append(((joints - want[slot][0][-1]) * mm).abs().amax(
                (1, 2)))
        final = torch.cat(final).double()
        q = lambda p: float(torch.quantile(final, p))
        return {'b1_mm_gap': b1, 'dense_gap': dense, 'sw_gap': sw_gap,
                'joints_mm_gap': float(final.max()), 'joints_mm_p99': q(0.99),
                'joints_mm_p90': q(0.9), 'joints_mm_p50': q(0.5)}

    def check(self):
        failed = sum(1 for _, j in self.joints_by_step
                     if not bool(torch.isfinite(j).all()))
        return self.compare(self.last, self.joints_by_step,
                            self.reference()), failed
