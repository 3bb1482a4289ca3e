"""Training traffic: the port's train step (training/train_step.py:
make_train_step) on device-resident synthetic batches, back to back.

Parameters (the traffic file): `batch` samples a step, `ring` distinct
batches made at set-up and fed in turn, `checked_steps` run at set-up
and compared, `trace_steps` traced with --trace 1, `dropout`. The
configuration gives the optimizer (AdamW: lr, betas, eps, weight decay).

Set-up builds one train state (model and AdamW) with the run's weights
and drives it through `checked_steps` steps of the window's own call and
feed, on batches whose rows all differ; that same state then runs the
window. train_samples_per_s is every sample of the window's steps over
the window's length, which closes on a synchronize.

The check: the plain reference (portbench/reference/train.py) follows
the checked steps from the same weights, batches and dropout generator.
Compared: each step's loss (relative gap), the first gradient's leaf
norms (the program's worked out from AdamW's first moment after step 1:
exp_avg / (1 - beta1)), the leaves' change after the checked steps and
the BatchNorm running statistics' change, each by the worst leaf
(shared.leaf_gap). The change leaves out leaves whose reference gradient
is under a thousandth of the median leaf's: biases ahead of a
BatchNorm, which move by round-off alone.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import inputs, trace, weights
from portbench.shared import (
    Tf32, leaf_gap, median_gap, reference, reference_model, release, sync,
    work_info,
)


class Run:
    def __init__(self, cell, seed: int, device: str, small: dict):
        t, c = cell.traffic, cell.config
        self.seed, self.device = seed, torch.device(device)
        self.batch = small.get('batch', t['batch'])
        self.ring = t['ring']
        self.checked = t['checked_steps']
        self.trace_steps = small.get('trace_steps', t['trace_steps'])
        self.dropout = t['dropout']
        self.config = c
        self.ref = reference(c, cell.root)
        self.net = c['net']
        self.points = small.get('point_num', c['point_num'])
        self.joints = c['joint_num']
        self.opt = c['optimizer']
        self.attempted = 0
        self.losses = []

    def set_up(self):
        from keypointfusion_torch.config import Config
        from keypointfusion_torch.training.train_step import (
            create_train_state, make_train_step,
        )
        self.batches = inputs.crops(self.seed, self.ring, self.batch,
                                    self.points, self.device, self.joints)
        self.weights = weights.state_dict(self.ref.KPFusion, self.config,
                                          self.seed, self.device)
        cfg = Config(net=self.net, point_num=self.points, opt='adamw',
                     lr=self.opt['lr'], compute_dtype='float32')
        self.state = create_train_state(cfg, self.batches[0], self.device,
                                        dropout=self.dropout)
        self.state.model.load_state_dict(self.weights)
        self.step = make_train_step(cfg)
        self.gen = inputs.generator(self.seed, self.device, 3)
        model, opt = self.state.model, self.state.optimizer
        named = dict(model.named_parameters())
        beta1 = self.opt['betas'][0]
        self.program = {'losses': []}
        for i in range(self.checked):
            _, m = self.step(self.state, self.batches[i % self.ring],
                             self.gen, 0)
            self.program['losses'].append(m['loss'])
            if i == 0:
                self.program['grads'] = {
                    n: opt.state[p]['exp_avg'] / (1.0 - beta1)
                    for n, p in named.items() if p in opt.state}
                self.program['stats1'] = running(model)
        self.program['params'] = {n: p.detach().clone()
                                  for n, p in named.items()}
        self.program['stats'] = running(model)
        self.done = self.checked
        sync(self.device)

    def steps(self, count=None, deadline=None) -> int:
        k = 0
        while (count is None or k < count) and \
                (deadline is None or time.perf_counter() < deadline):
            _, m = self.step(self.state,
                             self.batches[(self.done + k) % self.ring],
                             self.gen, 0)
            self.losses.append(m['loss'])
            k += 1
        self.done += k
        self.attempted = k
        return k

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        steps = self.steps(deadline=t0 + seconds)
        sync(self.device)
        return {'train_samples_per_s':
                steps * self.batch / (time.perf_counter() - t0)}

    def traced(self) -> trace.View:
        view = trace.record(lambda: self.steps(count=self.trace_steps),
                            self.batch)
        info = work_info(self.ref.KPFusion, self.config, self.points,
                         self.batch, [])
        # forward, and a backward of twice its products
        view.info['flops_per_unit'] = 3 * info['flops_per_unit']
        return view

    def free(self):
        self.state = self.step = None
        release(self.device)

    # ---------------------------------------------------------- the check

    def reference(self, tf32: bool = False, half: bool = False) -> dict:
        """The reference's readings over the checked steps; `half` trains
        on the first half of each batch's rows (a fault the comparison
        must catch)."""
        from portbench.reference import train as RT
        model = reference_model(self.ref.KPFusion, self.config,
                                self.weights, self.device, self.dropout)
        batches = [self.batches[i % self.ring] for i in range(self.checked)]
        if half:
            batches = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                       for b in batches]
        gen = inputs.generator(self.seed, self.device, 3)
        out = {}
        hook = lambda i, m: out.setdefault('stats1', running(m))
        with Tf32(tf32):
            out['losses'], out['grads'] = RT.train(
                model, batches, gen, lr=self.opt['lr'], hook=hook)
        out['params'] = {n: p.detach() for n, p in model.named_parameters()}
        out['stats'] = running(model)
        return out

    def compare(self, got: dict, want: dict) -> dict:
        losses = [abs(float(g) - w) / abs(w)
                  for g, w in zip(got['losses'], want['losses'])]
        median = statistics.median(float(g.norm())
                                   for g in want['grads'].values())
        moved = {n for n, g in want['grads'].items()
                 if float(g.norm()) >= 1e-3 * median}
        change = lambda s: {n: s['params'][n] - self.weights[n]
                            for n in moved}
        stats = lambda s, k='stats': {n: s[k][n] - self.weights[n]
                                      for n in s[k]}
        out = {f'loss{i + 1}_gap': x for i, x in enumerate(losses)}
        out.update({
            'grad_gap': leaf_gap(got['grads'], want['grads']),
            'change_gap': leaf_gap(change(got), change(want)),
            'change_median_gap': median_gap(change(got), change(want)),
            'stats_gap': leaf_gap(stats(got), stats(want)),
            'stats1_gap': leaf_gap(stats(got, 'stats1'),
                                   stats(want, 'stats1'))})
        return out

    def check(self):
        losses = torch.stack(self.losses) if self.losses else None
        failed = 0 if losses is None else int((~torch.isfinite(
            losses)).sum())
        return self.compare(self.program, self.reference()), failed



def running(model) -> dict:
    """Copies of the BatchNorm running statistics of `model`."""
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if 'running' in n}
